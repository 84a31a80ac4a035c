"""Kernels of the port: hand-written CUDA for Hopper beside their plain
PyTorch versions (`ref`)."""
