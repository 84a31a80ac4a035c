"""Kernels of the port: hand-written CUDA for Hopper beside their plain
PyTorch versions (`ref`); `ops` holds the public wrappers under the
reference's names."""
from repro_torch.kernels import ops, ref
from repro_torch.kernels.chunk_scan import gla_chunk_f32
from repro_torch.kernels.flash_attention import flash_attn_f32
from repro_torch.kernels.pool_distance import (factor_gram,
                                               pool_distance_stats)

__all__ = ["ops", "ref", "flash_attn_f32", "pool_distance_stats",
           "factor_gram", "gla_chunk_f32"]
