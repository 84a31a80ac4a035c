"""PyTorch/CUDA port of the FedELMY engine (see ``src/repro`` for the JAX
reference it mirrors).

The port keeps the reference's module names, layouts (NHWC activations,
HWIO conv weights) and parameter leaf names, so parameters convert between
the two packages by plain copy (`repro_torch.convert`), and checkpoints
are the reference's npz files (`repro_torch.checkpoint`). Entry points run on
the CUDA device unless the caller passes ``device="cpu"``. The kernels on
its paths are hand-written CUDA C++ for Hopper (``kernels/csrc/``): the
f32 GEMM behind every convolution of the paper CNN's training step, the
fused SGD update, and for pool serving the batched low-rank correction
(BGMV), flash attention (forward) and the factor Gram of the low-rank
pool's distances."""
