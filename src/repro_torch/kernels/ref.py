"""Plain PyTorch versions of the kernels' functions (port of the matching
oracles in ``repro/kernels/ref.py``). They are the CPU path and the
ground truth the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 GEMM ground truth for the GEMM kernel (`gemm_ref`)."""
    return a.float() @ b.float()


gemm_ref = matmul_ref


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 NHWC conv with HWIO weights via `F.conv2d` — the
    independent oracle for `local_step.conv2d_gemm`. On a CUDA tensor it
    runs with cuDNN's TF32 off, so it stays an f32 reference."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), padding="same")
    return y.permute(0, 2, 3, 1) + b


def maxpool2x2_ref(x: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2×2 max pool (NHWC) via `F.max_pool2d` — forward
    oracle for `local_step.maxpool2x2` (its gradient picks one element on
    ties, so it is a forward-only reference)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def sgd_update_ref(p: torch.Tensor, g: torch.Tensor, *, lr: float,
                   wd: float = 0.0) -> torch.Tensor:
    """p − lr·(g + wd·p) in f32 — the SGD kernel's plain version. Written
    as two `torch.add(…, alpha=)` so each step rounds once, as an FMA:
    that is how XLA's CPU update and the kernel round (bitwise equal to
    both; separate multiply and add would differ in the last bit)."""
    p32 = p.float()
    return torch.add(p32, torch.add(g.float(), p32, alpha=wd),
                     alpha=-lr).to(p.dtype)
