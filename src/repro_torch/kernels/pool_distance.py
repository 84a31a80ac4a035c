"""Factor Gram for the low-rank pool's distance statistics (port of
``factor_gram`` in ``repro/kernels/pool_distance.py``).

Pairwise member distances of a `LowRankDeltaPool` reduce to Gram
matrices over the stacked factors: with A = [U_1ᵀ; …; U_Cᵀ] (C·r rows),
⟨Δ_i, Δ_j⟩ = ⟨U_iᵀU_j, V_iᵀV_j⟩_F reads off two A·Aᵀ products
(`core/distances.lowrank_pairwise_sq`). `factor_gram` is that product
over the long trailing axis,

    a (M, P) → (M, M), or a (B, M, P) → (B, M, M), f32.

On CUDA tensors it launches the hand-written kernel
``csrc/factor_gram_f32.cu`` (f32, contiguous; its sum over P is the same
on every run: chunk partials, then the chunks added in order); on CPU
tensors it takes the plain version `ref.factor_gram_ref`. Nothing falls
back. (The pool-distance statistics sweep of the same reference module
is not ported yet.)"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import factor_gram_ref

TILE = 64               # csrc/factor_gram_f32.cu: its output tile edge
MAX_M = 256             # rows the reference's kernel takes (C·r ≤ 256)
_MAX_GRID_Z = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("factor_gram_f32")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.factor_gram_f32.argtypes = [p, p, p, p, i64, i64, i64, p]
    lib.factor_gram_f32.restype = ctypes.c_int
    lib.factor_gram_f32_workspace.argtypes = [i64, i64, i64]
    lib.factor_gram_f32_workspace.restype = i64
    return lib


def factor_gram_f32(a: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on a contiguous f32 (B, M, P) CUDA tensor;
    returns (B, M, M). `factor_gram_f32.launches` counts the launches."""
    if a.device.type != "cuda":
        raise ValueError(f"factor_gram_f32: a is on {a.device}, not CUDA")
    if a.dtype != torch.float32:
        raise TypeError(f"factor_gram_f32: a is {a.dtype}, not float32")
    if a.dim() != 3:
        raise ValueError(f"factor_gram_f32: a must be (B, M, P), got "
                         f"{tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError("factor_gram_f32: a must be contiguous")
    b, m, p = a.shape
    if min(b, m, p) == 0 or m > MAX_M or b > _MAX_GRID_Z:
        raise ValueError(f"factor_gram_f32: no grid for {tuple(a.shape)} "
                         f"(M ≤ {MAX_M})")
    lib = _lib()
    n_tiles = -(-m // TILE)
    out = torch.empty((b, m, m), device=a.device, dtype=torch.float32)
    part = torch.empty(lib.factor_gram_f32_workspace(b, m, p),
                       device=a.device, dtype=torch.float32)
    counters = torch.zeros(b * n_tiles * n_tiles, device=a.device,
                           dtype=torch.int32)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.factor_gram_f32(a.data_ptr(), out.data_ptr(),
                                  part.data_ptr(), counters.data_ptr(),
                                  b, m, p, stream)
    if err != 0:
        raise RuntimeError(f"factor_gram_f32: launch failed with CUDA error "
                           f"{err}")
    factor_gram_f32.launches += 1
    return out


factor_gram_f32.launches = 0


def factor_gram(a: torch.Tensor) -> torch.Tensor:
    """A·Aᵀ over the trailing axis, (M, P) → (M, M) or (B, M, P) →
    (B, M, M), routed by the tensor's device: the kernel on CUDA, the
    plain version on the CPU."""
    if a.dim() == 2:
        return factor_gram(a[None])[0]
    if a.device.type == "cuda":
        return factor_gram_f32(a)
    if a.device.type == "cpu":
        return factor_gram_ref(a)
    raise ValueError(f"factor_gram: no route for a tensor on {a.device}")
