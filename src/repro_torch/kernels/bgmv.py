"""Batched low-rank corrections for factored pool serving (port of
``repro/kernels/bgmv.py``).

Member t of a low-rank pool is ``base + U_t·V_tᵀ`` at every matrix site,
so ``x·W_t = x·W_base + (x·U_t)·V_tᵀ``: the ensemble reads the base
weights once per batch and each member pays a rank-r correction. `bgmv`
is that correction for the whole member axis,

    x (S, N, d_in) per member, or (N, d_in) shared  ×  u (S, d_in, r),
    v (S, d_out, r)  →  y (S, N, d_out) f32,   y_s = (x_s·u_s)·v_sᵀ.

On CUDA tensors it launches the hand-written kernel ``csrc/bgmv_f32.cu``
(x in f32 or bf16, u and v f32, all contiguous; anything else raises); on
CPU tensors it takes the plain version `ref.bgmv_ref`. Nothing falls
back."""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bgmv_ref

MAX_RANK = 64            # the kernel's limit (csrc/bgmv_f32.cu MAX_R)
_MAX_GRID_YZ = 65535     # CUDA's limit on gridDim.y and gridDim.z
_ROWS_PER_BLOCK = 32     # csrc/bgmv_f32.cu NB


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("bgmv_f32")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.bgmv_f32.argtypes = [p, ctypes.c_int, p, p, p, p, i64, i64, i64,
                             i64, i64, ctypes.c_int, p]
    lib.bgmv_f32.restype = ctypes.c_int
    lib.bgmv_f32_workspace.argtypes = [i64, i64, i64, i64]
    lib.bgmv_f32_workspace.restype = i64
    return lib


def _shapes(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """(S, N, d_in, d_out, r, shared) of a valid call, else raise."""
    if u.dim() != 3 or v.dim() != 3:
        raise ValueError(f"bgmv: u and v must be (S, d, r), got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    s, d_in, r = u.shape
    d_out = v.shape[1]
    if v.shape != (s, d_out, r):
        raise ValueError(f"bgmv: v is {tuple(v.shape)}, u {tuple(u.shape)}")
    shared = x.dim() == 2
    n = x.shape[-2] if x.dim() >= 2 else 0
    want = (n, d_in) if shared else (s, n, d_in)
    if tuple(x.shape) != want:
        raise ValueError(f"bgmv: x is {tuple(x.shape)}; expected (N, "
                         f"{d_in}) or ({s}, N, {d_in})")
    return s, n, d_in, d_out, r, shared


def bgmv_f32(x: torch.Tensor, u: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (see the module docstring for the shapes).
    x is f32 or bf16, u and v f32; all contiguous, on one CUDA device.
    One launch is one call of ``csrc/bgmv_f32.cu``, which enqueues its
    shrink and expand kernels; `bgmv_f32.launches` counts the launches."""
    s, n, d_in, d_out, r, shared = _shapes(x, u, v)
    for name, t in (("x", x), ("u", u), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"bgmv_f32: {name} is on {t.device}, not CUDA")
        if t.device != x.device:
            raise ValueError(f"bgmv_f32: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"bgmv_f32: {name} must be contiguous")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bgmv_f32: x is {x.dtype}, not float32 or bfloat16")
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError(f"bgmv_f32: u and v must be float32, got {u.dtype} "
                        f"and {v.dtype}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"bgmv_f32: rank {r} outside 1..{MAX_RANK}")
    if min(s, n, d_in, d_out) == 0:
        raise ValueError(f"bgmv_f32: empty operands {tuple(x.shape)}, "
                         f"{tuple(u.shape)}, {tuple(v.shape)}")
    if s > _MAX_GRID_YZ or -(-n // _ROWS_PER_BLOCK) > _MAX_GRID_YZ:
        raise ValueError(f"bgmv_f32: S={s}, N={n} exceed the kernel's grid")
    lib = _lib()
    y = torch.empty((s, n, d_out), device=x.device, dtype=torch.float32)
    part = torch.empty(lib.bgmv_f32_workspace(s, n, d_in, r),
                       device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bgmv_f32(x.data_ptr(), int(x.dtype == torch.bfloat16),
                           u.data_ptr(), v.data_ptr(), y.data_ptr(),
                           part.data_ptr(), s, n, d_in, d_out, r,
                           int(shared), stream)
    if err != 0:
        raise RuntimeError(f"bgmv_f32: launch failed with CUDA error {err}")
    bgmv_f32.launches += 1
    return y


bgmv_f32.launches = 0


def bgmv(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """y_s = (x_s·u_s)·v_sᵀ in f32, routed by the operands' device: the
    kernel on CUDA, the plain version on the CPU."""
    devices = {t.device.type for t in (x, u, v)}
    if devices == {"cuda"}:
        return bgmv_f32(x, u, v)
    if devices == {"cpu"}:
        _shapes(x, u, v)
        return bgmv_ref(x, u, v)
    raise ValueError(f"bgmv: no route for operands on {sorted(devices)}")
