"""Flash attention, forward only (port of
``repro/kernels/flash_attention.py``): causal or sliding-window GQA
softmax attention with an online softmax over key tiles.

    q (B, Tq, H, hd); k, v (B, Tk, KV, hd)  →  out (B, Tq, H, hd) in q's
    dtype; query head h reads kv head h // (H / KV); scores in f32.

`flash_attn_f32` launches the hand-written kernel ``csrc/flash_attn_f32.cu``
(bf16 or f32, contiguous CUDA tensors, hd 32, 64, 112 or 128; anything
else raises): bf16 on the tensor cores (mma.sync, P·V with P in three
bf16 terms), f32 in FFMA; see its header. Its plain version is
`ref.attention_ref`. The model reaches both
through `models/layers.flash_attention`, which routes by device: the
kernel on CUDA, the reference's chunked formulation on the CPU. The
kernel has no backward: a CUDA input that requires grad raises."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 112, 128)   # the kernel's template instances
_MAX_GRID_YZ = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn_f32")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.flash_attn_f32.argtypes = [p, p, p, p, ctypes.c_int, i64, i64, i64,
                                   i64, i64, i64, ctypes.c_int, i64,
                                   ctypes.c_float, p]
    lib.flash_attn_f32.restype = ctypes.c_int
    return lib


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (B, Tq, H, hd), k and v "
                         f"(B, Tk, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")


def flash_attn_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel. q, k, v: one dtype (f32 or bf16), contiguous,
    on one CUDA device, no grad. `flash_attn_f32.launches` counts the
    launches."""
    build.refuse_vmapped("flash_attn_f32", q, k, v)
    _check_shapes(q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attn_f32: {name} is on {t.device}, not "
                             "CUDA")
        if t.device != q.device:
            raise ValueError(f"flash_attn_f32: {name} is on {t.device}, q "
                             f"on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attn_f32: {name} is {t.dtype}, q "
                            f"{q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attn_f32: {name} must be contiguous")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "flash_attn_f32 is forward-only: no backward kernel yet")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attn_f32: {q.dtype} is not float32 or "
                        "bfloat16")
    b, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attn_f32: head dim {hd} not in {HEAD_DIMS}")
    if min(b, tq, tk) == 0 or max(b, h) > _MAX_GRID_YZ:
        raise ValueError(f"flash_attn_f32: no grid for q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attn_f32: {name} must start on a "
                             "16-byte boundary (the kernel copies 16-byte "
                             "rows)")
    out = torch.empty_like(q)
    scale = float(np.float32(hd ** -0.5))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attn_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), b, tq, tk, h, kv, hd,
            int(causal), int(window), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_f32: launch failed with CUDA error "
                           f"{err}")
    build.count_launches(flash_attn_f32)
    return out


flash_attn_f32.launches = 0
