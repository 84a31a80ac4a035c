"""Flash attention (port of ``repro/kernels/flash_attention.py``) and its
backward: causal, sliding-window or non-causal GQA softmax attention
with an online softmax over key tiles; non-causal with Tq ≠ Tk either
way (the encoder's self-attention over T_src frames, the decoder's
cross-attention of T target queries over them).

    q (B, Tq, H, hd); k (B, Tk, KV, hd); v (B, Tk, KV, dv)  →  out (B, Tq,
    H, dv) in q's dtype; query head h reads kv head h // (H / KV); scores
    in f32.

`flash_attn_f32` launches the hand-written forward kernel
``csrc/flash_attn_f32.cu`` (bf16 or f32, contiguous CUDA tensors; (hd,
dv) one of `DIM_PAIRS`: dv = hd at 32, 64, 112 or 128, and MLA's (192,
128) for deepseek-v2-lite-16b and (48, 32) for its `reduced()`; anything
else raises): bf16 on the tensor cores
(mma.sync, P·V with P in three bf16 terms), f32 in FFMA; see its header.
With ``return_lse=True`` it also returns each row's log-sum-exp (B, H,
Tq) in f32, +inf on a row with no valid key. `flash_attn_bwd_f32`
launches the backward ``csrc/flash_attn_bwd_f32.cu`` (Δ, dK/dV, dQ:
three deterministic kernels, no atomics; bf16 on the tensor cores, with
P and dS in three bf16 terms, f32 in FFMA; the same `DIM_PAIRS`). Their
plain versions are `ref.attention_ref`, `ref.attention_lse_ref` and `ref.attention_bwd_ref`.

`FlashAttention` is the autograd Function over the two: its forward
saves q, k, v, out and lse, its backward launches the backward kernel,
with the forward's masks: causal or non-causal, Tq = Tk or not (the
encoder-decoder trains through both: its encoder's self-attention and
every cross-attention are non-causal, the latter with Tq ≠ Tk), and
values as wide as the queries or, for MLA, narrower (deepseek-v2-lite's
(192, 128)). It syncs nothing and allocates
with `torch.empty` on the current stream, so a training step through it
can be captured in a CUDA graph; under `torch.func.vmap` it raises
(batched LM sweeps are not ported). The model reaches them through
`models/layers.flash_attention`, which routes by device: on CUDA the
Function where an input requires grad, else the forward kernel; on the
CPU the reference's chunked formulation. A direct
`flash_attn_f32` call on an input that requires grad raises: the
Function is the route that has a backward."""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 112, 128)   # the kernels' instances with dv = hd
# the template instances (hd, dv) of the forward and the backward kernel:
# dv = hd, and MLA's q/k head dim 192 (nope 128 + rope 64) with values
# of 128, and 48 (nope 32 + rope 16) with values of 32 (deepseek's
# `reduced()` heads, which `launch.train` trains)
DIM_PAIRS = tuple((hd, hd) for hd in HEAD_DIMS) + ((192, 128), (48, 32))
_MAX_GRID_YZ = 65535


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attn_f32")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.flash_attn_f32.argtypes = [p, p, p, p, p, ctypes.c_int, i64, i64,
                                   i64, i64, i64, i64, i64, ctypes.c_int,
                                   i64, ctypes.c_float, p]
    lib.flash_attn_f32.restype = ctypes.c_int
    return lib


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attn_bwd_f32")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.flash_attn_bwd_f32.argtypes = [p, p, p, p, p, p, p, p, p, p,
                                       ctypes.c_int, i64, i64, i64, i64,
                                       i64, i64, i64, ctypes.c_int, i64,
                                       ctypes.c_float, p]
    lib.flash_attn_bwd_f32.restype = ctypes.c_int
    return lib


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3]:
        raise ValueError(f"flash_attention: q (B, Tq, H, hd), k (B, Tk, KV, "
                         f"hd) and v (B, Tk, KV, dv); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, tq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")


def _check_launch(name: str, tensors, dtype, device) -> None:
    """Device, dtype, contiguity and 16-byte alignment of every tensor a
    launch reads or writes through a raw pointer."""
    for label, t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {label} is on {t.device}, not CUDA")
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, q on "
                             f"{device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} is {t.dtype}, q {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must start on a 16-byte "
                             "boundary (the kernels copy 16-byte rows)")


def _check_kernel_shape(name: str, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, pairs) -> None:
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: {q.dtype} is not float32 or bfloat16")
    b, tq, h, hd = q.shape
    tk, dv = k.shape[1], v.shape[3]
    if (hd, dv) not in pairs:
        raise ValueError(f"{name}: head dims (q/k {hd}, v {dv}) not among "
                         f"the kernel's instances {pairs}")
    if min(b, tq, tk) == 0 or max(b, h) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: no grid for q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")


def flash_attn_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   return_lse: bool = False):
    """Launch the forward kernel. q, k, v: one dtype (f32 or bf16),
    contiguous, on one CUDA device, no grad, head dims (hd, dv) one of
    `DIM_PAIRS`. Returns out (B, Tq, H, dv), or (out, lse)
    with ``return_lse``: lse (B, H, Tq) f32, each row's log-sum-exp of its
    scaled, masked scores (+inf for a row with no valid key); out is the
    same bits either way. `flash_attn_f32.launches` counts the
    launches."""
    build.refuse_vmapped("flash_attn_f32", q, k, v)
    _check_shapes(q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attn_f32 is the forward alone: differentiate through "
            "FlashAttention.apply, which has the backward kernel")
    _check_kernel_shape("flash_attn_f32", q, k, v, DIM_PAIRS)
    _check_launch("flash_attn_f32", (("q", q), ("k", k), ("v", v)),
                  q.dtype, q.device)
    b, tq, h, hd = q.shape
    tk, kv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, tq, h, dv), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attn_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None,
            int(q.dtype == torch.bfloat16), b, tq, tk, h, kv, hd, dv,
            int(causal), int(window), _scale(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_f32: launch failed with CUDA error "
                           f"{err}")
    build.count_launches(flash_attn_f32)
    return (out, lse) if return_lse else out


flash_attn_f32.launches = 0


def _scale(hd: int) -> float:
    return float(np.float32(hd ** -0.5))


def flash_attn_bwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, lse: torch.Tensor,
                       dout: torch.Tensor, *, causal: bool = True,
                       window: int = 0):
    """Launch the backward kernel (Δ = rowsum(dO∘O), then dK/dV and dQ):
    (dq, dk, dv) of the forward at q, k, v for the output gradient
    `dout`, given the forward's `out` and `lse` (`flash_attn_f32(...,
    return_lse=True)`). q, k, v, out, dout: one dtype (f32 or bf16),
    contiguous, on one CUDA device, head dims (hd, dv) one of
    `DIM_PAIRS`, out and dout (B, Tq, H, dv); lse f32 (B, H, Tq). The
    gradients come in the inputs' dtype, each rounded once from f32. One
    call counts one launch in `flash_attn_bwd_f32.launches` (its three
    kernels)."""
    build.refuse_vmapped("flash_attn_bwd_f32", q, k, v, out, lse, dout)
    _check_shapes(q, k, v)
    b, tq, h, hd = q.shape
    tk, kv, dv_dim = k.shape[1], k.shape[2], v.shape[3]
    if out.shape != (b, tq, h, dv_dim) or dout.shape != out.shape:
        raise ValueError(f"flash_attn_bwd_f32: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be "
                         f"{(b, tq, h, dv_dim)}, q's with v's head dim")
    if lse.shape != (b, h, tq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attn_bwd_f32: lse must be f32 "
                         f"{(b, h, tq)}; got {lse.dtype} "
                         f"{tuple(lse.shape)}")
    _check_kernel_shape("flash_attn_bwd_f32", q, k, v, DIM_PAIRS)
    _check_launch("flash_attn_bwd_f32",
                  (("q", q), ("k", k), ("v", v), ("out", out),
                   ("dout", dout)), q.dtype, q.device)
    _check_launch("flash_attn_bwd_f32", (("lse", lse),), torch.float32,
                  q.device)
    delta = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_lib().flash_attn_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            int(q.dtype == torch.bfloat16), b, tq, tk, h, kv, hd, dv_dim,
            int(causal), int(window), _scale(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_f32: launch failed with CUDA "
                           f"error {err}")
    build.count_launches(flash_attn_bwd_f32)
    return dq, dk, dv


flash_attn_bwd_f32.launches = 0


class FlashAttention(torch.autograd.Function):
    """Attention through the forward kernel with the backward kernel as
    its gradient: ``FlashAttention.apply(q, k, v, causal, window)`` on
    contiguous CUDA tensors (the launchers' conditions), causal or not,
    with any Tq and Tk, (hd, dv) one of `DIM_PAIRS` (MLA's narrower
    values too). Capturable; under `torch.func.vmap` it raises."""

    @staticmethod
    def forward(q, k, v, causal, window):
        _check_shapes(q, k, v)
        _check_kernel_shape("FlashAttention", q, k, v, DIM_PAIRS)
        return flash_attn_f32(q, k, v, causal=causal, window=window,
                              return_lse=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window = inputs
        out, lse = output
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal, ctx.window = causal, window

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attn_bwd_f32(q, k, v, out, lse, dout.contiguous(),
                                        causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError(
            "FlashAttention: reached under torch.func.vmap; the attention "
            "kernels have no vmap rule, so batched LM sweeps through them "
            "are not ported yet")
