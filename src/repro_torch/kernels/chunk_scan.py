"""Chunked gated linear attention, forward (port of
``repro/kernels/chunk_scan.py`` with the host scan of
``repro/kernels/ops.py:gla_chunked``): the shared core of Mamba2 and
RWKV6.

    q, k (B, T, H, K); v (B, T, H, V); log_decay (B, T, H) scalar per
    head or (B, T, H, K) per channel, f32, ≤ 0; bonus (H, K) f32 ("pre"
    convention with the current-token bonus, RWKV6) or None ("post",
    Mamba2); initial_state (B, H, K, V) f32 or None  →  y (B, T, H, V) in
    v's dtype and the final state (B, H, K, V) in f32.

`gla_chunk_f32` calls the hand-written kernel ``csrc/gla_chunk_f32.cu``
once for the whole sequence, in its chunk-parallel form: a state pass (a
block per chunk forms the chunk's contribution to the state; the last
block of each (b, h) runs the recurrence over the chunks and stores the
state each chunk enters with to a workspace) and an output pass (a block
a chunk), two kernels a call. It takes q, k, v in one dtype (f32
or bf16) with unit stride in the last dim and any other strides (a head
stride of 0 reads Mamba2's q and k broadcast over the heads without a
copy), chunk ≤ 128 and K, V ≤ 64; anything else raises, as does a CPU
tensor. Its plain version is `models/ssm.gla_chunked_plain`, which
`models/ssm.gla_chunked` runs on the CPU; the step-by-step recurrence
`ref.gla_recurrence_ref` is the semantic ground truth of both."""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_CHUNK = 128
MAX_KV = 64
MAX_HEADS = 1 << 18      # B·H a call may have (one counter each)
_MAX_GRID_Y = 65535      # CUDA's limit on gridDim.y


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("gla_chunk_f32")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gla_chunk_f32.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i32, i32,
                                  i64, i64, i64, i64, i64, i64, p, p, p, p, p]
    lib.gla_chunk_f32.restype = i32
    return lib


def _check(q, k, v, log_decay, bonus, initial_state):
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or \
            v.shape[:3] != q.shape[:3]:
        raise ValueError(f"gla_chunk_f32: q, k (B, T, H, K) and v (B, T, H, "
                         f"V); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    if log_decay.shape not in ((b, t, h), (b, t, h, kd)):
        raise ValueError(f"gla_chunk_f32: log_decay must be (B, T, H) or "
                         f"(B, T, H, K); got {tuple(log_decay.shape)}")
    if bonus is not None and bonus.shape != (h, kd):
        raise ValueError(f"gla_chunk_f32: bonus must be (H, K) = "
                         f"{(h, kd)}; got {tuple(bonus.shape)}")
    if initial_state is not None and initial_state.shape != (b, h, kd, vd):
        raise ValueError(f"gla_chunk_f32: initial_state must be (B, H, K, V)"
                         f" = {(b, h, kd, vd)}; got "
                         f"{tuple(initial_state.shape)}")
    if kd > MAX_KV or vd > MAX_KV or min(b, t, h, kd, vd) < 1:
        raise ValueError(f"gla_chunk_f32: K = {kd}, V = {vd} must lie in "
                         f"[1, {MAX_KV}] and B, T, H be positive")
    tensors = {"q": q, "k": k, "v": v, "log_decay": log_decay,
               "bonus": bonus, "initial_state": initial_state}
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device.type != "cuda":
            raise ValueError(f"gla_chunk_f32: {name} is on {x.device}, not "
                             "CUDA")
        if x.device != q.device:
            raise ValueError(f"gla_chunk_f32: {name} is on {x.device}, q "
                             f"on {q.device}")
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                "gla_chunk_f32 is forward-only: no backward kernel")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"gla_chunk_f32: q, k, v must share one dtype, f32 "
                        f"or bf16; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name in ("log_decay", "bonus", "initial_state"):
        x = tensors[name]
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"gla_chunk_f32: {name} must be float32, got "
                            f"{x.dtype}")
    # the kernel reads the last dim of these at unit stride (a scalar
    # decay has no channel dim: its three strides are all it reads)
    for name in ("q", "k", "v") + (("log_decay",) if
                                   log_decay.dim() == 4 else ()):
        x = tensors[name]
        if x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"gla_chunk_f32: {name} needs unit stride in "
                             "its last dim")
    for name in ("bonus", "initial_state"):
        x = tensors[name]
        if x is not None and not x.is_contiguous():
            raise ValueError(f"gla_chunk_f32: {name} must be contiguous")


def _strides(x: torch.Tensor) -> ctypes.Array:
    return (ctypes.c_int64 * 3)(*x.stride()[:3])


def _ptr(x: Optional[torch.Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def workspace_floats(b: int, t: int, h: int, kd: int, vd: int,
                     chunk: int) -> Tuple[int, int]:
    """Floats of the two workspaces a call at these shapes needs: the
    chunks' contributions, then entering states, (B·H, ⌈T / min(chunk,
    T)⌉, K, V), and the chunks' decays (B·H, chunks, K)."""
    chunks = b * h * -(-t // min(chunk, t))
    return chunks * kd * vd, chunks * kd


def gla_chunk_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_decay: torch.Tensor, *, chunk: int,
                  bonus: Optional[torch.Tensor] = None,
                  initial_state: Optional[torch.Tensor] = None):
    """Launch the CUDA kernel over the whole sequence in chunks of
    min(chunk, T) tokens (one launch of its two passes;
    `gla_chunk_f32.launches` counts them). Returns (y, final state)."""
    build.refuse_vmapped("gla_chunk_f32", q, k, v, log_decay, bonus,
                         initial_state)
    _check(q, k, v, log_decay, bonus, initial_state)
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    chunk = min(int(chunk), t)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"gla_chunk_f32: chunk {chunk} not in [1, "
                         f"{MAX_CHUNK}]")
    if b * h > MAX_HEADS:
        raise ValueError(f"gla_chunk_f32: B·H = {b * h} exceeds the "
                         f"kernel's {MAX_HEADS} counters")
    if -(-t // chunk) > _MAX_GRID_Y:
        raise ValueError(f"gla_chunk_f32: T = {t} in chunks of {chunk} "
                         "exceeds the kernel's grid")
    per_channel = log_decay.dim() == 4
    y = torch.empty((b, t, h, vd), dtype=v.dtype, device=q.device)
    state = torch.empty((b, h, kd, vd), dtype=torch.float32, device=q.device)
    n_ws, n_dws = workspace_floats(b, t, h, kd, vd, chunk)
    ws = torch.empty(n_ws + n_dws, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().gla_chunk_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), log_decay.data_ptr(),
            _ptr(bonus), _ptr(initial_state), y.data_ptr(),
            state.data_ptr(), ws.data_ptr(), ws.data_ptr() + 4 * n_ws,
            build.counters(q.device, stream, MAX_HEADS).data_ptr(),
            int(q.dtype == torch.bfloat16),
            int(per_channel), b, t, h, kd, vd, chunk, _strides(q),
            _strides(k), _strides(v), _strides(log_decay),
            stream)
    if err != 0:
        raise RuntimeError(f"gla_chunk_f32: launch failed with CUDA error "
                           f"{err}")
    build.count_launches(gla_chunk_f32)
    return y, state


gla_chunk_f32.launches = 0
