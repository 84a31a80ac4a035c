"""Chunked gated linear attention, forward (port of
``repro/kernels/chunk_scan.py`` with the host scan of
``repro/kernels/ops.py:gla_chunked``) and backward: the shared core of
Mamba2 and RWKV6.

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
`ref.gla_recurrence_ref` is the semantic ground truth of both.

`gla_chunk_bwd_f32` calls ``csrc/gla_chunk_bwd_f32.cu``, the gradient of
that call with respect to q, k, v, log_decay and the bonus (it has no TPU
original: the reference differentiates its jnp `gla_chunked` with
`jax.grad`), from the states each chunk entered with, which
`gla_chunk_f32(..., return_states=True)` hands out of the forward's
workspace. Its plain version is `models/ssm.gla_chunked_bwd_plain`.
`GLAChunked`, the autograd Function that `models/ssm.gla_chunked` takes
on CUDA under grad, joins the two. A direct `gla_chunk_f32` call on an
input that requires grad raises."""
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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("gla_chunk_bwd_f32")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.gla_chunk_bwd_f32.argtypes = [p] * 13 + [i32, i32] + \
        [i64] * 6 + [p] * 6
    lib.gla_chunk_bwd_f32.restype = i32
    return lib


def _check(name, q, k, v, log_decay, bonus, initial_state, dy=None):
    """The launchers' conditions (see the module docstring); `name` heads
    every message."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or \
            v.shape[:3] != q.shape[:3]:
        raise ValueError(f"{name}: q, k (B, T, H, K) and v (B, T, H, "
                         f"V); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    if log_decay.shape not in ((b, t, h), (b, t, h, kd)):
        raise ValueError(f"{name}: log_decay must be (B, T, H) or "
                         f"(B, T, H, K); got {tuple(log_decay.shape)}")
    if bonus is not None and bonus.shape != (h, kd):
        raise ValueError(f"{name}: bonus must be (H, K) = "
                         f"{(h, kd)}; got {tuple(bonus.shape)}")
    if initial_state is not None and initial_state.shape != (b, h, kd, vd):
        raise ValueError(f"{name}: initial_state must be (B, H, K, V)"
                         f" = {(b, h, kd, vd)}; got "
                         f"{tuple(initial_state.shape)}")
    if dy is not None and dy.shape != v.shape:
        raise ValueError(f"{name}: dy must be v's shape {tuple(v.shape)}; "
                         f"got {tuple(dy.shape)}")
    if kd > MAX_KV or vd > MAX_KV or min(b, t, h, kd, vd) < 1:
        raise ValueError(f"{name}: K = {kd}, V = {vd} must lie in "
                         f"[1, {MAX_KV}] and B, T, H be positive")
    tensors = {"q": q, "k": k, "v": v, "log_decay": log_decay,
               "bonus": bonus, "initial_state": initial_state, "dy": dy}
    for arg, x in tensors.items():
        if x is not None and x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name}: {arg} requires grad; this launcher has no "
                "gradient of its own: train through chunk_scan.GLAChunked "
                "(models/ssm.gla_chunked takes it on CUDA under grad)")
    for arg, x in tensors.items():
        if x is None:
            continue
        if x.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {x.device}, not CUDA")
        if x.device != q.device:
            raise ValueError(f"{name}: {arg} is on {x.device}, q on "
                             f"{q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype or \
            (dy is not None and dy.dtype != q.dtype):
        raise TypeError(f"{name}: q, k, v (and dy) must share one dtype, "
                        f"f32 or bf16; got {q.dtype}, {k.dtype}, {v.dtype}"
                        + ("" if dy is None else f", {dy.dtype}"))
    for arg in ("log_decay", "bonus", "initial_state"):
        x = tensors[arg]
        if x is not None and x.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got "
                            f"{x.dtype}")
    # the kernels read the last dim of these at unit stride (a scalar
    # decay has no channel dim: its three strides are all they read)
    for arg in ("q", "k", "v", "dy") + (("log_decay",) if
                                        log_decay.dim() == 4 else ()):
        x = tensors[arg]
        if x is not None and x.shape[-1] > 1 and x.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs unit stride in its "
                             "last dim")
    for arg in ("bonus", "initial_state"):
        x = tensors[arg]
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_chunk(name, b, t, h, chunk):
    """min(chunk, T), checked against the kernels' limits (a grid of
    (B·H, chunks) blocks)."""
    chunk = min(int(chunk), t)
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"{name}: chunk {chunk} not in [1, {MAX_CHUNK}]")
    if b * h > MAX_HEADS:
        raise ValueError(f"{name}: B·H = {b * h} exceeds the kernel's "
                         f"{MAX_HEADS} counters")
    if -(-t // chunk) > _MAX_GRID_Y:
        raise ValueError(f"{name}: T = {t} in chunks of {chunk} exceeds "
                         "the kernel's grid")
    return chunk


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


def bwd_workspace_floats(b: int, t: int, h: int, kd: int, vd: int,
                         chunk: int) -> int:
    """Floats of the backward's workspace: Q_c and then dS (B·H, chunks,
    K, V), the chunks' decays (B·H, chunks, K) and the bonus partials
    (B·H, chunks, K), chunks of min(chunk, T) tokens."""
    n_ws, n_dws = workspace_floats(b, t, h, kd, vd, chunk)
    return n_ws + 2 * n_dws


def gla_chunk_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_decay: torch.Tensor, *, chunk: int,
                  bonus: Optional[torch.Tensor] = None,
                  initial_state: Optional[torch.Tensor] = None,
                  return_states: bool = False):
    """Launch the CUDA kernel over the whole sequence in chunks of
    min(chunk, T) tokens (one launch of its two passes;
    `gla_chunk_f32.launches` counts them). Returns (y, final state), and
    with `return_states` also the states each chunk entered with, (B·H,
    chunks, K, V) f32: a view of the call's workspace, which the kernel
    wrote and nothing else reads."""
    build.refuse_vmapped("gla_chunk_f32", q, k, v, log_decay, bonus,
                         initial_state)
    _check("gla_chunk_f32", q, k, v, log_decay, bonus, initial_state)
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    chunk = _check_chunk("gla_chunk_f32", b, t, h, chunk)
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
    if return_states:
        return y, state, ws[:n_ws].view(b * h, -(-t // chunk), kd, vd)
    return y, state


gla_chunk_f32.launches = 0


def bwd_route(q: torch.Tensor, v: torch.Tensor, log_decay: torch.Tensor,
              bonus: Optional[torch.Tensor]) -> str:
    """The route `gla_chunk_bwd_f32` takes for these inputs, for
    reporting (the kernel decides it from the same inputs): "tensor cores"
    for bf16 inputs with a scalar decay under "post" (no bonus) and K, V
    multiples of 8 (Mamba2), else "ffma"."""
    tc = q.dtype == torch.bfloat16 and log_decay.dim() == 3 and \
        bonus is None and q.shape[-1] % 8 == 0 and v.shape[-1] % 8 == 0
    return "tensor cores" if tc else "ffma"


def gla_chunk_bwd_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      log_decay: torch.Tensor, dy: torch.Tensor,
                      states: torch.Tensor, *, chunk: int,
                      bonus: Optional[torch.Tensor] = None):
    """The gradient of `gla_chunk_f32(q, k, v, log_decay, chunk=chunk,
    bonus=bonus, ...)` with respect to q, k, v, log_decay and the bonus
    under the cotangent `dy` of y (none for the final state), from
    `states`, the entering states that call returned: one launch of the
    kernel's passes, five (four under "post": no bonus), the Q_c and
    pair passes on the tensor cores where `bwd_route` says so
    (`gla_chunk_bwd_f32.launches` counts calls). dy
    in q's dtype, unit stride in its last dim. Returns (dq, dk, dv in q's
    dtype; d log_decay f32 in its shape; d bonus (H, K) f32 or None),
    each contiguous."""
    name = "gla_chunk_bwd_f32"
    build.refuse_vmapped(name, q, k, v, log_decay, dy, states, bonus)
    _check(name, q, k, v, log_decay, bonus, None, dy)
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    chunk = _check_chunk(name, b, t, h, chunk)
    n_chunks = -(-t // chunk)
    if states.shape != (b * h, n_chunks, kd, vd) or \
            states.dtype != torch.float32 or not states.is_contiguous() or \
            states.device != q.device:
        raise ValueError(f"{name}: states must be contiguous f32 (B·H, "
                         f"chunks, K, V) = {(b * h, n_chunks, kd, vd)} on "
                         f"{q.device}; got {tuple(states.shape)} "
                         f"{states.dtype} on {states.device}")
    per_channel = log_decay.dim() == 4
    dq = torch.empty((b, t, h, kd), dtype=q.dtype, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty((b, t, h, vd), dtype=q.dtype, device=q.device)
    dld = torch.empty(log_decay.shape, dtype=torch.float32, device=q.device)
    dbonus = None if bonus is None else torch.empty(
        (h, kd), dtype=torch.float32, device=q.device)
    ws = torch.empty(bwd_workspace_floats(b, t, h, kd, vd, chunk),
                     dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_lib().gla_chunk_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dy.data_ptr(),
            log_decay.data_ptr(), _ptr(bonus), states.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dld.data_ptr(),
            _ptr(dbonus), ws.data_ptr(), int(q.dtype == torch.bfloat16),
            int(per_channel), b, t, h, kd, vd, chunk, _strides(q),
            _strides(k), _strides(v), _strides(dy), _strides(log_decay),
            stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    build.count_launches(gla_chunk_bwd_f32)
    return dq, dk, dv, dld, dbonus


gla_chunk_bwd_f32.launches = 0


class GLAChunked(torch.autograd.Function):
    """The chunked GLA through the forward kernel with the backward kernel
    as its gradient: ``GLAChunked.apply(q, k, v, log_decay, bonus,
    initial_state, chunk)`` → (y, final state, entering states), the
    launchers' conditions on the inputs. The forward is `gla_chunk_f32`'s
    call as it is (y and the state bitwise), and keeps the states each
    chunk entered with for the backward (B·H·⌈T/L⌉·K·V floats a call) in
    place of a second state pass. Gradients flow to q, k, v, log_decay
    and the bonus; the final state's cotangent and a gradient of
    `initial_state` are not ported (no path of either package trains
    through them) and raise, as does `torch.func.vmap`. It syncs nothing
    and allocates on the current stream."""

    @staticmethod
    def forward(q, k, v, log_decay, bonus, initial_state, chunk):
        if initial_state is not None and initial_state.requires_grad:
            raise NotImplementedError(
                "GLAChunked: initial_state requires grad; the gradient of "
                "the initial state is not ported")
        return gla_chunk_f32(q, k, v, log_decay, chunk=chunk, bonus=bonus,
                             initial_state=initial_state, return_states=True)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, log_decay, bonus, _, chunk = inputs
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(output[2])
        ctx.save_for_backward(q, k, v, log_decay, bonus, output[2])
        ctx.chunk = chunk

    @staticmethod
    def backward(ctx, dy, dstate, _dstates):
        if dstate is not None:
            raise NotImplementedError(
                "GLAChunked: the final state has a cotangent; the gradient "
                "through the final state is not ported")
        if dy is None:
            return (None,) * 7
        q, k, v, log_decay, bonus, states = ctx.saved_tensors
        if dy.stride(-1) != 1:
            dy = dy.contiguous()
        dq, dk, dv, dld, dbonus = gla_chunk_bwd_f32(
            q, k, v, log_decay, dy, states, chunk=ctx.chunk, bonus=bonus)
        return dq, dk, dv, dld, dbonus, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError(
            "GLAChunked: reached under torch.func.vmap; the GLA kernels "
            "have no vmap rule, so batched SSM sweeps through them are not "
            "ported yet")
