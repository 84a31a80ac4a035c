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
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import bgmv_ref

MAX_RANK = 64            # the kernel's limit (csrc/bgmv_f32.cu MAX_R)
N_SMS = 132              # H100 SXM streaming multiprocessors
ROWS_PER_BLOCK = 32      # csrc/bgmv_f32.cu NB: activation rows a block
# d_in columns a shrink block sums (multiples of the 64 a row's 8 lanes
# take a pass) and d_out columns an expand block writes (8·ROWS threads
# of 4 columns each), smallest first
SPLIT_COLS = (64, 128, 256, 512, 1024)
OUT_COLS = (32, 64, 128, 256, 512)
MAX_U_STAGED = 8192      # csrc/bgmv_f32.cu MAX_U: floats of u a split stages
_MAX_GRID_YZ = 65535     # CUDA's limit on gridDim.y and gridDim.z
_MAX_GRID_X = 2 ** 31 - 1
_COUNTERS = 65536        # (member, row block) groups a call may have


class BgmvPlan(NamedTuple):
    """How csrc/bgmv_f32.cu runs one call: the shrink sums `split_cols`
    columns of d_in a block (`splits` blocks a row block and member), the
    expand writes `out_cols` columns of d_out a block."""
    split_cols: int
    splits: int
    out_cols: int
    row_blocks: int

    def shrink_grid(self, s: int) -> Tuple[int, int, int]:
        """(x, y, z) = (splits, row blocks, members)."""
        return self.splits, self.row_blocks, s

    def expand_grid(self, s: int, d_out: int) -> Tuple[int, int, int]:
        """(x, y, z) = (column tiles, row blocks, members)."""
        return -(-d_out // self.out_cols), self.row_blocks, s

    def workspace(self, s: int, r: int) -> Tuple[int, int]:
        """Floats of the splits' partials (0 for one split) and of t."""
        group = s * self.row_blocks * ROWS_PER_BLOCK * r
        return (group * self.splits if self.splits > 1 else 0), group


def _fill(widths, blocks_at) -> int:
    """The widest of `widths` whose grid puts at least one block on every
    SM, else the narrowest."""
    for w in reversed(widths):
        if blocks_at(w) >= N_SMS:
            return w
    return widths[0]


def bgmv_plan(s: int, n: int, d_in: int, d_out: int, r: int) -> BgmvPlan:
    """The launch plan of one call: the widest shrink split and expand
    tile whose grids still fill the card's 132 SMs (a call is latency,
    not bytes: a single wave of blocks that each finish quickly), or the
    narrowest where none does; a split stages at most `MAX_U_STAGED`
    floats of u (split_cols·r). Raises where a grid would exceed CUDA's
    limits or the counters."""
    if min(s, n, d_in, d_out, r) <= 0:
        raise ValueError(f"bgmv_plan: empty call S={s}, N={n}, d_in={d_in},"
                         f" d_out={d_out}, r={r}")
    rb = -(-n // ROWS_PER_BLOCK)
    widths = tuple(w for w in SPLIT_COLS if w * r <= MAX_U_STAGED)
    split_cols = _fill(widths, lambda w: s * rb * -(-d_in // w))
    out_cols = _fill(OUT_COLS, lambda w: s * rb * -(-d_out // w))
    plan = BgmvPlan(split_cols, -(-d_in // split_cols), out_cols, rb)
    if (s > _MAX_GRID_YZ or rb > _MAX_GRID_YZ or s * rb > _COUNTERS
            or plan.splits > _MAX_GRID_X
            or plan.expand_grid(s, d_out)[0] > _MAX_GRID_X):
        raise ValueError(f"bgmv_plan: S={s}, N={n}, d_in={d_in}, "
                         f"d_out={d_out} exceed the kernel's grid")
    return plan


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("bgmv_f32")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.bgmv_f32.argtypes = [p, i32, p, p, p, p, p, p, i64, i64, i64, i64,
                             i64, i32, i64, i64, p]
    lib.bgmv_f32.restype = i32
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
    shrink and expand kernels as `bgmv_plan` lays them out;
    `bgmv_f32.launches` counts the launches."""
    build.refuse_vmapped("bgmv_f32", x, u, v)
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
    plan = bgmv_plan(s, n, d_in, d_out, r)
    lib = _lib()
    y = torch.empty((s, n, d_out), device=x.device, dtype=torch.float32)
    n_part, n_t = plan.workspace(s, r)
    ws = torch.empty(n_part + n_t, device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        counters = build.counters(x.device, stream, _COUNTERS)
        err = lib.bgmv_f32(x.data_ptr(), int(x.dtype == torch.bfloat16),
                           u.data_ptr(), v.data_ptr(), y.data_ptr(),
                           ws.data_ptr(), ws.data_ptr() + 4 * n_part,
                           counters.data_ptr(), s, n,
                           d_in, d_out, r, int(shared), plan.split_cols,
                           plan.out_cols, stream)
    if err != 0:
        raise RuntimeError(f"bgmv_f32: launch failed with CUDA error {err}")
    build.count_launches(bgmv_f32)
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
