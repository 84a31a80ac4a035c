"""The paper CNN's training-step layer: convolution as im2col + GEMM
(port of ``repro/kernels/local_step.py``).

* `im2col` — SAME stride-1 patch extraction by pad + slice + concat, in
  the reference's (kh, kw, c) order, so a (kh, kw, C_in, C_out) filter
  reshapes to the matching (kh·kw·C_in, C_out) matrix.
* `gemm` — the f32 matrix product of every conv, forward and backward.
  On a CUDA tensor it launches the hand-written kernel
  ``csrc/gemm_f32.cu`` (see its header for what it replaces and what
  bounds it) with the plan `gemm_plan` chooses: block tile and split-K;
  its gradient is a `torch.autograd.Function` whose backward
  runs the same kernel for dA = G·Bᵀ and dB = Aᵀ·G through transpose
  flags, as the reference's custom VJP runs its Pallas kernel. The kernel
  takes a run axis: under `torch.func.vmap` (a batched training step's
  B runs) the Function's vmap rule folds vmap's axis into it, so each
  product of the step is one launch for all B runs, each run's product
  bit for bit the one a launch of it alone computes; autograd then runs
  the backward's products on the run-stacked tensors, one launch each.
  On a CPU tensor it takes the plain version `ref.gemm_ref`. Any other
  device raises; nothing falls back.
* `maxpool2x2` — reshape + amax. `amax` splits the gradient evenly over
  ties, as the reference's `max` reduction does; `F.max_pool2d` would
  route it to one element.
* `fused_loss_for` — the capability probe the trainer consults: a model
  whose native loss is not the training formulation attaches its
  im2col + GEMM twin under `FUSED_LOSS_ATTR`.
* `sgd_update_tree` — the SGD update p − lr·(g + wd·p) over every leaf of
  a parameter dict (`optim.sgd`'s route), f32 or bf16 leaves, computed
  in f32. On CUDA tensors it launches the hand-written kernel
  ``csrc/sgd_f32.cu`` once for all leaves, laid out by `sgd_plan` (the
  slots split evenly over a resident grid; gradients that autograd hands
  as views read in place); on CPU tensors it takes the plain version
  `ref.sgd_update_ref` per leaf.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.ref import gemm_ref, sgd_update_ref

# Attribute under which a model registers its training-loss twin.
FUSED_LOSS_ATTR = "fused_step_loss"

# csrc/gemm_f32.cu's block tiles (rows, cols), by the index its C
# interface takes, largest first
GEMM_TILES = ((128, 128), (128, 64), (64, 64))
CHUNK_K = 128          # K per partial sum, the reference's BLOCK_K
N_SMS = 132            # H100 SXM streaming multiprocessors
# a product whose tiles fill this many SMs is not split
_FILL = N_SMS * 9 // 10
# the 128×128 tile (one block an SM) only for K of at least 4 chunks:
# below that its loads and epilogue are not hidden behind its FMAs
_BIG_TILE_MIN_K = 4 * CHUNK_K
# a split product aims at this many blocks (three waves of the 64×64
# tile's two blocks an SM) with at most _MAX_SPLITS slices (the tile's last
# block adds them one after another)
_SPLIT_BLOCKS = 6 * N_SMS
_MAX_SPLITS = 128
_MAX_GRID_YZ = 65535   # CUDA's limit on gridDim.y and gridDim.z
_COUNTERS = 65536      # split tiles a launch may have over all its runs
                       # (one counter each; 256 KiB): a fleet cohort of 64
                       # runs of the CNN's c3 weight gradient has 4,608


def fused_loss_for(loss_fn: Callable) -> Callable:
    """The loss the training steps are built over: the model's registered
    twin under `FUSED_LOSS_ATTR`, else the loss itself."""
    return getattr(loss_fn, FUSED_LOSS_ATTR, None) or loss_fn


# ---------------------------------------------------------------------------
# im2col
# ---------------------------------------------------------------------------

def im2col(x: torch.Tensor, k: int = 3) -> torch.Tensor:
    """(B, H, W, C) → (B, H, W, k·k·C) SAME stride-1 patches ordered
    (kh, kw, c)."""
    b, h, w, c = x.shape
    lo = (k - 1) // 2
    hi = k - 1 - lo
    xp = F.pad(x, (0, 0, lo, hi, lo, hi))
    cols = [xp[:, i:i + h, j:j + w, :] for i in range(k) for j in range(k)]
    return torch.cat(cols, dim=-1)


# ---------------------------------------------------------------------------
# The GEMM kernel's wrapper
# ---------------------------------------------------------------------------

class GemmPlan(NamedTuple):
    """How csrc/gemm_f32.cu computes one (M, K) @ (K, N) product: block
    tile `GEMM_TILES[tile]`, and `splits` slices of `slice_k` along K
    (a multiple of `CHUNK_K`; K itself when `splits` is 1)."""
    tile: int
    splits: int
    slice_k: int

    @property
    def block(self) -> Tuple[int, int]:
        return GEMM_TILES[self.tile]

    def grid(self, m: int, n: int) -> Tuple[int, int, int]:
        """(x, y, z) = (column tiles, row tiles, slices)."""
        bm, bn = self.block
        return -(-n // bn), -(-m // bm), self.splits

    def workspace(self, m: int, n: int) -> int:
        """Floats of the slices' partial sums (0 when not split)."""
        if self.splits == 1:
            return 0
        gx, gy, _ = self.grid(m, n)
        bm, bn = self.block
        return gx * gy * self.splits * bm * bn


def gemm_plan(m: int, n: int, k: int) -> GemmPlan:
    """The plan of one product. Tile: the largest whose tiles (nearly)
    fill the card's SMs, not wider or taller than the output needs
    (N ≤ 64 or M ≤ 64 take 64), 128×128 only for a long K; 64×64 when none
    does. Split-K when the tiles leave SMs idle and K holds more than one
    128-wide chunk: about `_SPLIT_BLOCKS` blocks in at most `_MAX_SPLITS`
    slices, each a whole number of chunks, none empty. Raises where the
    grid would exceed CUDA's limits. (The constants were read off a sweep
    of plans over the paper CNN's products on an H100.)"""
    if min(m, n, k) <= 0:
        raise ValueError(f"gemm_plan: empty product ({m}, {k}) @ ({k}, {n})")
    tile = len(GEMM_TILES) - 1
    for i, (bm, bn) in enumerate(GEMM_TILES):
        if (bm > 64 and m <= 64) or (bn > 64 and n <= 64) or (
                i == 0 and k < _BIG_TILE_MIN_K):
            continue
        if -(-m // bm) * -(-n // bn) >= _FILL:
            tile = i
            break
    bm, bn = GEMM_TILES[tile]
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // CHUNK_K)
    splits, slice_k = 1, k
    if tiles < _FILL and chunks > 1:
        want = min(chunks, _MAX_SPLITS, -(-_SPLIT_BLOCKS // tiles))
        per = -(-chunks // want)
        splits, slice_k = -(-chunks // per), per * CHUNK_K
    plan = GemmPlan(tile, splits, slice_k)
    _, gy, gz = plan.grid(m, n)
    if gy > _MAX_GRID_YZ or gz > _MAX_GRID_YZ or (
            splits > 1 and tiles > _COUNTERS):
        raise ValueError(f"gemm_plan: no grid for ({m}, {k}) @ ({k}, {n})")
    return plan


def runs_fit(plan: GemmPlan, m: int, n: int, runs: int) -> bool:
    """Whether one launch takes `runs` products of `plan` with an (m, n)
    output: CUDA's limit on gridDim.z (runs × slices) and, split, one
    counter a split tile over all the runs."""
    gx, gy, _ = plan.grid(m, n)
    return runs * plan.splits <= _MAX_GRID_YZ and (
        plan.splits == 1 or runs * gx * gy <= _COUNTERS)


def bind_gemm(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of `lib.gemm_f32` (csrc/gemm_f32.cu)."""
    fn = lib.gemm_f32
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    fn.argtypes = [p, p, p, i64, i64, i64, i32, i64, i64, i32, i32, i32, i64,
                   i32, p, p, p]
    fn.restype = ctypes.c_int
    return lib


@functools.cache
def _gemm_lib() -> ctypes.CDLL:
    return bind_gemm(build.load("gemm_f32"))


def _run_matrices(t: torch.Tensor) -> bool:
    """Whether each matrix of `t` (2-D, or 3-D with a leading run axis of
    any stride) is row-major contiguous."""
    rows, cols = t.shape[-2:]
    return (cols <= 1 or t.stride(-1) == 1) and \
        (rows <= 1 or t.stride(-2) == cols)


def gemm_f32(a: torch.Tensor, b: torch.Tensor, *, trans_a: bool = False,
             trans_b: bool = False) -> torch.Tensor:
    """Launch the CUDA kernel: op(a) @ op(b) in f32, where op transposes
    when its flag is set. `a` is stored (M, K), or (K, M) with `trans_a`;
    `b` is stored (K, N), or (N, K) with `trans_b`. Both 2-D, or both 3-D
    with a leading run axis of R: R products in one launch, (R, M, N) out,
    each with the one product's plan, so bitwise R launches of it; a run
    stride may be anything, 0 for an operand the runs share. Each matrix
    row-major contiguous, f32, CUDA, one device. `gemm_f32.launches`
    counts the launches."""
    build.refuse_vmapped("gemm_f32", a, b)
    if a.dim() != b.dim() or a.dim() not in (2, 3):
        raise ValueError(f"gemm_f32: operands {tuple(a.shape)} and "
                         f"{tuple(b.shape)}; expected both 2-D or both "
                         "3-D (R, ·, ·)")
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"gemm_f32: {name} is on {t.device}, not CUDA")
        if t.dtype != torch.float32:
            raise TypeError(f"gemm_f32: {name} is {t.dtype}, not float32")
        if not _run_matrices(t):
            raise ValueError(f"gemm_f32: {name}'s matrices must be "
                             "contiguous")
    if a.device != b.device:
        raise ValueError(f"gemm_f32: operands on {a.device} and {b.device}")
    runs = a.shape[0] if a.dim() == 3 else 1
    if a.dim() == 3 and b.shape[0] != runs:
        raise ValueError(f"gemm_f32: {runs} runs of a, {b.shape[0]} of b")
    m, k = (a.shape[-1], a.shape[-2]) if trans_a else a.shape[-2:]
    k2, n = (b.shape[-1], b.shape[-2]) if trans_b else b.shape[-2:]
    if k != k2:
        raise ValueError(f"gemm_f32: inner dimensions differ: op(a) is "
                         f"({m}, {k}), op(b) is ({k2}, {n})")
    if min(m, n, k, runs) == 0:
        raise ValueError(f"gemm_f32: empty product ({m}, {k}) @ ({k}, {n}) "
                         f"× {runs} runs")
    plan = gemm_plan(m, n, k)
    if not runs_fit(plan, m, n, runs):
        raise ValueError(f"gemm_f32: no grid for {runs} runs of ({m}, {k}) "
                         f"@ ({k}, {n})")
    a_run = a.stride(0) if a.dim() == 3 else 0
    b_run = b.stride(0) if b.dim() == 3 else 0
    lib = _gemm_lib()
    c = torch.empty(a.shape[:-2] + (m, n), device=a.device,
                    dtype=torch.float32)
    ws = counters = None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        if plan.splits > 1:
            ws = torch.empty(runs * plan.workspace(m, n), device=a.device,
                             dtype=torch.float32)
            counters = build.counters(a.device, stream, _COUNTERS)
        err = lib.gemm_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
                           runs, a_run, b_run, int(trans_a), int(trans_b),
                           plan.tile, plan.slice_k, plan.splits,
                           None if ws is None else ws.data_ptr(),
                           None if counters is None else counters.data_ptr(),
                           stream)
    if err != 0:
        raise RuntimeError(f"gemm_f32: launch failed with CUDA error {err}")
    build.count_launches(gemm_f32)
    return c


gemm_f32.launches = 0


def _product(a: torch.Tensor, b: torch.Tensor, trans_a: bool = False,
             trans_b: bool = False) -> torch.Tensor:
    """Route one product (2-D, or 3-D run-stacked) by the operands'
    device: the kernel on CUDA, the plain version on the CPU."""
    if a.device.type == "cuda":
        return gemm_f32(a, b, trans_a=trans_a, trans_b=trans_b)
    if a.device.type == "cpu":
        return gemm_ref(a.transpose(-1, -2) if trans_a else a,
                        b.transpose(-1, -2) if trans_b else b)
    raise ValueError(f"gemm: no route for tensors on {a.device}")


def _fold_runs(x: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """vmap's physical operand as a run-stacked (size·R, ·, ·) tensor with
    row-major matrices: its vmapped axis first (an operand vmap does not
    map is shared, run stride 0), folded into a run axis it already has."""
    x = x.movedim(bdim, 0) if bdim is not None else x.expand(size, *x.shape)
    if x.dim() == 4:
        x = x.flatten(0, 1)
    return x if _run_matrices(x) else x.contiguous()


class GemmF32Function(torch.autograd.Function):
    """f32 op(a) @ op(b) for 2-D or run-stacked 3-D operands, whose
    backward runs the same product route for dA = G·Bᵀ and dB = Aᵀ·G
    (skipping the ones not needed). Under `torch.func.vmap` its rule
    (`vmap`) folds vmap's axis into the run axis and applies the Function
    to the run-stacked operands: one launch for every run, recorded by
    autograd on the stacked tensors, whose backward is again one launch a
    product."""
    generate_vmap_rule = False

    @staticmethod
    def forward(a, b):
        return _product(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.contiguous()
        da = _product(g, b, trans_b=True) if ctx.needs_input_grad[0] else None
        db = _product(a, g, trans_a=True) if ctx.needs_input_grad[1] else None
        return da, db

    @staticmethod
    def vmap(info, in_dims, a, b):
        size = info.batch_size
        out = GemmF32Function.apply(_fold_runs(a, in_dims[0], size),
                                    _fold_runs(b, in_dims[1], size))
        if a.dim() - (in_dims[0] is not None) == 3:   # runs of its own
            out = out.reshape(size, -1, *out.shape[-2:])
        return out, 0


def gemm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Differentiable f32 matmul: the CUDA kernel for CUDA tensors (forward
    and both gradients; under `torch.func.vmap` one launch for all runs),
    the plain version for CPU tensors."""
    return GemmF32Function.apply(a.float().contiguous(),
                                 b.float().contiguous())


# ---------------------------------------------------------------------------
# Conv + pooling in GEMM form
# ---------------------------------------------------------------------------

def conv2d_gemm(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 NHWC conv as im2col + GEMM; w is (kh, kw, C_in, C_out).
    Forward and both gradients go through `gemm`."""
    k = w.shape[0]
    cols = im2col(x, k)
    bsz, h, wd, kk = cols.shape
    y = gemm(cols.reshape(-1, kk), w.reshape(kk, -1))
    return y.reshape(bsz, h, wd, -1) + b


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2×2 max pool (NHWC) as reshape + amax; the gradient
    splits evenly over tied maxima, as in the reference."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


# ---------------------------------------------------------------------------
# Fused SGD update sweep
# ---------------------------------------------------------------------------

# csrc/sgd_f32.cu: threads a block, slots a thread has in flight, leaves
# and gradient views a table holds; the resident grid (two blocks on each
# SM) a table's slots are split over
SGD_THREADS = 256
SGD_UNROLL = 8
SGD_MAX_LEAVES = 64
SGD_MAX_VIEWS = 8
SGD_BLOCKS = 2 * N_SMS
SGD_SLOT = 4            # elements a slot
SGD_DTYPES = (torch.float32, torch.bfloat16)   # a leaf's p and g, each


class _SgdLeaf(ctypes.Structure):
    """One leaf of csrc/sgd_f32.cu's table (its `SgdLeaf`)."""
    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("n", ctypes.c_int64),
                ("slot0", ctypes.c_int64), ("vec", ctypes.c_int),
                ("view", ctypes.c_int), ("bf16", ctypes.c_int)]


class _SgdView(ctypes.Structure):
    """A gradient read as a view of its param's shape (its `SgdView`)."""
    _fields_ = [("size", ctypes.c_int * 4), ("stride", ctypes.c_int64 * 4)]


def bind_sgd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of `lib.sgd_f32` (csrc/sgd_f32.cu) and check
    that its table is the one this module packs."""
    fn = lib.sgd_f32
    fn.argtypes = [ctypes.POINTER(_SgdLeaf), ctypes.c_int,
                   ctypes.POINTER(_SgdView), ctypes.c_int, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sizes = {"sgd_f32_max_leaves": SGD_MAX_LEAVES,
             "sgd_f32_max_views": SGD_MAX_VIEWS,
             "sgd_f32_leaf_bytes": ctypes.sizeof(_SgdLeaf),
             "sgd_f32_view_bytes": ctypes.sizeof(_SgdView)}
    for name, want in sizes.items():
        getattr(lib, name).restype = ctypes.c_int
        if getattr(lib, name)() != want:
            raise RuntimeError(f"sgd_f32: the library's {name} differs from "
                               "kernels/local_step.py's")
    return lib


@functools.cache
def _sgd_lib() -> ctypes.CDLL:
    return bind_sgd(build.load("sgd_f32"))


class SgdTable(NamedTuple):
    """One launch of csrc/sgd_f32.cu: `leaves` (indices into the call's
    leaves, all non-empty) whose slots of `SGD_SLOT` elements start at
    `slot0` (a leaf's last slot may be short); `slots` in all, split into
    `grid` ranges of `per_block` (the last one shorter). Block b's threads
    take the slots b·per_block + tid + 256·u."""
    leaves: Tuple[int, ...]
    slot0: Tuple[int, ...]
    slots: int
    per_block: int
    grid: int


@functools.lru_cache(maxsize=64)
def sgd_plan(sizes: Tuple[int, ...],
             views: Tuple[int, ...] = ()) -> Tuple[SgdTable, ...]:
    """The launches of one update over leaves of `sizes` elements, of which
    the leaves at the indices `views` read their gradient through a view:
    the non-empty leaves in order, a new table when one holds
    `SGD_MAX_LEAVES` leaves or `SGD_MAX_VIEWS` views; each table's slots
    split evenly over at most `SGD_BLOCKS` blocks (a range may cross leaf
    boundaries). Raises where the kernel takes no such call."""
    if any(n < 0 for n in sizes):
        raise ValueError(f"sgd_plan: negative leaf sizes {sizes}")
    if any(not 0 <= i < len(sizes) or sizes[i] >= 2 ** 31 for i in views):
        raise ValueError(f"sgd_plan: views {views} must name leaves of "
                         "fewer than 2³¹ elements")
    tables, leaves, n_views = [], [], 0
    for i, n in enumerate(sizes):
        if not n:
            continue
        if len(leaves) == SGD_MAX_LEAVES or (
                i in views and n_views == SGD_MAX_VIEWS):
            tables.append(leaves)
            leaves, n_views = [], 0
        leaves.append(i)
        n_views += i in views
    if leaves:
        tables.append(leaves)
    plans = []
    for leaves in tables:
        counts = [-(-sizes[i] // SGD_SLOT) for i in leaves]
        slot0 = tuple(sum(counts[:j]) for j in range(len(counts)))
        slots = sum(counts)
        grid = min(SGD_BLOCKS, -(-slots // SGD_THREADS))
        per_block = -(-slots // grid)
        plans.append(SgdTable(tuple(leaves), slot0, slots, per_block,
                              -(-slots // per_block)))
    return tuple(plans)


def _grad_view(g: torch.Tensor):
    """None where g is contiguous; else g's (sizes, strides), padded to 4
    dims."""
    if g.is_contiguous():
        return None
    pad = 4 - g.dim()
    return ((1,) * pad + tuple(g.shape), (0,) * pad + tuple(g.stride()))


def sgd_f32(params: List[torch.Tensor], grads: List[torch.Tensor], *,
            lr: float, wd: float = 0.0) -> List[torch.Tensor]:
    """Launch the CUDA kernel: a new tensor p − lr·(g + wd·p) for every
    (p, g) pair, all leaves in one launch (more only beyond the kernel's
    table of leaves or of gradient views). Every tensor must be an f32 or
    bf16 CUDA tensor on one device (dtypes may mix: each p's result has
    its dtype, computed in f32 and rounded to nearest even for bf16), each
    p contiguous, each g shaped like its p and either contiguous or a view
    of at most 4 dims (read in place, as autograd hands a permuted
    weight's gradient); the inputs are left unchanged. `sgd_f32.launches`
    counts the launches."""
    build.refuse_vmapped("sgd_f32", *params, *grads)
    if len(params) != len(grads):
        raise ValueError(f"sgd_f32: {len(params)} params but "
                         f"{len(grads)} grads")
    if not params:
        return []
    device = params[0].device
    for i, (p, g) in enumerate(zip(params, grads)):
        for name, t in (("param", p), ("grad", g)):
            if t.device.type != "cuda":
                raise ValueError(f"sgd_f32: {name} {i} is on {t.device}, "
                                 "not CUDA")
            if t.device != device:
                raise ValueError(f"sgd_f32: {name} {i} is on {t.device}, "
                                 f"the first param on {device}")
            if t.dtype not in SGD_DTYPES:
                raise TypeError(f"sgd_f32: {name} {i} is {t.dtype}, not "
                                "float32 or bfloat16")
        if not p.is_contiguous():
            raise ValueError(f"sgd_f32: param {i} must be contiguous")
        if g.shape != p.shape:
            raise ValueError(f"sgd_f32: grad {i} is {tuple(g.shape)}, its "
                             f"param {tuple(p.shape)}")
        if not g.is_contiguous() and g.dim() > 4:
            raise ValueError(f"sgd_f32: grad {i} is a view of {g.dim()} "
                             "dims; the kernel reads views of at most 4")
    views = [_grad_view(g) for g in grads]
    outs = [torch.empty_like(p) for p in params]
    lib = _sgd_lib()
    plans = sgd_plan(tuple(p.numel() for p in params),
                     tuple(i for i, v in enumerate(views) if v))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for plan in plans:
            leaves = (_SgdLeaf * len(plan.leaves))()
            table_views = []
            for j, (i, slot0) in enumerate(zip(plan.leaves, plan.slot0)):
                p, g, o = params[i], grads[i], outs[i]
                # a slot's vector: 4 elements, 16 bytes in f32, 8 in bf16
                aligned = (p.data_ptr() | o.data_ptr()) % (
                    4 * p.element_size()) == 0
                g_vec = views[i] is None and \
                    g.data_ptr() % (4 * g.element_size()) == 0
                leaves[j] = _SgdLeaf(p.data_ptr(), g.data_ptr(),
                                     o.data_ptr(), p.numel(), slot0,
                                     int(aligned) | 2 * int(g_vec),
                                     len(table_views) if views[i] else -1,
                                     int(p.dtype == torch.bfloat16) |
                                     2 * int(g.dtype == torch.bfloat16))
                if views[i]:
                    table_views.append(_SgdView(
                        (ctypes.c_int * 4)(*views[i][0]),
                        (ctypes.c_int64 * 4)(*views[i][1])))
            err = lib.sgd_f32(leaves, len(plan.leaves),
                              (_SgdView * max(1, len(table_views)))(
                                  *table_views), len(table_views), plan.slots,
                              plan.per_block, plan.grid, lr, wd, stream)
            if err != 0:
                raise RuntimeError(f"sgd_f32: launch failed with CUDA error "
                                   f"{err}")
            build.count_launches(sgd_f32)
    return outs


sgd_f32.launches = 0


def sgd_update_tree(params: Dict[str, torch.Tensor],
                    grads: Dict[str, torch.Tensor], *, lr: float,
                    wd: float = 0.0) -> Dict[str, torch.Tensor]:
    """SGD update p − lr·(g + wd·p) of every leaf, as new tensors. Routed
    by the leaves' device: one kernel launch for CUDA leaves, the plain
    version per leaf for CPU leaves; other or mixed devices raise."""
    devices = {p.device.type for p in params.values()}
    if devices == {"cuda"}:
        keys = list(params)
        # autograd hands the native forward's HWIO → OIHW weights a
        # permuted gradient; the kernel reads such views of ≤ 4 dims in
        # place
        outs = sgd_f32([params[k].contiguous() for k in keys],
                       [grads[k] if grads[k].dim() <= 4
                        else grads[k].contiguous() for k in keys],
                       lr=lr, wd=wd)
        return dict(zip(keys, outs))
    if devices == {"cpu"}:
        return {k: sgd_update_ref(p, grads[k], lr=lr, wd=wd)
                for k, p in params.items()}
    raise ValueError(f"sgd_update_tree: no route for leaves on "
                     f"{sorted(devices)}")
