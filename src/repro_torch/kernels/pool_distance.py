"""The FedELMY pool-distance statistics (port of
``repro/kernels/pool_distance.py``): the sweep behind the d1/d2
regularizers (Eq. 7–8) and the factor Gram of the low-rank pool.

**The sweep.** dist(m, m_t) for every pool member t needs, per member,

    sq[t] = Σ(w − m_t)²,  l1[t] = Σ|w − m_t|,  dot[t] = Σ w·m_t,
    norm[t] = Σ m_t²,

and cosine also Σw² (`distances_from_stats` maps them to the four
measures). `pool_distance_stats` takes the reference's flat forms, w (P,)
and pool (C, P) → (C,) each, or w (B, P) and pool (B, C, P) → (B, C);
`tree_pool_distance_stats` reads a model's leaves and a stacked pool's
(C, *shape) leaves in place, with a gradient for the model's leaves
(`PoolStatsFunction`: the members carry none, ḡnorm has no term). On CUDA
tensors both launch the hand-written kernels ``csrc/pool_distance_f32.cu``
(one forward launch, f32 or bf16 in, f32 sums that repeat bit for bit;
the backward reads the same f32 or bf16 leaves, sums in f32 and writes ∂w
in the leaves' type, a bf16 ∂w rounded once), laid out by `sweep_plan`;
on CPU tensors they take the plain versions `ref.pool_distance_stats_ref`
and `ref.pool_distance_stats_bwd_ref` (∂w in f32, rounded once to the
leaves' type).

**The factor Gram.** Pairwise member distances of a `LowRankDeltaPool`
reduce to Gram matrices over the stacked factors: with A = [U_1ᵀ; …;
U_Cᵀ] (C·r rows), ⟨Δ_i, Δ_j⟩ = ⟨U_iᵀU_j, V_iᵀV_j⟩_F reads off two A·Aᵀ
products (`core/distances.lowrank_pairwise_sq`). `factor_gram` is that
product over the long trailing axis, a (M, P) → (M, M), or a (B, M, P) →
(B, M, M), f32; `factor_gram_group` takes every stack of a call at once.
On CUDA tensors both launch ``csrc/factor_gram_f32.cu`` once for all the
stacks (f32, contiguous), laid out by `gram_plan` (its sum over P is the
same on every run: chunk partials, added in a fixed order); on CPU
tensors they take `ref.factor_gram_ref` stack by stack. The kernel takes
M ≤ `MAX_M` rows; a taller stack goes as tiles of at most
`GRAM_TILE_ROWS` rows (`gram_tiling`): the Gram of the stacked rows
[A_I; A_J] of each tile pair I < J, all in the same grouped launch, gives
A_I·A_Jᵀ as its off-diagonal block and each tile's own Gram on its
diagonal.

Nothing falls back: a CUDA tensor launches its kernel or raises."""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (factor_gram_ref,
                                     pool_distance_stats_bwd_ref,
                                     pool_distance_stats_ref)

MAX_M = 256             # rows the reference's kernel takes (C·r ≤ 256)
_MAX_GRID_X = 2 ** 31 - 1
_MAX_GRID_Y = 65535
STATS = ("sq", "l1", "dot", "norm")
# csrc/pool_distance_f32.cu: threads a block (8 warps), members a pass
# holds, leaves a launch's table takes, resident blocks an SM (its
# __launch_bounds__), and the four-element groups a thread of the
# instance for MC members a pass: the widest G whose (MC + 1)·4·G loaded
# values, all issued before a thread's first FMA, stay within 48
# registers
THREADS = 256
WARPS = THREADS // 32
ROUND = 8
MAX_MEMBERS = 63        # 4·C + 1 sums ≤ THREADS
MAX_LEAVES = 40
BLOCKS_PER_SM = 2
GROUPS = {1: 4, 2: 4, 3: 2, 4: 2, 5: 2, 6: 1, 7: 1, 8: 1}
N_SMS = 132             # H100 SXM streaming multiprocessors
# csrc/factor_gram_f32.cu: threads a block, rows a group, ring slots, floats
# a ring slot holds (its column count follows M), an item's sums (8 rows ×
# 4) and the floats between two (team, item) sums, stacks a launch's table
# holds, chunks a subgroup and subgroups a group at most; the plan's blocks
# a launch (two waves of two resident on each SM) and the counters it may
# take (one buffer from `build.counters`)
GRAM_THREADS = 256
GRAM_ROWS = 8
GRAM_STAGES = 4
GRAM_STAGE_FLOATS = 6144
GRAM_ITEM = 32
GRAM_RED_PITCH = 36
GRAM_MAX_STACKS = 32
GRAM_MAX_F = 16
GRAM_TARGET_BLOCKS = 4 * N_SMS
GRAM_COUNTERS = 1 << 16
# a stack of more than MAX_M rows goes as tiles of at most this many rows,
# two of which stack into one sub-stack the kernel takes
GRAM_TILE_ROWS = MAX_M // 2

Params = Dict[str, torch.Tensor]


class _GramStack(ctypes.Structure):
    """One entry of csrc/factor_gram_f32.cu's table (its `GramStack`)."""
    _fields_ = [("a", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("part", ctypes.c_void_p), ("part2", ctypes.c_void_p),
                ("counters", ctypes.c_void_p), ("p", ctypes.c_int64),
                ("pc", ctypes.c_int64)] + [
        (name, ctypes.c_int) for name in (
            "b", "m", "w", "pitch", "ib", "nq", "wpt", "teams", "k", "f",
            "nsub", "first_block")]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("factor_gram_f32")
    lib.factor_gram_f32.argtypes = [ctypes.POINTER(_GramStack), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.factor_gram_f32.restype = ctypes.c_int
    for name in ("factor_gram_f32_stack_bytes", "factor_gram_f32_max_stacks"):
        getattr(lib, name).restype = ctypes.c_int
    if lib.factor_gram_f32_stack_bytes() != ctypes.sizeof(_GramStack) or \
            lib.factor_gram_f32_max_stacks() != GRAM_MAX_STACKS:
        raise RuntimeError("factor_gram_f32: the library's table differs "
                           "from kernels/pool_distance.py's")
    return lib


class GramStack(NamedTuple):
    """How csrc/factor_gram_f32.cu computes one (B, M, P) stack: rows in
    `GRAM_ROWS` strided groups; item 2p + h is pair p of groups (gi ≤ gj)
    against half h of gj's rows, a thread an item, `ib` items a block and
    `nq` item groups; `teams` teams of `wpt` warps split a chunk's quads of
    4 columns (quad j to team j mod teams), staged `w` columns at a time
    in rows of `pitch` floats; P in `k` chunks of `pc` columns; a (b, item
    group) adds its chunks in subgroups of `f`, then its `nsub`
    subgroups. Its blocks start at `first_block`; its partials at `part`
    and `part2`, its counters at `counters` (offsets in the launch's
    workspace and counters)."""
    b: int
    m: int
    p: int
    w: int
    pitch: int
    ib: int
    nq: int
    wpt: int
    teams: int
    pc: int
    k: int
    f: int
    nsub: int
    first_block: int
    part: int
    part2: int
    counters: int

    @property
    def groups(self) -> int:
        """(b, item group) sums, each over all of P."""
        return self.b * self.nq

    @property
    def blocks(self) -> int:
        return self.groups * self.k

    @property
    def rows(self) -> int:
        """M padded to the groups: the rows of a ring slot."""
        return -(-self.m // GRAM_ROWS) * GRAM_ROWS

    @property
    def smem_floats(self) -> int:
        """Dynamic shared memory a block: the ring, reused for the teams'
        sums."""
        return max(GRAM_STAGES * self.rows * self.pitch,
                   self.teams * self.ib * GRAM_RED_PITCH)


class GramPlan(NamedTuple):
    """One launch of csrc/factor_gram_f32.cu: `stacks` in the caller's
    order, `order` the block order (indices into `stacks`), `grid` blocks,
    `workspace` floats of partials, `counters` ints, `smem` bytes."""
    stacks: Tuple[GramStack, ...]
    order: Tuple[int, ...]
    grid: int
    workspace: int
    counters: int
    smem: int


def _gram_items(m: int) -> int:
    """Items of an M-row Gram: two a pair of row groups gi ≤ gj."""
    groups = -(-m // GRAM_ROWS)
    return groups * (groups + 1)


@functools.lru_cache(maxsize=64)
def gram_plan(shapes: Tuple[Tuple[int, int, int], ...]) -> GramPlan:
    """The plan of one launch over stacks of `shapes` (B, M, P), a function
    of the shapes alone (so the summation order, and the bits, are too).
    The columns of all stacks over `GRAM_TARGET_BLOCKS` give a block's
    share; each stack's P goes in chunks of at most that many columns (a
    multiple of its stage width, and at least one ring of stages), so one
    launch fills the card whether it holds one large stack or many small
    ones; at most `GRAM_MAX_F`² chunks. A (b, item group) split into k > 1
    chunks has its last block add them in order where k ≤ `GRAM_MAX_F`;
    beyond, it adds them in subgroups of f = ⌈√k⌉ (each subgroup's last
    block, then the last of those), so no block adds more than
    `GRAM_MAX_F` partials. Blocks go stack by stack, the stacks with the
    most chunks first. Raises where the kernel takes no such call."""
    if not 1 <= len(shapes) <= GRAM_MAX_STACKS:
        raise ValueError(f"gram_plan: {len(shapes)} stacks; a launch takes "
                         f"1..{GRAM_MAX_STACKS}")
    stacks = []
    for b, m, p in shapes:
        if not (1 <= m <= MAX_M and b >= 1 and p >= 1):
            raise ValueError(f"gram_plan: no grid for ({b}, {m}, {p}) "
                             f"(1 ≤ M ≤ {MAX_M}, B and P ≥ 1)")
        items = _gram_items(m)
        nq = -(-items // GRAM_THREADS)
        ib = -(-items // nq)
        wpt = -(-ib // 32)
        teams = GRAM_THREADS // 32 // wpt
        # quads a stage: a multiple of the teams, within the slot's floats
        # beside a row's padding; a row's pitch an odd number of quads
        room = GRAM_STAGE_FLOATS // (-(-m // GRAM_ROWS) * GRAM_ROWS) // 4 - 2
        wq = max(1, room // teams) * teams
        stacks.append(GramStack(b, m, p, 4 * wq, 4 * (wq + 1 + wq % 2), ib,
                                nq, wpt, teams, *[0] * 8))
    share = -(-sum(st.b * st.nq * st.p for st in stacks) //
              GRAM_TARGET_BLOCKS)
    for i, st in enumerate(stacks):
        k = min(-(-st.p // share), GRAM_MAX_F ** 2)
        pc = max(-(-(-(-st.p // k)) // st.w) * st.w, GRAM_STAGES * st.w)
        k = -(-st.p // pc)
        f = k if k <= GRAM_MAX_F else math.isqrt(k - 1) + 1
        stacks[i] = st._replace(pc=pc, k=k, f=f, nsub=-(-k // f))
    order = tuple(sorted(range(len(stacks)), key=lambda i: -stacks[i].k))
    first = part = counters = 0
    for i in order:
        st = stacks[i]
        values = st.ib * GRAM_ITEM
        n_part = st.groups * st.k * values if st.k > 1 else 0
        n_part2 = st.groups * st.nsub * values if st.nsub > 1 else 0
        stacks[i] = st._replace(first_block=first, part=part,
                                part2=part + n_part, counters=counters)
        first += st.blocks
        part += n_part + n_part2
        if st.k > 1:
            counters += st.groups * (st.nsub + 1 if st.nsub > 1 else 1)
    if first > _MAX_GRID_X or counters > GRAM_COUNTERS:
        raise ValueError(f"gram_plan: {first} blocks and {counters} "
                         f"counters exceed the kernel's limits for {shapes}")
    return GramPlan(tuple(stacks), order, first, part, counters,
                    4 * max(st.smem_floats for st in stacks))


def factor_gram_f32(stacks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Launch the CUDA kernel over a list of contiguous f32 (B, M, P) CUDA
    tensors on one device; returns their (B, M, M) Grams. One launch (one
    more per `GRAM_MAX_STACKS` stacks); `factor_gram_f32.launches` counts
    them."""
    build.refuse_vmapped("factor_gram_f32", *stacks)
    if not stacks:
        return []
    device = stacks[0].device
    for i, a in enumerate(stacks):
        if a.device.type != "cuda" or a.device != device:
            raise ValueError(f"factor_gram_f32: stack {i} is on {a.device}, "
                             f"not CUDA (or not stack 0's {device})")
        if a.dtype != torch.float32:
            raise TypeError(f"factor_gram_f32: stack {i} is {a.dtype}, not "
                            "float32")
        if a.dim() != 3:
            raise ValueError(f"factor_gram_f32: stack {i} must be (B, M, P), "
                             f"got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"factor_gram_f32: stack {i} must be contiguous")
    lib = _lib()
    outs = [torch.empty((a.shape[0], a.shape[1], a.shape[1]), device=device,
                        dtype=torch.float32) for a in stacks]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for t0 in range(0, len(stacks), GRAM_MAX_STACKS):
            table = stacks[t0:t0 + GRAM_MAX_STACKS]
            plan = gram_plan(tuple(tuple(a.shape) for a in table))
            part = torch.empty(plan.workspace, device=device,
                               dtype=torch.float32)
            counters = build.counters(device, stream, GRAM_COUNTERS)
            entries = (_GramStack * len(table))()
            for slot, i in enumerate(plan.order):
                st = plan.stacks[i]
                entries[slot] = _GramStack(
                    table[i].data_ptr(), outs[t0 + i].data_ptr(),
                    part.data_ptr() + 4 * st.part,
                    part.data_ptr() + 4 * st.part2,
                    counters.data_ptr() + 4 * st.counters, st.p, st.pc, st.b,
                    st.m, st.w, st.pitch, st.ib, st.nq, st.wpt, st.teams,
                    st.k, st.f, st.nsub, st.first_block)
            err = lib.factor_gram_f32(entries, len(table), plan.grid,
                                      plan.smem, stream)
            if err != 0:
                raise RuntimeError(f"factor_gram_f32: launch failed with "
                                   f"CUDA error {err}")
            build.count_launches(factor_gram_f32)
    return outs


factor_gram_f32.launches = 0


class GramTiling(NamedTuple):
    """How a stack of M > `MAX_M` rows goes through the kernel: row
    `tiles` (lo, hi) of at most `GRAM_TILE_ROWS` rows each, and one
    sub-stack [A_I; A_J] per tile pair (I, J) of `pairs` (I < J). The
    off-diagonal block (I, J) is read from pair (I, J)'s Gram; tile I's
    diagonal block from the pair `diag[I]` (which holds I)."""
    tiles: Tuple[Tuple[int, int], ...]
    pairs: Tuple[Tuple[int, int], ...]
    diag: Tuple[int, ...]


@functools.lru_cache(maxsize=64)
def gram_tiling(m: int) -> GramTiling:
    """The tiling of an M-row stack, M > `MAX_M`: ⌈M / 128⌉ tiles of
    near-equal rows, every pair I < J of them once (so each block of the
    upper triangle, the diagonal ones taken from the first pair that holds
    them, is computed in exactly one place the result reads)."""
    if m <= MAX_M:
        raise ValueError(f"gram_tiling: M = {m} needs no tiles "
                         f"(the kernel takes M ≤ {MAX_M})")
    n = -(-m // GRAM_TILE_ROWS)
    cuts = [i * m // n for i in range(n + 1)]
    tiles = tuple(zip(cuts[:-1], cuts[1:]))
    pairs = tuple((i, j) for i in range(n) for j in range(i + 1, n))
    diag = tuple(next(p for p, (i, j) in enumerate(pairs) if t in (i, j))
                 for t in range(n))
    return GramTiling(tiles, pairs, diag)


def gram_substacks(shapes: Sequence[Tuple[int, int, int]]
                   ) -> List[Tuple[int, Tuple[int, int], Tuple[int, int, int]]]:
    """The stacks the kernel takes for a call over stacks of `shapes`
    (B, M, P): (stack index, tile pair or (-1, -1) for a whole stack of M ≤
    `MAX_M`, sub-stack shape), in launch order."""
    out = []
    for i, (b, m, p) in enumerate(shapes):
        if m <= MAX_M:
            out.append((i, (-1, -1), (b, m, p)))
            continue
        tiling = gram_tiling(m)
        for ti, tj in tiling.pairs:
            rows = sum(hi - lo for lo, hi in (tiling.tiles[ti],
                                              tiling.tiles[tj]))
            out.append((i, (ti, tj), (b, rows, p)))
    return out


def gram_launches(shapes: Sequence[Tuple[int, int, int]]) -> int:
    """Kernel launches of one call over stacks of `shapes`: one per
    `GRAM_MAX_STACKS` sub-stacks."""
    return -(-len(gram_substacks(shapes)) // GRAM_MAX_STACKS)


def tiled_grams(stacks: Sequence[torch.Tensor], gram_fn) -> List[torch.Tensor]:
    """Each (B, M, P) stack's Gram through `gram_fn` (a list of stacks of
    at most `MAX_M` rows → their Grams, the kernel's call): stacks of M ≤
    `MAX_M` whole, taller ones as `gram_tiling`'s sub-stacks, all in one
    call; the blocks of a tiled Gram are put together with its lower
    triangle the exact transpose of its upper one."""
    subs = gram_substacks([tuple(a.shape) for a in stacks])
    inputs = []
    for i, (ti, tj), _ in subs:
        a = stacks[i]
        if ti < 0:
            inputs.append(a)
        else:
            t = gram_tiling(a.shape[1]).tiles
            inputs.append(torch.cat([a[:, t[ti][0]:t[ti][1]],
                                     a[:, t[tj][0]:t[tj][1]]], 1))
    grams = gram_fn(inputs)
    outs: List[torch.Tensor] = [None] * len(stacks)
    for (i, (ti, tj), _), g in zip(subs, grams):
        if ti < 0:
            outs[i] = g
            continue
        a = stacks[i]
        m = a.shape[1]
        if outs[i] is None:
            outs[i] = torch.empty((a.shape[0], m, m), device=a.device,
                                  dtype=torch.float32)
        tiling = gram_tiling(m)
        (li, hi_i), (lj, hj) = tiling.tiles[ti], tiling.tiles[tj]
        mi = hi_i - li
        out = outs[i]
        block = g[:, :mi, mi:]
        out[:, li:hi_i, lj:hj] = block
        out[:, lj:hj, li:hi_i] = block.transpose(1, 2)
        pair = tiling.pairs.index((ti, tj))
        if tiling.diag[ti] == pair:
            out[:, li:hi_i, li:hi_i] = g[:, :mi, :mi]
        if tiling.diag[tj] == pair:
            out[:, lj:hj, lj:hj] = g[:, mi:, mi:]
    return outs


def factor_gram_group(stacks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A·Aᵀ over the trailing axis of every (B, M, P) stack, routed by the
    tensors' device: the kernel for CUDA stacks, one launch for all of
    them (`tiled_grams`: a stack of M > `MAX_M` rows as tile pairs in the
    same launch; one launch more per `GRAM_MAX_STACKS` sub-stacks); the
    plain version stack by stack for CPU stacks."""
    route = _device_type(stacks, "factor_gram_group") if stacks else "cpu"
    if route == "cuda":
        return tiled_grams(stacks, factor_gram_f32)
    if route == "cpu":
        return [factor_gram_ref(a) for a in stacks]
    raise ValueError(f"factor_gram_group: no route for tensors on {route}")


def factor_gram(a: torch.Tensor) -> torch.Tensor:
    """A·Aᵀ over the trailing axis, (M, P) → (M, M) or (B, M, P) →
    (B, M, M), routed by the tensor's device: the kernel on CUDA, the
    plain version on the CPU."""
    if a.dim() == 2:
        return factor_gram(a[None])[0]
    return factor_gram_group([a])[0]


# ---------------------------------------------------------------------------
# The pool-distance statistics sweep
# ---------------------------------------------------------------------------

@functools.cache
def _sweep_lib() -> ctypes.CDLL:
    lib = build.load("pool_distance_f32")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    ptrs, ints = ctypes.POINTER(p), ctypes.POINTER(i64)
    lib.pool_distance_f32.argtypes = [ptrs, ptrs, ints, ints, ints, ints, i,
                                      i, i, i, i, i64, p, p, p, i64, p, p,
                                      ctypes.POINTER(i)]
    lib.pool_distance_f32.restype = i
    lib.pool_distance_bwd_f32.argtypes = [ptrs, ptrs, ptrs, ints, ints, ints,
                                          ints, ints, i, i, i, i, i, i64, p,
                                          p, p, ctypes.POINTER(i)]
    lib.pool_distance_bwd_f32.restype = i
    return lib


class SweepPlan(NamedTuple):
    """How csrc/pool_distance_f32.cu runs a call over C members: passes of
    min(C, `ROUND`) members, `groups` four-element groups a thread, so a
    chunk is `chunk` = 1,024·`groups` elements of a leaf;
    `blocks[i]` chunks for leaf i. The non-empty leaves go in tables of
    `MAX_LEAVES`, one launch each, whose grid is (min(its chunks, `grid`),
    B): block j walks the chunks j, j + grid, … of its table and leaves one
    partial slot a run (the forward's)."""
    members: int
    groups: int
    chunk: int
    blocks: Tuple[int, ...]
    grid: int

    @property
    def total_blocks(self) -> int:
        """Chunks over all leaves."""
        return sum(self.blocks)

    @property
    def tables(self) -> List[int]:
        """The chunks of each launch's table."""
        live = [n for n in self.blocks if n]
        return [sum(live[i:i + MAX_LEAVES])
                for i in range(0, len(live), MAX_LEAVES)]

    def grids(self, b: int) -> List[Tuple[int, int]]:
        """(x, y) of each launch: its blocks, the runs."""
        return [(min(n, self.grid), b) for n in self.tables]

    @property
    def slots(self) -> int:
        """The forward's partial slots a run: its blocks over all launches."""
        return sum(x for x, _ in self.grids(1))

    @property
    def chunks_per_block(self) -> int:
        """The most chunks a block walks."""
        return max(-(-n // x) for n, (x, _) in zip(self.tables,
                                                   self.grids(1)))

    def workspace(self, b: int) -> int:
        """Floats of the forward's partials, (B, 4C + 1, slots)."""
        return b * (4 * self.members + 1) * self.slots

    @property
    def chain(self) -> int:
        """The longest run of dependent f32 roundings in one of the
        forward's sums: 2 to form a term (w − m, then its square or
        product), 4·G adds a chunk over the most chunks a block walks, 5
        shuffle levels of a warp, 7 adds of the 8 warps, ⌈slots/32⌉ adds of
        a lane of the tail's warp, then its 5 shuffle levels. An f32 sum
        whose longest chain is L lies within L·2⁻²⁴·Σ|terms| of the exact
        sum."""
        return (2 + 4 * self.groups * self.chunks_per_block + 5 +
                (WARPS - 1) + -(-self.slots // 32) + 5)


def sweep_plan(c: int, sizes: Sequence[int], esz: int) -> SweepPlan:
    """The plan of a sweep over C members and leaves of `sizes` elements
    of `esz` bytes (4 f32, 2 bf16; the plan is the same for both): one
    resident wave of blocks (`BLOCKS_PER_SM` on each of the 132 SMs) that
    walk the chunks, so a block pays its reduction once, and the
    instance's `GROUPS` a thread. Raises where the kernels take no such
    call."""
    if not 1 <= c <= MAX_MEMBERS:
        raise ValueError(f"sweep_plan: C = {c} is outside 1..{MAX_MEMBERS}")
    if esz not in (2, 4):
        raise ValueError(f"sweep_plan: {esz}-byte elements; the kernels "
                         "read f32 or bf16")
    if any(n < 0 for n in sizes) or not any(sizes):
        raise ValueError(f"sweep_plan: no elements in leaves {list(sizes)}")
    mc = min(c, ROUND)
    groups = GROUPS[mc]
    chunk = 4 * THREADS * groups
    return SweepPlan(c, groups, chunk,
                     tuple(-(-n // chunk) for n in sizes),
                     BLOCKS_PER_SM * N_SMS)


def _table(ws: Sequence[torch.Tensor], ms: Sequence[torch.Tensor],
           name: str) -> Tuple[int, int, torch.dtype]:
    """Check a leaf table: every w (B, n_i) and m (B, C, n_i) on one CUDA
    device, of one dtype, unit stride along n_i; returns (B, C, dtype)."""
    if not ws or len(ws) != len(ms):
        raise ValueError(f"{name}: {len(ws)} w leaves and {len(ms)} member "
                         "leaves")
    device, dtype = ws[0].device, ws[0].dtype
    b, c = ms[0].shape[:2]
    for i, (w, m) in enumerate(zip(ws, ms)):
        for what, t in (("w", w), ("members", m)):
            if t.device.type != "cuda" or t.device != device:
                raise ValueError(f"{name}: {what} of leaf {i} is on "
                                 f"{t.device}, leaf 0's w on {device}")
            if t.dtype != dtype:
                raise TypeError(f"{name}: {what} of leaf {i} is {t.dtype}, "
                                f"leaf 0's w {dtype}")
            if t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f"{name}: {what} of leaf {i} is not "
                                 "contiguous along its elements")
        if w.dim() != 2 or m.dim() != 3 or m.shape != (b, c, w.shape[1]) \
                or w.shape[0] != b:
            raise ValueError(f"{name}: leaf {i} has w {tuple(w.shape)} and "
                             f"members {tuple(m.shape)}; expected (B, n) and "
                             f"({b}, {c}, n)")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: {dtype} is not float32 or bfloat16")
    if not 1 <= c <= MAX_MEMBERS or \
            not 1 <= b <= _MAX_GRID_Y or sum(w.shape[1] for w in ws) == 0:
        raise ValueError(f"{name}: no grid for B = {b}, C = {c} and "
                         f"{sum(w.shape[1] for w in ws)} elements")
    return b, c, dtype


def _strides(ws, ms):
    n = len(ws)
    i64 = ctypes.c_int64 * n
    return (i64(*[w.shape[1] for w in ws]), i64(*[w.stride(0) for w in ws]),
            i64(*[m.stride(0) for m in ms]), i64(*[m.stride(1) for m in ms]))


def pool_distance_f32(ws: Sequence[torch.Tensor], ms: Sequence[torch.Tensor]
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the forward sweep over a table of leaves: leaf i's w (B, n_i)
    and its members (B, C, n_i), CUDA tensors of one dtype (f32 or bf16)
    with unit stride along n_i (the other strides are free). Returns the
    statistics (B, 4, C) f32 — rows sq, l1, dot, norm — and Σw² (B,) f32.
    One launch (one more per 40 leaves); `pool_distance_f32.launches`
    counts them."""
    build.refuse_vmapped("pool_distance_f32", *ws, *ms)
    b, c, dtype = _table(ws, ms, "pool_distance_f32")
    lib = _sweep_lib()
    plan = sweep_plan(c, [w.shape[1] for w in ws], ws[0].element_size())
    dev = ws[0].device
    stats = torch.empty((b, 4, c), device=dev, dtype=torch.float32)
    wsq = torch.empty((b,), device=dev, dtype=torch.float32)
    part = torch.empty(plan.workspace(b), device=dev, dtype=torch.float32)
    ptrs = ctypes.c_void_p * len(ws)
    launches = ctypes.c_int(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        counters = build.counters(dev, stream, _MAX_GRID_Y)
        err = lib.pool_distance_f32(
            ptrs(*[w.data_ptr() for w in ws]),
            ptrs(*[m.data_ptr() for m in ms]), *_strides(ws, ms), len(ws),
            b, c, int(dtype == torch.bfloat16), plan.groups, plan.grid,
            stats.data_ptr(), wsq.data_ptr(), part.data_ptr(), part.numel(),
            counters.data_ptr(), stream, ctypes.byref(launches))
    build.count_launches(pool_distance_f32, launches.value)
    if err != 0:
        raise RuntimeError(f"pool_distance_f32: launch failed with CUDA error "
                           f"{err}")
    return stats, wsq


pool_distance_f32.launches = 0


def pool_distance_bwd_f32(ws: Sequence[torch.Tensor],
                          ms: Sequence[torch.Tensor], g_stats: torch.Tensor,
                          g_wsq: torch.Tensor) -> List[torch.Tensor]:
    """Launch the backward sweep over the same table (f32 or bf16 leaves):
    ∂w_i (B, n_i) = 2Σ_t ḡsq_t·(w − m_t) + Σ_t ḡl1_t·s(w − m_t) +
    Σ_t ḡdot_t·m_t + 2·ḡwsq·w, summed in f32 and returned in the leaves'
    dtype (a bf16 ∂w rounded once), with ḡ read from device memory:
    g_stats (B, 4, C) (row 3, ḡnorm, is not read) and g_wsq (B,).
    `pool_distance_bwd_f32.launches` counts the launches."""
    build.refuse_vmapped("pool_distance_bwd_f32", *ws, *ms, g_stats, g_wsq)
    b, c, dtype = _table(ws, ms, "pool_distance_bwd_f32")
    dev = ws[0].device
    g_stats = g_stats.to(device=dev, dtype=torch.float32).contiguous()
    g_wsq = g_wsq.to(device=dev, dtype=torch.float32).contiguous()
    if g_stats.shape != (b, 4, c) or g_wsq.shape != (b,):
        raise ValueError(f"pool_distance_bwd_f32: ḡ is {tuple(g_stats.shape)}"
                         f" and {tuple(g_wsq.shape)}; expected ({b}, 4, {c}) "
                         f"and ({b},)")
    outs = [torch.empty(w.shape, device=dev, dtype=dtype) for w in ws]
    n = len(ws)
    ptrs = ctypes.c_void_p * n
    launches = ctypes.c_int(0)
    lib = _sweep_lib()
    plan = sweep_plan(c, [w.shape[1] for w in ws], ws[0].element_size())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        sizes, w_run, m_run, m_member = _strides(ws, ms)
        err = lib.pool_distance_bwd_f32(
            ptrs(*[w.data_ptr() for w in ws]),
            ptrs(*[m.data_ptr() for m in ms]),
            ptrs(*[o.data_ptr() for o in outs]), sizes, w_run, m_run,
            m_member, (ctypes.c_int64 * n)(*[o.stride(0) for o in outs]), n,
            b, c, int(dtype == torch.bfloat16), plan.groups, plan.grid,
            g_stats.data_ptr(), g_wsq.data_ptr(), stream,
            ctypes.byref(launches))
    build.count_launches(pool_distance_bwd_f32, launches.value)
    if err != 0:
        raise RuntimeError(f"pool_distance_bwd_f32: launch failed with CUDA "
                           f"error {err}")
    return outs


pool_distance_bwd_f32.launches = 0


def _device_type(tensors: Sequence[torch.Tensor], name: str) -> str:
    types = {t.device.type for t in tensors}
    if len(types) != 1:
        raise ValueError(f"{name}: tensors on mixed devices {sorted(types)}")
    return types.pop()


def pool_distance_stats(w_flat: torch.Tensor,
                        pool_flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Fused per-member statistics, single-run or batched:

    * w_flat (P,), pool_flat (C, P)        → stats each (C,)
    * w_flat (B, P), pool_flat (B, C, P)   → stats each (B, C)

    Returns a dict of f32 stats: sq, l1, dot, norm. CUDA: one launch of
    the sweep; CPU: `ref.pool_distance_stats_ref`."""
    if w_flat.dim() == 1:
        stats = pool_distance_stats(w_flat[None], pool_flat[None])
        return {k: v[0] for k, v in stats.items()}
    if w_flat.dim() != 2 or pool_flat.dim() != 3 or \
            pool_flat.shape[::2] != w_flat.shape:
        raise ValueError(f"pool_distance_stats: w {tuple(w_flat.shape)} and "
                         f"pool {tuple(pool_flat.shape)}; expected (P,) and "
                         "(C, P), or (B, P) and (B, C, P)")
    route = _device_type((w_flat, pool_flat), "pool_distance_stats")
    if route == "cuda":
        stats, _ = pool_distance_f32([w_flat], [pool_flat])
        return dict(zip(STATS, stats.unbind(1)))
    if route == "cpu":
        return pool_distance_stats_ref(w_flat, pool_flat)
    raise ValueError(f"pool_distance_stats: no route for tensors on {route}")


def distances_from_stats(stats: Dict[str, torch.Tensor], w_sq_norm,
                         measure: str) -> torch.Tensor:
    """Per-member distances from the stats. w_sq_norm = Σw²: a scalar for
    (C,) stats, (B,) for batched (B, C) stats."""
    if measure == "l2":
        return torch.sqrt(stats["sq"] + 1e-12)
    if measure == "squared_l2":
        return stats["sq"]
    if measure == "l1":
        return stats["l1"]
    if measure == "cosine":
        w_sq = torch.as_tensor(w_sq_norm, dtype=torch.float32,
                               device=stats["dot"].device)
        if stats["dot"].dim() == 2 and w_sq.dim() == 1:
            w_sq = w_sq[:, None]              # (B,) → (B, 1) vs (B, C)
        return 1.0 - stats["dot"] / (
            torch.sqrt(w_sq + 1e-12) * torch.sqrt(stats["norm"] + 1e-12))
    raise ValueError(measure)


def _leaf_table(w: Sequence[torch.Tensor], members: Sequence[torch.Tensor]):
    """Run-stacked leaves as the kernels' table: leaf i's w (R, n_i) and
    members (R, C, n_i), views where the layout allows it."""
    return ([x.reshape(x.shape[0], -1) for x in w],
            [m.reshape(m.shape[0], m.shape[1], -1) for m in members])


def _fold_runs(x: torch.Tensor, bdim, size: int) -> torch.Tensor:
    """vmap's physical run-stacked leaf (R, …) as (size·R, …): its vmapped
    axis first (a leaf vmap does not map is shared, run stride 0), folded
    into the run axis."""
    x = x.movedim(bdim, 0) if bdim is not None else x.expand(size, *x.shape)
    return x.flatten(0, 1)


def _dtype_groups(ws: Sequence[torch.Tensor]) -> List[List[int]]:
    """The table's leaf indices by dtype, each dtype's group in leaf order,
    the groups in the order of their first leaf: the sweep's kernels read
    one leaf dtype a launch, and a bf16 SSM model keeps some leaves in f32
    (A_log, dt_bias, D; w_decay_base, bonus_u)."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, w in enumerate(ws):
        groups.setdefault(w.dtype, []).append(i)
    return list(groups.values())


class PoolStatsFunction(torch.autograd.Function):
    """(members, *w) → (stats (R, 4, C), Σw² (R,)) over R runs: w leaves
    (R, *shape), members (R, C, *shape) (any run stride; 0 for members
    the runs share), with a gradient for the w leaves. Routed by the
    tensors' device: the forward and backward kernels on CUDA, one launch
    each for all R runs and each leaf dtype (a table of bf16 and f32
    leaves sums its two forward launches' stats, in f32, in the order of
    `_dtype_groups`); the plain versions on the CPU. Under
    `torch.func.vmap` its rule (`vmap`) folds vmap's axis into the run
    axis and applies the Function to the run-stacked leaves, so the B runs
    of a batched step take one forward launch, and autograd, on the
    stacked tensors, one backward launch."""
    generate_vmap_rule = False

    @staticmethod
    def forward(members, *w):
        route = _device_type(list(w) + list(members),
                             "tree_pool_distance_stats")
        ws, ms = _leaf_table(w, members)
        if route == "cuda":
            out = None
            for idx in _dtype_groups(ws):
                stats, wsq = pool_distance_f32([ws[i] for i in idx],
                                               [ms[i] for i in idx])
                out = (stats, wsq) if out is None else \
                    (out[0] + stats, out[1] + wsq)
            return out
        if route == "cpu":
            parts = [pool_distance_stats_ref(x, m) for x, m in zip(ws, ms)]
            stats = torch.stack([sum(p[k] for p in parts) for k in STATS],
                                dim=1)
            wsq = sum(x.float().square().sum(-1) for x in ws)
            return stats, wsq
        raise ValueError(f"tree_pool_distance_stats: no route for tensors "
                         f"on {route}")

    @staticmethod
    def setup_context(ctx, inputs, output):
        members, *w = inputs
        ctx.route = _device_type(w, "tree_pool_distance_stats")
        ctx.save_for_backward(*w, *members)

    @staticmethod
    def backward(ctx, g_stats, g_wsq):
        saved = ctx.saved_tensors
        n = len(saved) // 2
        w = saved[:n]
        ws, ms = _leaf_table(w, saved[n:])
        if ctx.route == "cuda":
            grads = [None] * len(ws)
            for idx in _dtype_groups(ws):
                for i, g in zip(idx, pool_distance_bwd_f32(
                        [ws[i] for i in idx], [ms[i] for i in idx], g_stats,
                        g_wsq)):
                    grads[i] = g
        else:
            grads = [pool_distance_stats_bwd_ref(
                x, m, g_stats[:, 0], g_stats[:, 1], g_stats[:, 2],
                g_wsq=g_wsq) for x, m in zip(ws, ms)]
        return (None,) + tuple(g.reshape(x.shape).to(x.dtype)
                               for g, x in zip(grads, w))

    @staticmethod
    def vmap(info, in_dims, members, *w):
        size = info.batch_size
        m_dims, *w_dims = in_dims
        stats, wsq = PoolStatsFunction.apply(
            tuple(_fold_runs(m, d, size) for m, d in zip(members, m_dims)),
            *(_fold_runs(x, d, size) for x, d in zip(w, w_dims)))
        return ((stats.reshape(size, -1, *stats.shape[1:]),
                 wsq.reshape(size, -1)), (0, 0))


def tree_pool_distance_stats(params: Params, members: Params
                             ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The sweep over a model's leaves, read in place: `params` name →
    tensor, `members` name → (C, *shape) stack (a pool's members, or a
    one-member view of its anchor). Returns the stats dict (sq, l1, dot,
    norm; each (C,) f32) and Σw² (f32 scalar), differentiable in `params`
    (the members are detached). Under `torch.func.vmap` over B runs'
    params and pools it is one forward and one backward launch for all B
    (`PoolStatsFunction.vmap`)."""
    names = list(params)
    if set(members) != set(names):
        raise ValueError(f"tree_pool_distance_stats: the members' leaves "
                         f"{sorted(members)} are not the model's "
                         f"{sorted(names)}")
    stats, wsq = PoolStatsFunction.apply(
        tuple(members[k].detach()[None] for k in names),
        *(params[k][None] for k in names))
    return dict(zip(STATS, stats[0].unbind(0))), wsq[0]
