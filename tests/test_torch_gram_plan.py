"""The factor-Gram kernel's launch plan and summation order
(`kernels.pool_distance.gram_plan`, ``csrc/factor_gram_f32.cu``), on the
CPU.

* (a) `gram_plan`: every (stack, b, column) lies in exactly one chunk of
  one block; every element of a Gram's triangle is summed by exactly one
  item (a pair of row groups against half of the second group's rows) and
  written with its mirror; blocks, partials and counters are laid out end
  to end; the full-width llama3.2-1b pool's 20 stacks (and each large one
  alone) fill the H100's 132 SMs; a block's shared memory fits the card,
  two blocks an SM at M = 40; shapes the kernel takes no grid for raise.
* (b) A numpy emulation of the kernel's fixed summation order (each
  team's quads of columns in order, the teams in order, a chunk's partials
  in order, then the subgroups), every product-add one f32 FMA, held to
  `ref.factor_gram_ref` within P·2⁻²³·(|A|·|A|ᵀ) elementwise and 1e-5
  normwise (phase 10's bounds), symmetric bit for bit, and to the JAX
  package's `factor_gram` (interpret mode) and `lowrank_pairwise_sq` on
  the same numpy inputs to 1e-5.
* (c) The grouped route on CPU tensors (`factor_gram_group`, the default
  of `core.distances.lowrank_pairwise_sq`) is bitwise the per-stack one;
  the kernel's wrapper refuses CPU tensors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as JD
from repro.core.pool import LowRankDeltaPool as JaxLowRankPool
from repro.kernels.pool_distance import factor_gram as jax_factor_gram
from repro_torch.convert import from_jax_pool
from repro_torch.core import distances as TD
from repro_torch.kernels import pool_distance as TPD
from repro_torch.kernels.ref import factor_gram_ref

torch.set_num_threads(2)

N_SMS = 132
SMEM_PER_SM = 233_472        # H100: 228 KB of shared memory an SM
SMEM_PER_BLOCK = 232_448     # 227 KB a block, dynamic
STATIC_SMEM = 3_088          # the kernel's static shared memory (ptxas)
# the full-width llama3.2-1b pool's stacks (C·r = 40 rows), as
# lowrank_pairwise_sq hands them over: (B, M, P)
POOL = ([(1, 40, 128256), (1, 40, 2048)] + [(16, 40, 2048)] * 9 +
        [(16, 40, 512)] * 2 + [(16, 40, 8192)] * 3 + [(1, 40, 16)] * 2 +
        [(1, 40, 2048)] * 2)
TABLES = {
    "pool": POOL,
    "embed": [(1, 40, 128256)],
    "layer8192": [(16, 40, 8192)],
    "every_m": [(2, m, p) for m in (1, 8, 40, 64, 65, 256)
                for p in (2048, 3001)],
    "ragged": [(3, 40, 3001), (1, 24, 5000), (2, 40, 16)],
    "deep": [(1, 40, 400_000)],
}


def _items(m):
    """(gi, gj, h) of every item of an M-row Gram, in item order."""
    ng = -(-m // TPD.GRAM_ROWS)
    pairs = [(gi, gj) for gi in range(ng) for gj in range(gi, ng)]
    return [(gi, gj, h) for gi, gj in pairs for h in (0, 1)], ng


def _item_elements(m, gi, gj, h, ng):
    """The elements the kernel writes for one item: (i, j) on or above the
    diagonal and its mirror, as csrc's write_out."""
    out = []
    for x in range(TPD.GRAM_ROWS):
        for yy in range(TPD.GRAM_ROWS // 2):
            y = TPD.GRAM_ROWS // 2 * h + yy
            i, j = gi + ng * x, gj + ng * y
            if i >= m or j >= m or (gi == gj and x > y):
                continue
            out.append((min(i, j), max(i, j)))
    return out


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", sorted(TABLES))
def test_plan_covers_every_column_and_element_once(table):
    shapes = tuple(TABLES[table])
    plan = TPD.gram_plan(shapes)
    assert sorted(plan.order) == list(range(len(shapes)))
    first = 0
    for i in plan.order:                 # blocks end to end, in block order
        st = plan.stacks[i]
        assert st.first_block == first
        first += st.blocks
    assert plan.grid == first
    for (b, m, p), st in zip(shapes, plan.stacks):
        assert (st.b, st.m, st.p) == (b, m, p)
        # columns: k chunks of pc, a whole number of stages, tile [0, P)
        assert st.pc % st.w == 0 and st.pc >= TPD.GRAM_STAGES * st.w
        assert (st.k - 1) * st.pc < p <= st.k * st.pc
        assert st.k <= TPD.GRAM_MAX_F ** 2
        assert st.f <= TPD.GRAM_MAX_F and st.nsub <= TPD.GRAM_MAX_F
        assert (st.nsub == 1) == (st.k <= TPD.GRAM_MAX_F)
        assert (st.nsub - 1) * st.f < st.k <= st.nsub * st.f
        # a stage: whole quads for every team; a row's pitch an odd number
        # of quads (the warp's quad loads on distinct banks)
        assert st.w % (4 * st.teams) == 0 and (st.pitch // 4) % 2 == 1
        assert st.pitch >= st.w + 4
        assert st.rows * st.pitch <= TPD.GRAM_STAGE_FLOATS
        # items: item groups of ib, teams of wpt warps within 256 threads
        items, ng = _items(m)
        assert (st.nq - 1) * st.ib < len(items) <= st.nq * st.ib
        assert st.wpt * 32 >= st.ib and st.teams * st.wpt * 32 <= 256
        written = [e for it in items for e in _item_elements(m, *it, ng)]
        assert sorted(written) == [(i, j) for i in range(m)
                                   for j in range(i, m)]


@pytest.mark.parametrize("table", sorted(TABLES))
def test_plan_lays_partials_and_counters_end_to_end(table):
    plan = TPD.gram_plan(tuple(TABLES[table]))
    part = counters = 0
    for i in plan.order:
        st = plan.stacks[i]
        values = st.ib * TPD.GRAM_ITEM
        n_part = st.groups * st.k * values if st.k > 1 else 0
        n_part2 = st.groups * st.nsub * values if st.nsub > 1 else 0
        assert (st.part, st.part2, st.counters) == (part, part + n_part,
                                                    counters)
        part += n_part + n_part2
        if st.k > 1:
            counters += st.groups * (st.nsub + (st.nsub > 1))
    assert (plan.workspace, plan.counters) == (part, counters)
    assert plan.counters <= TPD.GRAM_COUNTERS


def test_plan_fills_the_card():
    """The full-width pool's call and its largest stacks alone each put
    at least a block on every SM; at M = 40 two blocks fit an SM, so the
    pool's call is about two resident waves."""
    for table in ("pool", "embed", "layer8192"):
        assert TPD.gram_plan(tuple(TABLES[table])).grid >= N_SMS
    plan = TPD.gram_plan(tuple(POOL))
    assert 2 * (plan.smem + STATIC_SMEM) <= SMEM_PER_SM
    assert 2 * 2 * N_SMS <= plan.grid <= 4 * 2 * N_SMS
    for table in TABLES:
        assert TPD.gram_plan(tuple(TABLES[table])).smem <= SMEM_PER_BLOCK


def test_plan_is_a_function_of_the_shapes():
    shapes = tuple(POOL)
    assert TPD.gram_plan(shapes) == TPD.gram_plan.__wrapped__(shapes)
    assert TPD.gram_plan(shapes[:1]) == TPD.gram_plan(((1, 40, 128256),))


@pytest.mark.parametrize("shapes", [
    ((1, 0, 5),), ((1, 257, 5),), ((0, 40, 5),), ((1, 40, 0),),
    ((1, 40, 5),) * (TPD.GRAM_MAX_STACKS + 1), ()])
def test_plan_refuses_what_the_kernel_does_not_take(shapes):
    with pytest.raises(ValueError, match="gram_plan"):
        TPD.gram_plan(shapes)


# ---------------------------------------------------------------------------
# (b) the summation order
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    """f32 a·b + c, the product exact and the sum rounded to f32 (through
    f64: one rounding more than the card's FMA in rare ties)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _emulate_stack(a, st):
    """G (B, M, M) of one stack as the kernel sums it under plan entry
    `st`."""
    b, m, p = a.shape
    t = st.teams
    out = np.empty((b, m, m), np.float32)
    for bi in range(b):
        chunks = []
        for ck in range(st.k):
            cols = a[bi, :, ck * st.pc:min(p, (ck + 1) * st.pc)]
            n_quads = -(-cols.shape[1] // 4)
            cols = np.pad(cols, ((0, 0), (0, 4 * n_quads - cols.shape[1])))
            acc = np.zeros((t, m, m), np.float32)
            for r in range(-(-n_quads // t)):   # team u takes quad r·t + u
                live = [u for u in range(t) if r * t + u < n_quads]
                for c in range(4):
                    x = cols[:, [4 * (r * t + u) + c for u in live]].T
                    acc[live] = _fma(x[:, :, None], x[:, None, :],
                                     acc[live])
            s = acc[0]
            for u in range(1, t):
                s = (s + acc[u]).astype(np.float32)
            chunks.append(s)
        subs = []
        for lo in range(0, st.k, st.f):
            s = chunks[lo]
            for c in chunks[lo + 1:lo + st.f]:
                s = (s + c).astype(np.float32)
            subs.append(s)
        s = subs[0]
        for c in subs[1:]:
            s = (s + c).astype(np.float32)
        out[bi] = s
    return out


def _emulate_group(stacks):
    """The grouped call, one launch's plan over every stack."""
    plan = TPD.gram_plan(tuple(tuple(a.shape) for a in stacks))
    return [torch.from_numpy(_emulate_stack(a.numpy(), st))
            for a, st in zip(stacks, plan.stacks)]


def _within_phase10_bounds(a, got):
    want = factor_gram_ref(torch.from_numpy(a)).double().numpy()
    aa = np.abs(a.astype(np.float64))
    bound = a.shape[-1] * 2.0 ** -23 * np.einsum("bmp,bnp->bmn", aa, aa)
    err = np.abs(got.astype(np.float64) - want)
    return (bool(np.all(err <= bound)),
            float(np.linalg.norm(err) / np.linalg.norm(want)))


@pytest.mark.parametrize("shape", [(1, 40, 20000), (3, 40, 3001),
                                   (2, 65, 777), (1, 256, 300),
                                   (2, 8, 100), (1, 1, 50), (16, 40, 512)])
def test_emulated_order_within_phase10_bounds(shape):
    a = np.random.default_rng(sum(shape)).normal(
        0, 0.05, shape).astype(np.float32)
    st = TPD.gram_plan((shape,)).stacks[0]
    got = _emulate_stack(a, st)
    within, rel = _within_phase10_bounds(a, got)
    assert within and rel <= 1e-5
    assert np.array_equal(got, got.transpose(0, 2, 1))
    want = np.asarray(jax_factor_gram(jnp.asarray(a), interpret=True))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_emulated_two_level_sum_within_bounds():
    """A stack split into more than `GRAM_MAX_F` chunks adds them in
    subgroups, then the subgroups."""
    shape = (1, 40, 400_000)
    st = TPD.gram_plan((shape,)).stacks[0]
    assert st.k > TPD.GRAM_MAX_F and st.nsub > 1
    a = np.random.default_rng(7).normal(0, 0.05, shape).astype(np.float32)
    within, rel = _within_phase10_bounds(a, _emulate_stack(a, st))
    assert within and rel <= 1e-5


@pytest.fixture(scope="module")
def lowrank_pool():
    """A low-rank pool of 5 members, rank 4, over two matrix leaves, one
    with a lead axis, and a vector leaf (dense residuals)."""
    rng = np.random.default_rng(11)
    base = {"w": rng.normal(size=(96, 80)).astype(np.float32),
            "layers": rng.normal(size=(3, 64, 48)).astype(np.float32),
            "b": rng.normal(size=(80,)).astype(np.float32)}
    jpool = JaxLowRankPool.create({k: jnp.asarray(v) for k, v in
                                   base.items()}, capacity=5, rank=4)
    for s in range(1, 5):
        jpool = jpool.append({k: jnp.asarray(
            v + 0.1 * np.random.default_rng(s).normal(size=v.shape)
            .astype(np.float32)) for k, v in base.items()})
    return jpool


def test_emulated_grouped_call_in_pairwise_distances(lowrank_pool,
                                                     monkeypatch):
    """`lowrank_pairwise_sq`'s default route with every stack through the
    emulated grouped call, against the JAX reference to 1e-5."""
    tpool = from_jax_pool(lowrank_pool, "cpu")
    monkeypatch.setattr(TD, "factor_gram_group", _emulate_group)
    got = TD.lowrank_pairwise_sq(tpool).numpy()
    want = np.asarray(JD.lowrank_pairwise_sq(lowrank_pool))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# (c) the CPU route
# ---------------------------------------------------------------------------

def test_grouped_cpu_route_is_the_per_stack_one(lowrank_pool):
    rng = np.random.default_rng(5)
    stacks = [torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for s in [(1, 40, 700), (3, 24, 300), (2, 5, 77)]]
    grouped = TPD.factor_gram_group(stacks)
    for a, g in zip(stacks, grouped):
        assert torch.equal(g, TPD.factor_gram(a))
        assert torch.equal(g, factor_gram_ref(a))
    assert TPD.factor_gram_group([]) == []
    tpool = from_jax_pool(lowrank_pool, "cpu")
    launches = TPD.factor_gram_f32.launches
    assert torch.equal(TD.lowrank_pairwise_sq(tpool),
                       TD.lowrank_pairwise_sq(tpool,
                                              gram_fn=factor_gram_ref))
    assert TPD.factor_gram_f32.launches == launches


def test_kernel_wrapper_refuses_cpu_and_mixed_tensors():
    a = torch.ones(1, 4, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        TPD.factor_gram_f32([a])
    with pytest.raises(ValueError, match="mixed devices"):
        TPD.factor_gram_group([a, torch.ones(1, 4, 8, device="meta")])
    with pytest.raises(ValueError, match="no route"):
        TPD.factor_gram_group([torch.ones(1, 4, 8, device="meta")])
