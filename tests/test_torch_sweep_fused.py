"""The stacked pool's d1 and d2 from one pool-distance sweep
(`core.distances.d1_d2_pool_sweep`, the Eq. 9 step's route on the card)
and the sweep kernel's launch plan and summation order
(`kernels.pool_distance.sweep_plan`), on the CPU.

* (a) The joint route against the separate sweeps (`d1_pool_sweep`,
  `d2_anchor_sweep`), through `PoolStatsFunction`'s CPU route: values
  and per-leaf gradients of d1, of d2 and of −α·d1 + β·d2, all four
  measures, at w = the anchor and away from it. The two routes sum the
  same f32 terms in other groupings (d2's stats come from a C-member
  sweep or a one-member one, ḡ of d1 and d2 added before or after the
  backward): rtol 1e-6 with an atol of 1e-6 of the gradient's own scale;
  cosine at the anchor is a rounding residue on both (≤ 1e-5 absolute).
* (b) The joint route against the JAX reference's `d1_pool_distance`,
  `d2_anchor_distance` and `jax.grad`, at the tolerances of
  `test_torch_pool_distance.test_sweep_d1_d2_match_reference`.
* (c) One `PoolStatsFunction` forward and one backward an Eq. 9 step of
  the stacked pool (the sweep's route forced on CPU tensors), for each
  use_d1/use_d2 setting, through the trainer and through `fedelmy_loss`.
* (d) `sweep_plan`: every element of every leaf is visited exactly once
  by the blocks' grid-stride walk and the threads' four-element groups,
  for C ∈ {1, 3, 4, 6, 63}, ragged tables and the CNN's ten leaves; the
  forward's shared memory within the H100's 232,448 bytes a block; every
  grid within CUDA's limits.
* (e) A numpy f32 emulation of the forward kernel's summation order
  (a thread's elements chunk by chunk, the warp's shuffle tree, the 8
  warps in order, the tail's lanes over the blocks' partials, their
  shuffle tree) at the full-width CNN's table lies within
  `SweepPlan.chain`·2⁻²⁴·Σ|terms| of the f64 sums."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distances as JD
from repro.core.pool import ModelPool as JaxModelPool
from repro_torch.api.pools import get_pool_backend
from repro_torch.api.trainer import LocalTrainer
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params, from_jax_pool, to_jax_params
from repro_torch.core import distances as TD
from repro_torch.core import fedelmy as TF
from repro_torch.data import batch_iterator
from repro_torch.kernels import pool_distance as TPD
from repro_torch.models import build_model

torch.set_num_threads(2)

MEASURES = ("l2", "l1", "cosine", "squared_l2")
CNN = dataclasses.replace(get_arch("paper-cnn"), d_model=4, d_ff=16)
# the full-width paper CNN's leaves, in the model's order
CNN_SIZES = (1728, 64, 73728, 128, 294912, 256, 1048576, 256, 2560, 10)
ALPHA, BETA = 0.06, 1.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def cnn_trees():
    """Five parameter sets of the width-4 paper CNN, as numpy trees."""
    model = build_model(CNN, device="cpu")
    return [to_jax_params(model.init(s)) for s in range(5)]


def _stacked(trees, capacity):
    jpool = JaxModelPool.create(jax.tree.map(jnp.asarray, trees[0]),
                                capacity)
    for t in trees[1:]:
        jpool = jpool.append(jax.tree.map(jnp.asarray, t))
    return jpool, from_jax_pool(_np(jpool), "cpu")


def _w_tree(trees, at_anchor):
    return trees[0] if at_anchor else jax.tree.map(
        lambda a, b: 0.5 * (a + b), trees[3], trees[4])


def _leaves(tree):
    return {k: v.requires_grad_(True)
            for k, v in from_jax_params(_np(tree), "cpu").items()}


def _grads(value, leaves):
    return dict(zip(leaves, torch.autograd.grad(value, list(leaves.values()),
                                                retain_graph=True)))


def _close(got, want, rtol, atol_rel):
    scale = max(float(v.abs().max()) for v in want.values())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=rtol,
                                   atol=atol_rel * scale, msg=k)


# ---------------------------------------------------------------------------
# (a) the joint route against the separate sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("at_anchor", [True, False])
def test_joint_sweep_matches_separate_sweeps(measure, at_anchor, cnn_trees):
    _, pool = _stacked(cnn_trees[:3], capacity=4)
    tw = _leaves(_w_tree(cnn_trees, at_anchor))
    d1, d2 = TD.d1_d2_pool_sweep(tw, pool, measure)
    s1 = TD.d1_pool_sweep(tw, pool, measure)
    s2 = TD.d2_anchor_sweep(tw, pool.first(), measure)
    torch.testing.assert_close(d1, s1, rtol=1e-6, atol=0.0)
    residue = measure == "cosine" and at_anchor
    if residue:     # exact value 0, exact gradient 0: rounding residues
        for v in (d2, s2):
            assert abs(float(v.detach())) <= 1e-5
        for g in _grads(d2, tw).values():
            assert float(g.abs().max()) <= 1e-5
    else:
        torch.testing.assert_close(d2, s2, rtol=1e-6, atol=1e-7)
        _close(_grads(d2, tw), _grads(s2, tw), 1e-6, 1e-6)
    _close(_grads(d1, tw), _grads(s1, tw), 1e-6, 1e-6)
    joint = _grads(-ALPHA * d1 + BETA * d2, tw)
    separate = _grads(-ALPHA * s1 + BETA * s2, tw)
    _close(joint, separate, 1e-6, 1e-5 if residue else 1e-6)


# ---------------------------------------------------------------------------
# (b) the joint route against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("at_anchor", [True, False])
def test_joint_sweep_matches_reference(measure, at_anchor, cnn_trees):
    """A pool of capacity 4 holding 3 members (one slot masked); the
    reference's d1 and d2, and jax.grad of each and of −α·d1 + β·d2."""
    jpool, pool = _stacked(cnn_trees[:3], capacity=4)
    w_tree = _w_tree(cnn_trees, at_anchor)
    jw = jax.tree.map(jnp.asarray, w_tree)

    def j_d1(p):
        return JD.d1_pool_distance(p, jpool, measure)

    def j_d2(p):
        return JD.d2_anchor_distance(p, jpool.first(), measure)

    tw = _leaves(w_tree)
    d1, d2 = TD.d1_d2_pool_sweep(tw, pool, measure)
    residue = measure == "cosine" and at_anchor
    for j_fn, got in ((j_d1, d1), (j_d2, d2)):
        want, want_grad = jax.value_and_grad(j_fn)(jw)
        grad = _grads(got, tw)
        if residue and j_fn is j_d2:
            assert abs(float(got.detach())) <= 1e-5
            assert abs(float(want)) <= 1e-5
            for g in grad.values():
                assert float(g.abs().max()) <= 1e-5
            continue
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5, atol=1e-6)
        _close(grad, from_jax_params(_np(want_grad), "cpu"), 1e-5, 1e-5)
    if not residue:
        want_grad = jax.grad(lambda p: -ALPHA * j_d1(p) + BETA * j_d2(p))(jw)
        _close(_grads(-ALPHA * d1 + BETA * d2, tw),
               from_jax_params(_np(want_grad), "cpu"), 1e-5, 1e-5)


def test_joint_route_keeps_the_per_leaf_path_on_the_cpu(cnn_trees):
    """On CPU tensors `d1_d2_pool_distance` is the per-leaf pair, bit for
    bit, and so is `eq9_distances` with the stacked backend's d1; the
    moment and low-rank backends' d1 never take the joint route."""
    _, pool = _stacked(cnn_trees[:3], capacity=4)
    tw = _leaves(cnn_trees[3])
    for measure in MEASURES:
        d1, d2 = TD.d1_d2_pool_distance(tw, pool, measure)
        want = (TD.d1_pool_distance(tw, pool, measure),
                TD.d2_anchor_distance(tw, pool.first(), measure))
        assert torch.equal(d1, want[0]) and torch.equal(d2, want[1])
        e1, e2 = TD.eq9_distances(tw, pool, measure, True, True,
                                  get_pool_backend("stacked").d1)
        assert torch.equal(e1, want[0]) and torch.equal(e2, want[1])
    assert get_pool_backend("stacked").d1 is TD.d1_pool_distance
    for name in ("moment", "lowrank"):
        assert get_pool_backend(name).d1 is not TD.d1_pool_distance


# ---------------------------------------------------------------------------
# (c) one forward and one backward a step
# ---------------------------------------------------------------------------

@pytest.fixture
def counted(monkeypatch):
    """Route the stacked pool's d1/d2 through the sweep on CPU tensors
    (its plain versions) and count `PoolStatsFunction`'s forwards and
    backwards."""
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = TPD.PoolStatsFunction.forward, TPD.PoolStatsFunction.backward

    def forward(ctx, *args):
        calls["forward"] += 1
        return fwd(ctx, *args)

    def backward(ctx, *args):
        calls["backward"] += 1
        return bwd(ctx, *args)
    monkeypatch.setattr(TPD.PoolStatsFunction, "forward",
                        staticmethod(forward))
    monkeypatch.setattr(TPD.PoolStatsFunction, "backward",
                        staticmethod(backward))
    monkeypatch.setattr(TD, "_route", lambda *args: "cuda")
    return calls


FLAGS = [(True, True), (True, False), (False, True), (False, False)]


def _step_setup(cnn_trees):
    model = build_model(CNN, device="cpu")
    rng = np.random.default_rng(3)
    data = {"images": rng.standard_normal((16, 32, 32, 3), dtype=np.float32),
            "labels": rng.integers(0, 10, 16).astype(np.int32)}
    _, pool = _stacked(cnn_trees[:3], capacity=4)
    return model, data, pool


@pytest.mark.parametrize("use_d1,use_d2", FLAGS)
def test_pool_step_makes_one_sweep_forward_and_backward(use_d1, use_d2,
                                                        counted, cnn_trees):
    model, data, pool = _step_setup(cnn_trees)
    fed = FedConfig(n_clients=1, pool_size=3, e_local=1, e_warmup=0,
                    use_d1=use_d1, use_d2=use_d2)
    trainer = LocalTrainer(model.loss_fn, fed)
    it = batch_iterator(data, 8, seed=0, device="cpu")
    params, task = trainer.train(pool.average(), it, 2, pool=pool)
    want = 2 if use_d1 or use_d2 else 0      # two steps
    assert counted == {"forward": want, "backward": want}
    assert all(bool(torch.isfinite(v).all()) for v in params.values())


@pytest.mark.parametrize("use_d1,use_d2", FLAGS)
def test_fedelmy_loss_makes_one_sweep_forward_and_backward(use_d1, use_d2,
                                                           counted,
                                                           cnn_trees):
    model, data, pool = _step_setup(cnn_trees)
    fed = FedConfig(use_d1=use_d1, use_d2=use_d2)
    batch = {k: torch.from_numpy(v[:8]) for k, v in data.items()}
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in pool.average().items()}
    total, _ = TF.fedelmy_loss(model.loss_fn, leaves, batch, pool, fed)
    torch.autograd.grad(total, list(leaves.values()))
    want = 1 if use_d1 or use_d2 else 0
    assert counted == {"forward": want, "backward": want}


# ---------------------------------------------------------------------------
# (d) the launch plan
# ---------------------------------------------------------------------------

TABLES = {
    "ragged": (1, 10, 4095, 4097, 65539),
    "cnn": CNN_SIZES,
    "empty leaves and 45 leaves": (0,) + (3000,) * 22 + (0,) + (1,) * 22,
}
SMEM_LIMIT = 232_448          # shared memory a block can use on an H100
MAX_GRID_X, MAX_GRID_Y = 2 ** 31 - 1, 65535


def _walk(plan, sizes):
    """How many times the kernels' walk visits each element of each leaf:
    the tables of MAX_LEAVES non-empty leaves, block j of a launch taking
    chunks j, j + grid, …, thread t's groups t + 256·k of a chunk."""
    seen = [np.zeros(n, np.int64) for n in sizes]
    live = [i for i, n in enumerate(sizes) if n]
    offsets = (4 * (np.arange(TPD.THREADS)[:, None] +
                    TPD.THREADS * np.arange(plan.groups)[None, :]))
    offsets = (offsets[..., None] + np.arange(4)).reshape(-1)
    for table, (x, _) in zip(
            [live[i:i + TPD.MAX_LEAVES]
             for i in range(0, len(live), TPD.MAX_LEAVES)], plan.grids(1)):
        first = np.cumsum([0] + [plan.blocks[i] for i in table])
        chunks = int(first[-1])
        for j in range(x):
            for k in range(j, chunks, x):
                li = int(np.searchsorted(first, k, side="right")) - 1
                leaf = table[li]
                start = (k - int(first[li])) * plan.chunk
                e = start + offsets
                np.add.at(seen[leaf], e[e < sizes[leaf]], 1)
    return seen


@pytest.mark.parametrize("table", list(TABLES))
@pytest.mark.parametrize("c", [1, 3, 4, 6, 63])
def test_sweep_plan_covers_every_element_once(c, table):
    sizes = TABLES[table]
    for esz in (4, 2):
        plan = TPD.sweep_plan(c, sizes, esz)
        per_pass = min(c, TPD.ROUND)      # members a pass of the kernels
        # the widest of 1, 2, 4 groups whose loaded values fit 48 registers
        held = [g for g in (1, 2, 4) if (per_pass + 1) * 4 * g <= 48]
        assert plan.groups == max(held, default=1)
        assert plan.chunk == 4 * TPD.THREADS * plan.groups
        assert all(bool((s == 1).all()) for s in _walk(plan, sizes))
        # the forward's shared memory: 8 warps' 4C + 1 sums and a flag
        assert 4 * TPD.WARPS * (4 * c + 1) + 4 <= SMEM_LIMIT
        for x, y in plan.grids(65535):
            assert 1 <= x <= min(MAX_GRID_X, plan.grid) and y <= MAX_GRID_Y
        assert len(plan.tables) == -(-sum(1 for n in sizes if n) //
                                     TPD.MAX_LEAVES)
        assert plan.workspace(3) == 3 * (4 * c + 1) * plan.slots
        assert plan.chunks_per_block * plan.slots >= plan.total_blocks


def test_sweep_plan_refuses_what_the_kernels_do_not_take():
    for c in (0, 64):
        with pytest.raises(ValueError, match="outside"):
            TPD.sweep_plan(c, [10], 4)
    with pytest.raises(ValueError, match="f32 or bf16"):
        TPD.sweep_plan(3, [10], 8)
    with pytest.raises(ValueError, match="no elements"):
        TPD.sweep_plan(3, [0, 0], 4)


# ---------------------------------------------------------------------------
# (e) the forward's summation order
# ---------------------------------------------------------------------------

def _tree32(v):
    """A warp's shuffle tree (`__shfl_down_sync` by 16, 8, 4, 2, 1) over
    the last axis of 32 lanes, in f32: lane 0's result."""
    for o in (16, 8, 4, 2, 1):
        v = (v[..., :o] + v[..., o:2 * o]).astype(np.float32)
    return v[..., 0]


def _emulate(plan, w_leaves, m_leaves):
    """The forward kernel's sums for one run, in f32 and in its order,
    each with its exact (f64) value and the sum of its terms' magnitudes:
    arrays (4C + 1,) in the kernel's slot order (q·C + t, then Σw²)."""
    c, g = plan.members, plan.groups
    e_thread = 4 * g
    (x, _), = plan.grids(1)
    first = np.cumsum([0] + list(plan.blocks))
    # each block's chunks in walk order, padded with an empty chunk (its
    # terms are exact zeros, which leave every f32 sum unchanged)
    per_block = plan.chunks_per_block
    offsets = (4 * (np.arange(TPD.THREADS)[:, None] +
                    TPD.THREADS * np.arange(g)[None, :]))
    offsets = (offsets[..., None] + np.arange(4)).reshape(TPD.THREADS,
                                                          e_thread)
    n_streams = c + 1
    data = np.zeros((n_streams, x, per_block, TPD.THREADS, e_thread),
                    np.float32)
    for j in range(x):
        for i, k in enumerate(range(j, plan.total_blocks, x)):
            li = int(np.searchsorted(first, k, side="right")) - 1
            start = (k - int(first[li])) * plan.chunk
            e = start + offsets
            inside = e < len(w_leaves[li])
            e = np.where(inside, e, 0)
            data[0, j, i] = np.where(inside, w_leaves[li][e], 0)
            for t in range(c):
                data[1 + t, j, i] = np.where(inside, m_leaves[li][t][e], 0)
    w = data[0]
    wd = w.astype(np.float64)

    def terms():
        """Each sum's terms, in f32 as the kernel forms them and in f64."""
        for q in range(4):
            for t in range(c):
                m, md = data[1 + t], data[1 + t].astype(np.float64)
                r, rd = (w - m).astype(np.float32), wd - md
                yield ([r * r, np.abs(r), w * m, m * m][q].astype(np.float32),
                       [rd * rd, np.abs(rd), wd * md, md * md][q])
        yield (w * w).astype(np.float32), wd * wd

    out, exact, magnitude = [], [], []
    for term, term64 in terms():
        exact.append(float(term64.sum()))
        magnitude.append(float(np.abs(term64).sum()))
        # a thread: chunk by chunk, its elements in order
        s = np.zeros((x, TPD.THREADS), np.float32)
        for i in range(per_block):
            for e in range(e_thread):
                s = (s + term[:, i, :, e]).astype(np.float32)
        # the warp's tree, then the 8 warps in order
        warps = _tree32(s.reshape(x, TPD.WARPS, 32))
        block = warps[:, 0]
        for v in range(1, TPD.WARPS):
            block = (block + warps[:, v]).astype(np.float32)
        # the tail: lane l over slots l, l + 32, …, then the tree
        lanes = np.zeros(32, np.float32)
        for i in range(0, x, 32):
            chunk = np.zeros(32, np.float32)
            chunk[:min(32, x - i)] = block[i:i + 32]
            lanes = (lanes + chunk).astype(np.float32)
        out.append(float(_tree32(lanes)))
    return np.array(out), np.array(exact), np.array(magnitude)


@pytest.mark.parametrize("c", [1, 4, 6])
def test_summation_order_within_the_chain_bound(c):
    rng = np.random.default_rng(19 + c)
    w_leaves = [rng.standard_normal(n, dtype=np.float32) * 0.05
                for n in CNN_SIZES]
    m_leaves = [(w[None] + rng.standard_normal((c, len(w)),
                                               dtype=np.float32) * 0.01
                 ).astype(np.float32) for w in w_leaves]
    plan = TPD.sweep_plan(c, CNN_SIZES, 4)
    got, exact, magnitude = _emulate(plan, w_leaves, m_leaves)
    bound = plan.chain * 2.0 ** -24 * magnitude
    err = np.abs(got - exact)
    assert (err <= bound).all(), (err / bound).max()
    assert err.max() > 0          # the f32 order does round
