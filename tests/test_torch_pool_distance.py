"""Port parity for the pool-distance sweep (`kernels/pool_distance`), its
public wrappers (`kernels/ops`), the stacked pool's d1/d2 through the
sweep (`core/distances`), `fedelmy_loss` and the deprecated drivers
(`core/fedelmy`, `core/baselines`), against the JAX reference on the same
numpy inputs; the reference's Pallas kernels run in interpret mode, as
its own tests run them. On the CPU the sweep takes its plain versions:
`ref.pool_distance_stats_ref` forward, `ref.pool_distance_stats_bwd_ref`
backward.

Tolerances:
* distances and stats: the reference test's own (tests/test_kernels.py):
  f32 rtol 1e-5, atol 1e-4; bf16 rtol 1e-3, atol 1e-2;
* the plain backward against autograd and `jax.grad`, and d1/d2 values
  and gradients through the sweep against the reference: rtol 1e-5 with
  an atol of 1e-5 of the gradient's own scale (f32 sums of a few hundred
  to a few thousand terms in another order). At w equal to the anchor the
  cosine distance is exactly 0 and its gradient exactly 0, so both
  packages compute rounding residues there: value and gradient are held
  to 1e-5 absolute, a few hundred ulps of the terms they cancel;
* `fedelmy_loss`: value and gradient rtol 1e-5, atol 1e-6;
* the ops facade: each op at its reference test's tolerance (stated at
  its case); the shims equal `launch` exactly (the same CPU run)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.baselines as JB
import repro.core.fedelmy as JF
from repro.configs import FedConfig as JaxFedConfig
from repro.core import distances as JD
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.pool import MomentPool as JaxMomentPool
from repro.kernels import ops as JOPS
from repro.kernels.pool_distance import pool_distance_stats as jax_pd_stats
from repro.models import build_model as jax_build_model
from repro.configs import get_arch as jax_get_arch
from repro_torch.api import Experiment, launch
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params, from_jax_pool, to_jax_params
from repro_torch.core import baselines as TB
from repro_torch.core import distances as TD
from repro_torch.core import fedelmy as TF
from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool
from repro_torch.data import batch_iterator
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import pool_distance as TPD
from repro_torch.kernels import ref as TREF
from repro_torch.models import build_model

torch.set_num_threads(2)

MEASURES = ("l2", "l1", "cosine", "squared_l2")
CNN = dataclasses.replace(get_arch("paper-cnn"), d_model=4, d_ff=16)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _tol(bf16):
    return dict(rtol=1e-3, atol=1e-2) if bf16 else dict(rtol=1e-5, atol=1e-4)


def _pair(x, bf16):
    """The same values as a jax array and a torch tensor (bf16 rounds
    the same f32 values to nearest even in both)."""
    j, t = jnp.asarray(x), torch.from_numpy(x)
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    return j, t


# ---------------------------------------------------------------------------
# 1. the flat forms against the reference's kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c,p", [(2, 1000), (6, 70000), (11, 131072)])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("measure", MEASURES)
def test_pool_distances_match_reference(c, p, bf16, measure):
    rng = np.random.default_rng(c * p)
    jw, tw = _pair(rng.standard_normal(p, dtype=np.float32), bf16)
    jm, tm = _pair(rng.standard_normal((c, p), dtype=np.float32), bf16)
    want = np.asarray(JOPS.pool_distances(jw, jm, measure=measure))
    got = TOPS.pool_distances(tw, tm, measure=measure)
    assert got.shape == (c,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_tol(bf16))


@pytest.mark.parametrize("b,c,p", [(1, 1, 1), (2, 3, 31), (3, 5, 700),
                                   (2, 2, 65537)])
def test_batched_stats_match_reference_and_single_runs(b, c, p):
    """The batched (B, C, P) form against the reference's Pallas sweep
    (interpret mode; its tail zero-padded to the 65,536 block) and
    against a loop of single runs, at ragged P."""
    rng = np.random.default_rng(b * 7919 + c * 131 + p)
    w = rng.standard_normal((b, p), dtype=np.float32)
    pool = rng.standard_normal((b, c, p), dtype=np.float32)
    want = jax_pd_stats(jnp.asarray(w), jnp.asarray(pool), interpret=True)
    got = TPD.pool_distance_stats(torch.from_numpy(w), torch.from_numpy(pool))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (b, c)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-4, err_msg=k)
        for i in range(b):
            one = TPD.pool_distance_stats(torch.from_numpy(w[i]),
                                          torch.from_numpy(pool[i]))
            np.testing.assert_allclose(got[k][i].numpy(), one[k].numpy(),
                                       rtol=1e-5, atol=1e-4, err_msg=k)
    flat = TREF.pool_distance_ref(torch.from_numpy(w[0]),
                                  torch.from_numpy(pool[0]))
    for k in flat:
        np.testing.assert_allclose(got[k][0].numpy(), flat[k].numpy(),
                                   rtol=1e-5, atol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# 2. the plain backward
# ---------------------------------------------------------------------------

def _grad_case(batched, zero_residual, seed=3):
    rng = np.random.default_rng(seed)
    lead = (2,) if batched else ()
    w = rng.standard_normal(lead + (257,), dtype=np.float32)
    pool = rng.standard_normal(lead + (4, 257), dtype=np.float32)
    if zero_residual:
        pool[..., 0, :] = w                  # member 0 is w: r = 0 exactly
    gs = {k: rng.standard_normal(lead + (4,), dtype=np.float32)
          for k in ("sq", "l1", "dot", "norm")}
    g_wsq = rng.standard_normal(lead, dtype=np.float32)
    return w, pool, gs, g_wsq


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("zero_residual", [False, True])
def test_plain_backward_matches_autograd_and_jax_grad(batched, zero_residual):
    w, pool, gs, g_wsq = _grad_case(batched, zero_residual)

    def jax_objective(jw):
        stats = JD.pool_distance_stats_ref(jw, jnp.asarray(pool))
        return sum(jnp.sum(stats[k] * gs[k]) for k in gs) + jnp.sum(
            jnp.asarray(g_wsq) * jnp.sum(jw * jw, axis=-1))

    want = np.asarray(jax.grad(jax_objective)(jnp.asarray(w)))
    tw = torch.from_numpy(w).requires_grad_(True)
    stats = TREF.pool_distance_stats_ref(tw, torch.from_numpy(pool))
    total = sum(torch.sum(stats[k] * torch.from_numpy(gs[k])) for k in gs) \
        + torch.sum(torch.from_numpy(g_wsq) * tw.square().sum(-1))
    auto = torch.autograd.grad(total, tw)[0].numpy()
    plain = TREF.pool_distance_stats_bwd_ref(
        torch.from_numpy(w), torch.from_numpy(pool),
        *(torch.from_numpy(gs[k]) for k in ("sq", "l1", "dot")),
        g_wsq=torch.from_numpy(g_wsq)).numpy()
    scale = float(np.abs(want).max())
    for got in (auto, plain):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)


# ---------------------------------------------------------------------------
# 3. d1 and d2 through the sweep against the reference
# ---------------------------------------------------------------------------

def _cnn_params(n):
    model = build_model(CNN, device="cpu")
    return [to_jax_params(model.init(s)) for s in range(n)]


@pytest.fixture(scope="module")
def cnn_trees():
    """Five parameter sets of the width-4 paper CNN, as numpy trees."""
    return _cnn_params(5)


def _stacked(trees, capacity):
    """A reference ModelPool of `trees` (a partly filled pool when there
    are fewer than `capacity`) and the port's, carried across."""
    jpool = JaxModelPool.create(jax.tree.map(jnp.asarray, trees[0]),
                                capacity)
    for t in trees[1:]:
        jpool = jpool.append(jax.tree.map(jnp.asarray, t))
    return jpool, from_jax_pool(_np(jpool), "cpu")


def _leaves_close(got, want_tree, rtol, atol_rel):
    want = from_jax_params(_np(want_tree), "cpu")
    scale = max(float(v.abs().max()) for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol_rel * scale,
                                   err_msg=k)


@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("at_anchor", [True, False])
def test_sweep_d1_d2_match_reference(measure, at_anchor, cnn_trees):
    """A pool of capacity 4 holding 3 members (one slot masked); w equal
    to the anchor (a pool model's first step) and away from it."""
    jpool, tpool = _stacked(cnn_trees[:3], capacity=4)
    w_tree = cnn_trees[0] if at_anchor else jax.tree.map(
        lambda a, b: 0.5 * (a + b), cnn_trees[3], cnn_trees[4])
    jw = jax.tree.map(jnp.asarray, w_tree)
    for j_fn, t_fn, anchor in (
            (lambda p: JD.d1_pool_distance(p, jpool, measure),
             lambda p: TD.d1_pool_sweep(p, tpool, measure), None),
            (lambda p: JD.d2_anchor_distance(p, jpool.first(), measure),
             lambda p: TD.d2_anchor_sweep(p, tpool.first(), measure), 0)):
        want, want_grad = jax.value_and_grad(j_fn)(jw)
        tw = {k: v.requires_grad_(True)
              for k, v in from_jax_params(_np(w_tree), "cpu").items()}
        got = t_fn(tw)
        grad = dict(zip(tw, torch.autograd.grad(got, list(tw.values()))))
        got = float(got.detach())
        residue = measure == "cosine" and at_anchor and anchor is not None
        if residue:     # exact value 0, exact gradient 0: rounding residues
            assert abs(got) <= 1e-5 and abs(float(want)) <= 1e-5
            for g in grad.values():
                assert float(g.abs().max()) <= 1e-5
            continue
        np.testing.assert_allclose(got, float(want), rtol=1e-5, atol=1e-6)
        _leaves_close(grad, want_grad, 1e-5, 1e-5)


def test_sweep_cpu_route_never_touches_the_cuda_library(cnn_trees,
                                                        monkeypatch):
    """CPU tensors take the plain versions: loading a kernel library would
    raise. d1/d2 route CPU tensors to the per-leaf code, the sweep's CPU
    route matches it, and tensors on two devices raise."""
    def refuse():
        raise AssertionError("a CPU tensor reached the CUDA library")
    monkeypatch.setattr(TPD, "_sweep_lib", refuse)
    monkeypatch.setattr(TPD, "_lib", refuse)
    _, tpool = _stacked(cnn_trees[:2], capacity=3)
    tw = {k: v.requires_grad_(True) for k, v in
          from_jax_params(cnn_trees[3], "cpu").items()}
    for measure in MEASURES:
        routed = TD.d1_pool_distance(tw, tpool, measure) + \
            TD.d2_anchor_distance(tw, tpool.first(), measure)
        swept = TD.d1_pool_sweep(tw, tpool, measure) + \
            TD.d2_anchor_sweep(tw, tpool.first(), measure)
        g_routed = torch.autograd.grad(routed, list(tw.values()))
        g_swept = torch.autograd.grad(swept, list(tw.values()))
        torch.testing.assert_close(swept, routed, rtol=1e-5, atol=1e-6)
        for a, b in zip(g_swept, g_routed):
            torch.testing.assert_close(a, b, rtol=1e-5,
                                       atol=1e-5 * float(b.abs().max()))
    w = torch.randn(100)
    TOPS.pool_distances(w, torch.randn(3, 100))
    with pytest.raises(ValueError):
        TPD.pool_distance_f32([w[None]], [torch.randn(1, 3, 100)])
    meta = {k: torch.empty_like(v, device="meta") for k, v in tw.items()}
    with pytest.raises(ValueError, match="no route"):
        TD.d2_anchor_distance(tw, meta)
    with pytest.raises(ValueError, match="no route"):
        TD.d1_pool_distance(meta, tpool)


def test_tree_pool_distances_match_flat_form(cnn_trees):
    """The leaf-table front end against the flattened form (the port's
    and the reference's, which concatenates the leaves)."""
    jpool, tpool = _stacked(cnn_trees[:3], capacity=4)
    params = from_jax_params(cnn_trees[3], "cpu")
    w = torch.cat([v.reshape(-1) for v in params.values()])
    pool = torch.cat([s.reshape(s.shape[0], -1)
                      for s in tpool.members.values()], dim=1)
    for measure in MEASURES:
        tree = TOPS.tree_pool_distances(params, tpool.members,
                                        measure=measure)
        torch.testing.assert_close(
            tree, TOPS.pool_distances(w, pool, measure=measure),
            rtol=1e-5, atol=1e-4)
        want = JOPS.tree_pool_distances(jax.tree.map(jnp.asarray,
                                                     cnn_trees[3]),
                                        jpool.members, measure=measure)
        np.testing.assert_allclose(tree.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# 4. fedelmy_loss and the deprecated drivers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(dataclasses.replace(jax_get_arch("paper-cnn"),
                                             d_model=4, d_ff=16))
    return jm, build_model(CNN, device="cpu")


@pytest.mark.parametrize("kind", ["stacked", "moment"])
def test_fedelmy_loss_matches_reference(kind, models, cnn_trees):
    jm, tm = models
    rng = np.random.default_rng(11)
    batch = {"images": rng.standard_normal((8, 32, 32, 3), dtype=np.float32),
             "labels": rng.integers(0, 10, 8).astype(np.int32)}
    if kind == "stacked":
        jpool, tpool = _stacked(cnn_trees[:3], capacity=4)
        measure = "l2"
    else:
        jpool = JaxMomentPool.create(jax.tree.map(jnp.asarray, cnn_trees[0]))
        for t in cnn_trees[1:3]:
            jpool = jpool.append(jax.tree.map(jnp.asarray, t))
        tpool = from_jax_pool(_np(jpool), "cpu")
        measure = "squared_l2"
    jfed = JaxFedConfig(distance_measure=measure)
    tfed = FedConfig(distance_measure=measure)
    w_tree = cnn_trees[3]

    def jax_total(p):
        return JF.fedelmy_loss(jm.loss_fn, p, jax.tree.map(jnp.asarray, batch),
                               jpool, jfed)

    (want, want_task), want_grad = jax.value_and_grad(jax_total, has_aux=True)(
        jax.tree.map(jnp.asarray, w_tree))
    tw = {k: v.requires_grad_(True)
          for k, v in from_jax_params(w_tree, "cpu").items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got, task = TF.fedelmy_loss(tm.loss_fn, tw, tbatch, tpool, tfed)
    grad = dict(zip(tw, torch.autograd.grad(got, list(tw.values()))))
    np.testing.assert_allclose(float(task), float(want_task), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    _leaves_close(grad, want_grad, 1e-5, 1e-6)


def _tiny_run():
    model = build_model(CNN, device="cpu")
    rng = np.random.default_rng(0)
    arrays = [{"images": rng.standard_normal((16, 32, 32, 3),
                                             dtype=np.float32),
               "labels": rng.integers(0, 10, 16).astype(np.int32)}
              for _ in range(2)]
    fed = FedConfig(n_clients=2, pool_size=1, e_local=1, e_warmup=1,
                    learning_rate=1e-3)

    def iters():
        return [batch_iterator(a, 8, seed=i, device="cpu")
                for i, a in enumerate(arrays)]

    def accuracy(params):
        return torch.tensor(0.5)
    return model, fed, iters, accuracy


SHIMS = [("fedelmy", TF.run_fedelmy, {}), ("fedelmy_fewshot",
                                           TF.run_fedelmy_fewshot,
                                           {"shots": 2}),
         ("fedelmy_pfl", TF.run_fedelmy_pfl, {})] + \
    [(name, fn, {}) for name, fn in TB.BASELINES.items()]


@pytest.mark.parametrize("strategy,shim,extra", SHIMS,
                         ids=[s[0] for s in SHIMS])
def test_deprecated_drivers_warn_and_equal_launch(strategy, shim, extra):
    model, fed, iters, accuracy = _tiny_run()
    evals = {} if strategy in TB.BASELINES else {"eval_fn": accuracy}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = shim(model, iters(), fed, 0, **extra, **evals)
    assert any(issubclass(w.category, DeprecationWarning) and
               f"run_{strategy}" in str(w.message) for w in caught)
    res = launch(Experiment(model=model, client_iters=iters(), fed=fed,
                            strategy=strategy, seed=0, **extra, **evals))
    params = out if strategy in TB.BASELINES else out[0]
    assert list(params) == list(res.params)
    for k in params:
        assert torch.equal(params[k], res.params[k]), k
    if strategy == "fedelmy_pfl":
        assert out[1] == [{"global_acc": res.final_metric}]
    elif strategy not in TB.BASELINES:
        assert out[1] == res.history()
    assert set(TB.BASELINES) == set(JB.BASELINES)


# ---------------------------------------------------------------------------
# 5. the rest of the ops facade against the reference's ops
# ---------------------------------------------------------------------------

def _facade_case(op, rng):
    """(reference output, port output, tolerance) of one op on the same
    numpy inputs."""
    def rn(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    j, t = jnp.asarray, torch.from_numpy
    if op == "flash_attention":      # tests/test_kernels.py: 2e-5
        q, k, v = rn(2, 64, 4, 32), rn(2, 64, 2, 32), rn(2, 64, 2, 32)
        return (JOPS.flash_attention(j(q), j(k), j(v), causal=True),
                TOPS.flash_attention(t(q), t(k), t(v), causal=True), 2e-5)
    if op == "factor_grams":         # f32 sums of 300 terms
        a = rn(2, 12, 300)
        return JOPS.factor_grams(j(a)), TOPS.factor_grams(t(a)), 1e-5
    if op == "lowrank_pool_sq":      # test_torch_lowrank's distances
        trees = _cnn_params(3)
        from repro.core.pool import LowRankDeltaPool as JaxLowRankPool
        jpool = JaxLowRankPool.create(jax.tree.map(j, trees[0]), 3, 2)
        tpool = LowRankDeltaPool.create(from_jax_params(trees[0], "cpu"), 3,
                                        2)
        for tree in trees[1:]:
            jpool = jpool.append(jax.tree.map(j, tree))
            tpool = tpool.append(from_jax_params(tree, "cpu"))
        return JOPS.lowrank_pool_sq(jpool), TOPS.lowrank_pool_sq(tpool), 1e-4
    if op == "gla_chunked":          # test_torch_ssm's Pallas tolerance
        q, k, v = rn(1, 32, 2, 8), rn(1, 32, 2, 8), rn(1, 32, 2, 8)
        ld = -np.exp(rn(1, 32, 2, 8) - 1.0)
        bonus = np.exp(0.1 * rn(2, 8))
        want = JOPS.gla_chunked(j(q), j(k), j(v), j(ld), chunk=16, pre=True,
                                bonus=j(bonus))
        got = TOPS.gla_chunked(t(q), t(k), t(v), t(ld), chunk=16, pre=True,
                               bonus=t(bonus))
        return want, got, 1e-4
    if op == "bgmv":                 # f32 sums of 64 + 4 terms
        x, u, v = rn(3, 5, 64), rn(3, 64, 4), rn(3, 48, 4)
        return JOPS.bgmv(j(x), j(u), j(v)), TOPS.bgmv(t(x), t(u), t(v)), 1e-5
    if op == "fused_conv2d":         # f32 sums of 27 terms
        x, w, b = rn(2, 8, 8, 3), rn(3, 3, 3, 5), rn(5)
        return (JOPS.fused_conv2d(j(x), j(w), j(b)),
                TOPS.fused_conv2d(t(x), t(w), t(b)), 1e-5)
    if op == "fused_maxpool2x2":     # exact
        x = rn(2, 8, 8, 3)
        return JOPS.fused_maxpool2x2(j(x)), TOPS.fused_maxpool2x2(t(x)), 0.0
    if op == "fused_sgd":            # one f32 rounding: XLA may round
        #                              g + wd·p and lr·(…) apart, not as FMAs
        p, g = {"a": rn(7), "b": rn(3, 4)}, {"a": rn(7), "b": rn(3, 4)}
        want = JOPS.fused_sgd(jax.tree.map(j, p), jax.tree.map(j, g),
                              lr=1e-2, wd=1e-4)
        got = TOPS.fused_sgd({k: t(x) for k, x in p.items()},
                             {k: t(x) for k, x in g.items()}, lr=1e-2,
                             wd=1e-4)
        return (np.concatenate([np.asarray(want[k]).ravel() for k in p]),
                torch.cat([got[k].reshape(-1) for k in p]), 2.0 ** -23)
    raise ValueError(op)


@pytest.mark.parametrize("op", ["flash_attention", "factor_grams",
                                "lowrank_pool_sq", "gla_chunked", "bgmv",
                                "fused_conv2d", "fused_maxpool2x2",
                                "fused_sgd"])
def test_ops_facade_matches_reference(op):
    want, got, tol = _facade_case(op, np.random.default_rng(5))
    if isinstance(want, tuple):      # gla_chunked: (y, final state)
        pairs = list(zip(want, got))
    else:
        pairs = [(want, got)]
    for w, g in pairs:
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=tol, atol=0.0 if op == "fused_sgd"
                                   else tol)
    if op == "flash_attention":
        x = torch.zeros(1, 8, 2, 32)
        with pytest.raises(ValueError, match="bq and bk"):
            TOPS.flash_attention(x, x, x, bq=32)
    if op == "gla_chunked":
        x = torch.zeros(1, 24, 2, 8)
        with pytest.raises(ValueError, match="multiple"):
            TOPS.gla_chunked(x, x, x, x, chunk=16)
