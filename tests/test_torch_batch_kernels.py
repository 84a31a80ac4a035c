"""The run axis of the port's kernels on the CPU: what a batched step
(`api.trainer.batched_grad_step`, `torch.func.vmap` over B runs) makes of
the GEMM and the pool-distance sweep, and the batched pool operations.

* `GemmF32Function`'s vmap rule folds vmap's axis into the GEMM's run axis:
  values and both gradients equal per-run products (rtol 1e-6, atol 1e-5,
  ~2 ulps of the largest of these products' values, which reach ~40: the
  plain version's batched matmul against B single ones, which agree
  bitwise on most shapes and within a few roundings on the rest), for mapped
  and shared operands and for operands with runs of their own; the CNN's
  batched step makes exactly its 8 products, each once, each over all B
  runs — on the card, one launch each.
* `PoolStatsFunction`'s vmap rule over B runs' params and pools (or a pool
  the runs share): stats, Σw² and ∂w equal per-run calls (rtol 1e-6, atol
  1e-6); a batched Eq. 9 step makes one forward and one backward of it.
* Every kernel launcher without a vmap rule refuses a vmapped tensor with
  "not ported yet" (on the card such a launch would read no memory).
* The pools' `create`, `average` and `_append` under vmap equal the
  per-run operations (bitwise; the low-rank pool's batched QR within
  1e-6); `stack_trees` / `unstack_tree` round-trip and refuse mismatched
  trees."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.api.pools import backend_for
from repro_torch.api.trainer import (batched_pool_append, batched_pool_average,
                                     make_batched_plain_step,
                                     make_batched_pool_step, stack_trees,
                                     unstack_tree)
from repro_torch.configs import FedConfig, get_arch
from repro_torch.core import distances as TD
from repro_torch.core.pool import _tensors
from repro_torch.kernels import bgmv, chunk_scan, flash_attention
from repro_torch.kernels import local_step as TL
from repro_torch.kernels import pool_distance as TPD
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer

torch.set_num_threads(2)

CNN = dataclasses.replace(get_arch("paper-cnn"), d_model=8, d_ff=16)
TOL = dict(rtol=1e-6, atol=1e-6)
GEMM_TOL = dict(rtol=1e-6, atol=1e-5)


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))


def _close(a, b, **tol):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               **(tol or TOL))


# ---------------------------------------------------------------------------
# The GEMM's vmap rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("in_dims", [(0, 0), (0, None), (None, 0)])
@pytest.mark.parametrize("m,k,n", [(64, 27, 8), (100, 77, 45), (27, 300, 9)])
def test_gemm_vmap_rule_matches_per_run_products(in_dims, m, k, n):
    rng = np.random.default_rng(m + k + n)
    runs = 3
    a = _randn(rng, *((runs,) if in_dims[0] == 0 else ()), m, k)
    b = _randn(rng, *((runs,) if in_dims[1] == 0 else ()), k, n)
    weight = _randn(rng, runs, m, n)
    a.requires_grad_(True)
    b.requires_grad_(True)
    out = torch.func.vmap(TL.gemm, in_dims=in_dims)(a, b)
    ga, gb = torch.autograd.grad((out * weight).sum(), (a, b))

    def slice_of(x, d, i):
        return x[i] if d == 0 else x

    per_run = [TL.gemm(slice_of(a, in_dims[0], i), slice_of(b, in_dims[1], i))
               for i in range(runs)]
    want_a, want_b = torch.autograd.grad(
        sum((p * weight[i]).sum() for i, p in enumerate(per_run)), (a, b))
    _close(out, torch.stack(per_run), **GEMM_TOL)
    _close(ga, want_a, **GEMM_TOL)
    _close(gb, want_b, **GEMM_TOL)


def test_gemm_vmap_rule_folds_runs_of_its_own():
    """An operand with a run axis of its own under vmap (vmap of vmap):
    the two run axes fold into one."""
    rng = np.random.default_rng(1)
    a, b = _randn(rng, 2, 3, 10, 6), _randn(rng, 2, 3, 6, 4)
    out = torch.func.vmap(torch.func.vmap(TL.gemm))(a, b)
    _close(out, a @ b, **GEMM_TOL)


def test_cnn_batched_step_makes_each_product_once_over_all_runs(monkeypatch):
    """The paper CNN's fused loss under a batched step of 3 runs: the GEMM
    route is called exactly for the step's 8 products (c1 forward and dB;
    c2 and c3 forward, dA and dB), each with the 3 runs stacked."""
    calls = []
    product = TL._product

    def spy(a, b, trans_a=False, trans_b=False):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return product(a, b, trans_a, trans_b)
    monkeypatch.setattr(TL, "_product", spy)
    model = build_model(CNN, device="cpu")
    runs = 3
    params = stack_trees([model.init(s) for s in range(runs)])
    rng = np.random.default_rng(0)
    batch = {"images": _randn(rng, runs, 4, 32, 32, 3),
             "labels": torch.from_numpy(
                 rng.integers(0, 10, (runs, 4)).astype(np.int32))}
    opt = make_optimizer("adam", 1e-3)
    step = make_batched_plain_step(TL.fused_loss_for(model.loss_fn), opt)
    step(params, opt.init(params), batch,
         torch.zeros((), dtype=torch.int32))
    assert len(calls) == 8
    assert all(a[0] == runs and b[0] == runs and len(a) == len(b) == 3
               for a, b in calls)


# ---------------------------------------------------------------------------
# The sweep's vmap rule
# ---------------------------------------------------------------------------

def _cnn_trees(n, seed=0):
    model = build_model(CNN, device="cpu")
    rng = np.random.default_rng(seed)
    base = model.init(seed)
    return [{k: v + 0.01 * _randn(rng, *v.shape) for k, v in base.items()}
            for _ in range(n)]


@pytest.mark.parametrize("shared_pool", [False, True])
@pytest.mark.parametrize("runs", [2, 3])
def test_sweep_vmap_rule_matches_per_run_calls(runs, shared_pool):
    trees = _cnn_trees(runs + 4 * runs, seed=runs)
    params = stack_trees(trees[:runs])
    members = [stack_trees(trees[runs + 4 * i: runs + 4 * i + 4])
               for i in range(runs)]
    pool = members[0] if shared_pool else stack_trees(members)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    rng = np.random.default_rng(7)
    g_stats = _randn(rng, runs, 4, 4)
    g_wsq = _randn(rng, runs)

    def stats_of(p, m):
        stats, wsq = TPD.tree_pool_distance_stats(p, m)
        return torch.stack([stats[k] for k in TPD.STATS]), wsq

    stats, wsq = torch.func.vmap(
        stats_of, in_dims=(0, None if shared_pool else 0))(leaves, pool)
    grads = torch.autograd.grad((stats * g_stats).sum() + (wsq * g_wsq).sum(),
                                list(leaves.values()))
    for i in range(runs):
        one = {k: v[i].clone().requires_grad_(True) for k, v in params.items()}
        m = members[0] if shared_pool else members[i]
        s_i, w_i = stats_of(one, m)
        g_i = torch.autograd.grad((s_i * g_stats[i]).sum() + w_i * g_wsq[i],
                                  list(one.values()))
        _close(stats[i], s_i)
        _close(wsq[i], w_i)
        for got, want in zip(grads, g_i):
            _close(got[i], want)


def test_batched_pool_step_makes_one_sweep_forward_and_backward(monkeypatch):
    """The stacked pool's d1 and d2 routed through the sweep (its plain
    versions, as test_torch_sweep_fused.py forces them on the CPU): a
    batched Eq. 9 step of 3 runs is one forward and one backward of
    `PoolStatsFunction`, over all 3 runs."""
    calls = {"forward": [], "backward": 0}
    fwd, bwd = TPD.PoolStatsFunction.forward, TPD.PoolStatsFunction.backward

    def forward(members, *w):
        calls["forward"].append(w[0].shape[0])
        return fwd(members, *w)

    def backward(ctx, *args):
        calls["backward"] += 1
        return bwd(ctx, *args)
    monkeypatch.setattr(TPD.PoolStatsFunction, "forward",
                        staticmethod(forward))
    monkeypatch.setattr(TPD.PoolStatsFunction, "backward",
                        staticmethod(backward))
    monkeypatch.setattr(TD, "_route", lambda *args: "cuda")
    model = build_model(CNN, device="cpu")
    fed = FedConfig(n_clients=1, pool_size=3, alpha=0.06, beta=1.0)
    backend = backend_for(fed)
    opt = make_optimizer("adam", 1e-3)
    runs = 3
    trees = _cnn_trees(2 * runs)
    params = stack_trees(trees[:runs])
    pools = stack_trees([backend.create(t, fed).append(u)
                         for t, u in zip(trees[:runs], trees[runs:])])
    rng = np.random.default_rng(0)
    batch = {"images": _randn(rng, runs, 4, 32, 32, 3),
             "labels": torch.from_numpy(
                 rng.integers(0, 10, (runs, 4)).astype(np.int32))}
    step = make_batched_pool_step(TL.fused_loss_for(model.loss_fn), fed, opt,
                                  backend)
    step(params, opt.init(params), batch, pools,
         torch.full((runs,), 0.06), torch.full((runs,), 1.0),
         torch.zeros((), dtype=torch.int32))
    assert calls == {"forward": [runs], "backward": 1}


# ---------------------------------------------------------------------------
# Launchers without a vmap rule
# ---------------------------------------------------------------------------

def _launcher_calls():
    t = torch.ones(2, 4, 4)
    return {
        "gemm_f32": lambda x: TL.gemm_f32(x, x),
        "sgd_f32": lambda x: TL.sgd_f32([x], [x], lr=0.1),
        "pool_distance_f32": lambda x: TPD.pool_distance_f32([x], [x[None]]),
        "pool_distance_bwd_f32": lambda x: TPD.pool_distance_bwd_f32(
            [x], [x[None]], torch.zeros(4, 1), torch.zeros(1)),
        "factor_gram_f32": lambda x: TPD.factor_gram_f32([x[None]]),
        "bgmv_f32": lambda x: bgmv.bgmv_f32(x[None], x[None], x[None]),
        "flash_attn_f32": lambda x: flash_attention.flash_attn_f32(
            x[None, None], x[None, None], x[None, None]),
        "gla_chunk_f32": lambda x: chunk_scan.gla_chunk_f32(
            x[None, None], x[None, None], x[None, None], x[None, None, 0],
            chunk=4),
    }, t


@pytest.mark.parametrize("name", sorted(_launcher_calls()[0]))
def test_launchers_refuse_vmapped_tensors(name):
    calls, t = _launcher_calls()
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch.func.vmap(calls[name])(t)


# ---------------------------------------------------------------------------
# Batched pool operations, stacked trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend_name", ["stacked", "moment", "lowrank"])
def test_batched_pool_ops_match_per_run(backend_name):
    kw = {"stacked": {}, "moment": dict(pool_backend="moment",
                                        distance_measure="squared_l2"),
          "lowrank": dict(pool_backend="lowrank", pool_rank=4)}[backend_name]
    fed = FedConfig(n_clients=1, pool_size=2, **kw)
    backend = backend_for(fed)
    runs = 3
    trees = _cnn_trees(2 * runs, seed=5)
    m_in, m_new = stack_trees(trees[:runs]), stack_trees(trees[runs:])
    pools = torch.func.vmap(lambda m: backend.create(m, fed))(m_in)
    pools = batched_pool_append(pools, m_new)
    avg = batched_pool_average(pools)
    exact = backend_name != "lowrank"
    for i in range(runs):
        want = backend.create(trees[i], fed).append(trees[runs + i])
        got = unstack_tree(pools, i)
        for x, y in zip(_tensors(got), _tensors(want)):
            if exact:
                assert torch.equal(x, y)
            else:
                _close(x, y)
        for k, v in want.average().items():
            if exact:
                assert torch.equal(avg[k][i], v), k
            else:
                _close(avg[k][i], v)


def test_batched_append_checks_room_once():
    fed = FedConfig(n_clients=1, pool_size=1)
    backend = backend_for(fed)
    trees = _cnn_trees(2)
    pools = torch.func.vmap(lambda m: backend.create(m, fed))(
        stack_trees(trees))
    pools = batched_pool_append(pools, stack_trees(trees))
    with pytest.raises(ValueError, match="full"):
        batched_pool_append(pools, stack_trees(trees))


def test_stack_and_unstack_trees():
    trees = _cnn_trees(3)
    stacked = stack_trees(trees)
    for i, t in enumerate(trees):
        for k in t:
            assert torch.equal(unstack_tree(stacked, i)[k], t[k])
    bad = dict(trees[1])
    bad["c1.w"] = bad["c1.w"][..., :2]
    with pytest.raises(ValueError, match="structurally identical"):
        stack_trees([trees[0], bad])
    with pytest.raises(ValueError, match="structurally identical"):
        stack_trees([trees[0], {k: v for k, v in trees[1].items()
                                if k != "c1.w"}])
