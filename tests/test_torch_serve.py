"""Port parity for pool serving: the BGMV kernel's plain version,
`models/factored.py`, `serve/engine.PoolServer`, `serve/traffic.py` and
`serve/metrics.py` against the JAX reference.

Tolerances:
* BGMV: elementwise within (d_in + r)·2⁻²³·((|x|·|u|)·|v|ᵀ) of the Pallas
  kernel in interpret mode and of `ref.bgmv_ref` — the worst case of two
  f32 sums over d_in and then r terms taken in different orders, so it
  scales with d_in (a fixed rtol of 1e-6 does not hold: ROADMAP C2);
* the factored forward and the densified server against the reference's
  on the same carried-across pool: atol 5e-5 on O(1) logits (8 layers of
  f32 products in another order); factored against densified in the
  port atol 5e-5 at every rank (the same factors, reassociated);
* traces bitwise; server scores against hand loops atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api.results import RunResult as JaxRunResult
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core.pool import LowRankDeltaPool as JaxLowRankPool
from repro.kernels.bgmv import bgmv_pallas
from repro.kernels.ref import bgmv_ref as jax_bgmv_ref
from repro.models import build_model as jax_build_model
from repro.models.factored import factored_forward_for as jax_hook
from repro.serve import PoolServer as JaxPoolServer
from repro.serve import get_traffic as jax_get_traffic
from repro.serve import materialize_trace as jax_materialize_trace
from repro_torch.api import RunResult
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_pool, to_jax_params
from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool
from repro_torch.kernels.bgmv import bgmv
from repro_torch.kernels.ref import bgmv_ref
from repro_torch.models import build_model
from repro_torch.models.base import Model
from repro_torch.models.factored import FACTORED_FORWARD_ATTR, fdense
from repro_torch.serve import (FactoredMembers, PoolServer, get_traffic,
                               list_traffics, materialize_trace, serve_trace)

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# 1. BGMV: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,n,d_in,d_out,r,shared", [
    (3, 17, 33, 9, 5, True), (2, 70, 130, 20, 8, False),
    (1, 300, 17, 3, 4, False), (5, 32, 96, 257, 8, True)])
def test_bgmv_plain_matches_pallas_kernel(s, n, d_in, d_out, r, shared):
    rng = np.random.default_rng(n * d_in)
    x = rng.normal(size=(n, d_in) if shared else (s, n, d_in)).astype(
        np.float32)
    u = rng.normal(size=(s, d_in, r)).astype(np.float32)
    v = rng.normal(size=(s, d_out, r)).astype(np.float32)
    got = bgmv(*map(torch.from_numpy, (x, u, v))).numpy()
    xa = np.abs(x)[None] if shared else np.abs(x)
    bound = (d_in + r) * 2.0 ** -23 * np.einsum(
        "snr,sor->sno", np.einsum("snd,sdr->snr", np.broadcast_to(
            xa, (s, n, d_in)), np.abs(u)), np.abs(v))
    for want in (np.asarray(bgmv_pallas(*map(jnp.asarray, (x, u, v)),
                                        interpret=True)),
                 np.asarray(jax_bgmv_ref(*map(jnp.asarray, (x, u, v))))):
        assert want.shape == got.shape == (s, n, d_out)
        assert np.all(np.abs(got - want) <= bound)
    xb = torch.from_numpy(x).bfloat16()
    np.testing.assert_allclose(
        bgmv(xb, torch.from_numpy(u), torch.from_numpy(v)).numpy(),
        bgmv_ref(xb.float(), torch.from_numpy(u), torch.from_numpy(v)),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        bgmv(torch.from_numpy(x), torch.from_numpy(u)[:, 1:],
             torch.from_numpy(v))


# ---------------------------------------------------------------------------
# 2. factored forwards against the reference and the densified oracle
# ---------------------------------------------------------------------------

def _llama(tied, n_layers=8):
    kw = dict(n_layers=n_layers, tie_embeddings=tied, n_kv_heads=2,
              d_model=64, head_dim=16, d_ff=128, vocab_size=96)
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("llama3.2-1b").reduced(), **kw))
    tm = build_model(dataclasses.replace(
        get_arch("llama3.2-1b").reduced(), **kw), device="cpu")
    return jm, tm


def _jax_pool(tm, rank, n_appends=3):
    """A reference pool built from the port's inits (carried across)."""
    inits = [jax.tree.map(jnp.asarray, to_jax_params(tm.init(s)))
             for s in range(n_appends + 1)]
    pool = JaxLowRankPool.create(inits[0], capacity=n_appends + 2,
                                 rank=rank)
    for m in inits[1:]:
        pool = pool.append(m)
    return pool


TOKENS = np.random.default_rng(3).integers(0, 96, (2, 12)).astype(np.int32)


@pytest.mark.parametrize("tied", [True, False])
def test_factored_and_densified_match_reference(tied):
    jm, tm = _llama(tied)
    jpool = _jax_pool(tm, rank=4)
    want = np.asarray(jax.jit(jax_hook(jm.forward))(
        jpool.base, jpool.delta_tree(), {"tokens": jnp.asarray(TOKENS)}))
    pool = from_jax_pool(jax.tree.map(np.asarray, jpool), "cpu")
    hook = getattr(tm.forward, FACTORED_FORWARD_ATTR)
    batch = {"tokens": torch.from_numpy(TOKENS)}
    with torch.no_grad():
        got = hook(pool.base, hook.prepare(pool.base, pool.delta_tree()),
                   batch).numpy()
        with pytest.raises(TypeError, match="prepare"):
            hook(pool.base, pool.delta_tree(), batch)
    assert got.shape == want.shape == (5, 2, 12, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # the norm scales (8, 64) are factored at 8 layers and densified
    assert pool.delta_tree()["layers.ln1.scale"].u is not None
    assert hook.prepare(pool.base, pool.delta_tree())[
        "layers.ln1.scale"].dense.shape == (8, 5, 64)
    # the densified servers of both packages on the same pool
    want, _ = JaxPoolServer.from_pool(jm, jpool, factored=False).score_batch(
        {"tokens": jnp.asarray(TOKENS)})
    got, _ = PoolServer.from_pool(tm, pool, factored=False).score_batch(batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)


@pytest.mark.parametrize("rank", [1, 3, 64])
def test_factored_matches_densified_every_rank(rank):
    _, tm = _llama(tied=rank != 3, n_layers=2)
    pool = LowRankDeltaPool.create(tm.init(0), capacity=4, rank=rank)
    for s in (1, 2):
        pool = pool.append(tm.init(s))
    fac = PoolServer.from_pool(tm, pool)
    den = PoolServer.from_pool(tm, pool, factored=False)
    assert fac.factored and not den.factored
    batch = {"tokens": torch.from_numpy(TOKENS)}
    s1, p1 = fac.score_batch(batch)
    s2, p2 = den.score_batch(batch)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=0, atol=5e-5)


def _probe(with_hook):
    """(16, 12) → relu → (12, 10), its factored hook from `fdense` alone:
    shared x into the first layer, per-member activations after."""
    def init(seed):
        g = torch.Generator().manual_seed(seed)
        return {"fc1.b": torch.zeros(12), "fc1.w": 0.5 * torch.randn(
                    16, 12, generator=g),
                "fc2.b": torch.zeros(10), "fc2.w": 0.5 * torch.randn(
                    12, 10, generator=g)}

    def forward(p, batch):
        h = torch.relu(batch["x"] @ p["fc1.w"] + p["fc1.b"])
        return h @ p["fc2.w"] + p["fc2.b"]

    def forward_factored(p, d, batch):
        h = torch.relu(fdense(batch["x"], p["fc1.w"], d["fc1.w"],
                              p["fc1.b"], d["fc1.b"]))
        return fdense(h, p["fc2.w"], d["fc2.w"], p["fc2.b"], d["fc2.b"])

    if with_hook:
        setattr(forward, FACTORED_FORWARD_ATTR, forward_factored)
    return Model(None, init, forward, None, None, None, None,
                 torch.device("cpu"))


def _probe_pool(model, rank):
    pool = LowRankDeltaPool.create(model.init(0), capacity=4, rank=rank)
    for s in (1, 2, 3):
        pool = pool.append(model.init(s))
    return pool


@pytest.mark.parametrize("rank", [1, 5, 12])
def test_probe_hook_matches_densified(rank):
    model = _probe(with_hook=True)
    pool = _probe_pool(model, rank)
    batch = {"x": torch.randn(6, 16, generator=torch.Generator()
                              .manual_seed(rank))}
    s1, _ = PoolServer.from_pool(model, pool).score_batch(batch)
    s2, _ = PoolServer.from_pool(model, pool, factored=False).score_batch(
        batch)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# 3. the server: buckets, reductions, hooks, routing
# ---------------------------------------------------------------------------

def test_bucketed_score_equals_score_batch_and_reductions():
    _, tm = _llama(tied=True, n_layers=2)
    pool = LowRankDeltaPool.create(tm.init(0), capacity=4, rank=4)
    for s in (1, 2):
        pool = pool.append(tm.init(s))
    arrays = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, 96, (20, 8)).astype(np.int32))}
    idx = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5], np.int32)
    for mode in ("mean_logits", "majority_vote"):
        server = PoolServer.from_pool(tm, pool, mode=mode, buckets=(4, 8))
        assert server.chunk_plan(11) == [(0, 8, 8), (8, 3, 4)]
        scores, preds = server.score(arrays, idx)
        want, want_p = server.score_batch(
            {"tokens": arrays["tokens"][torch.from_numpy(idx).long()]})
        np.testing.assert_allclose(scores, want.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(preds, want_p.numpy())
        # hand loop over the live members' densified forwards
        logits = torch.stack([tm.forward(pool.member(t), {
            "tokens": arrays["tokens"][torch.from_numpy(idx).long()]})
            for t in range(pool.count)]).detach()
        if mode == "mean_logits":
            hand = logits.mean(0)
        else:
            hand = torch.nn.functional.one_hot(
                logits.argmax(-1), logits.shape[-1]).float().mean(0)
            np.testing.assert_allclose(scores.sum(-1), 1.0, rtol=1e-6)
        np.testing.assert_allclose(scores, hand.numpy(), rtol=0, atol=1e-5)


def test_weight_fn_sees_factored_members_and_dead_slots_never_vote():
    _, tm = _llama(tied=True, n_layers=2)
    pool = LowRankDeltaPool.create(tm.init(0), capacity=4, rank=2)
    pool = pool.append(tm.init(1))
    seen = []

    def weight_fn(members, mask):
        seen.append(members)
        return torch.tensor([1.0, 3.0, 5.0, 7.0])

    server = PoolServer.from_pool(tm, pool, weight_fn=weight_fn)
    assert isinstance(seen[0], FactoredMembers)
    assert server.weights.tolist() == [1.0, 3.0, 0.0, 0.0]
    assert server.n_members == 2
    batch = {"tokens": torch.from_numpy(TOKENS)}
    scores, _ = server.score_batch(batch)
    members = [tm.forward(pool.member(t), batch).detach() for t in (0, 1)]
    np.testing.assert_allclose(scores.numpy(),
                               ((members[0] + 3 * members[1]) / 4).numpy(),
                               rtol=0, atol=1e-5)


def test_from_pool_routing_and_errors():
    hookless = _probe(with_hook=False)
    pool = _probe_pool(hookless, rank=4)
    assert not PoolServer.from_pool(hookless, pool).factored
    with pytest.raises(ValueError, match="no 'forward_factored' hook"):
        PoolServer.from_pool(hookless, pool, factored=True)
    with pytest.raises(ValueError, match="FactoredMembers given"):
        PoolServer(hookless, FactoredMembers(pool.base, pool.delta_tree()),
                   pool.mask())
    with pytest.raises(TypeError, match="PoolServer.from_params"):
        PoolServer.from_pool(hookless, pool.base)
    with pytest.raises(ValueError, match="unknown mode"):
        PoolServer.from_pool(hookless, pool, mode="median")
    params = hookless.init(0)
    stacked = ModelPool.create(params, 3).append(hookless.init(1))
    server = PoolServer.from_pool(hookless, stacked)
    assert server.n_members == 2 and server.mask.tolist() == [1, 1, 0]
    moment = MomentPool.create(params).append(hookless.init(1))
    server = PoolServer.from_pool(hookless, moment)
    assert server.n_members == 1
    x = {"x": torch.randn(3, 16)}
    np.testing.assert_allclose(
        server.score_batch(x)[0].numpy(),
        hookless.forward(moment.average(), x).detach().numpy(), atol=1e-6)


def test_require_final_pool_diagnoses_like_the_reference():
    fed, jfed = FedConfig(), JaxFedConfig()
    for strategy in ("dfedavgm", "fedelmy"):
        port = RunResult(strategy=strategy, params={}, fed=fed)
        ref = JaxRunResult(strategy=strategy, params={}, fed=jfed)
        with pytest.raises(ValueError) as got:
            port.require_final_pool()
        with pytest.raises(ValueError) as want:
            ref.require_final_pool()
        assert str(got.value) == str(want.value)
    assert RunResult(strategy="fedelmy", params={}, fed=fed,
                     final_pool="pool").require_final_pool() == "pool"
    with pytest.raises(ValueError, match="discards its pool"):
        PoolServer.from_result(_probe(True), RunResult(
            strategy="dfedavgm", params={}, fed=fed))


# ---------------------------------------------------------------------------
# 4. traffic and measurement
# ---------------------------------------------------------------------------

def _clients():
    rng = np.random.default_rng(0)
    return [{"x": rng.normal(size=(n, 16)).astype(np.float32),
             "labels": rng.integers(0, 10, n).astype(np.int32)}
            for n in (40, 25, 60)]


@pytest.mark.parametrize("name", ["burst", "poisson_skewed", "ramp",
                                  "steady_uniform"])
def test_traces_bitwise_equal_to_reference(name):
    assert list_traffics() == ["burst", "poisson_skewed", "ramp",
                               "steady_uniform"]
    spec = get_traffic(name).replace(n_requests=150)
    ref = jax_materialize_trace(jax_get_traffic(name).replace(
        n_requests=150), _clients(), seed=4)
    got = materialize_trace(spec, _clients(), seed=4, device="cpu")
    assert got.tick_sizes() == ref.tick_sizes()
    for a, b in zip(got.ticks, ref.ticks):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.request_client, ref.request_client)
    np.testing.assert_array_equal(got.labels, ref.labels)
    np.testing.assert_array_equal(got.arrays["x"].numpy(),
                                  np.asarray(ref.arrays["x"]))
    assert got.n_requests == ref.n_requests == 150


def test_serve_trace_reports_every_field():
    model = _probe(with_hook=True)
    pool = _probe_pool(model, rank=4)
    trace = materialize_trace(get_traffic("burst").replace(
        n_requests=60, mean_batch=3), _clients(), seed=1, device="cpu")
    report = serve_trace(PoolServer.from_pool(model, pool), trace)
    row = report.row()
    assert list(row) == ["traffic", "mode", "n_members", "n_requests",
                         "n_ticks", "p50_ms", "p95_ms", "p99_ms", "qps",
                         "accuracy"]
    assert (report.traffic, report.mode, report.n_members,
            report.n_requests, report.n_ticks) == (
        "burst", "mean_logits", 4, 60, len(trace.ticks))
    assert 0 < report.p50_ms <= report.p95_ms <= report.p99_ms
    assert report.qps > 0 and 0.0 <= report.accuracy <= 1.0
