"""Port parity for the low-rank and moment-form pools: `core/prng`
(threefry + Ω), `core/pool` (`LowRankDeltaPool`, `MomentPool`,
`pool_nbytes`), the factor-form distances with the factor-Gram kernel's
plain version, and `fedelmy` through the `lowrank` and `moment` backends,
all against the JAX reference on the same inputs.

Tolerances:
* threefry keys, bits and uniforms bitwise; Ω's normals within 4 ulp
  (XLA's f32 erfinv polynomial reproduced; its log1p may differ by an
  ulp, which reads as at most 3 ulp in the normal);
* at full rank an appended member reconstructs to atol 1e-5 (QR in
  another order; values are O(1)); below full rank both packages
  project onto the range of Δ·Ω with the same Ω to 4 ulp, so the
  reconstructions agree to rtol/atol 1e-4 (QR's sensitivity to Ω);
* distances rtol 1e-5 (f32 sums over a few thousand terms, other order);
  the Gram's plain version within P·2⁻²³·(|A||A|ᵀ) elementwise of the
  Pallas kernel in interpret mode;
* fedelmy over 14 Adam steps: task losses rtol 1e-5; final params and
  the final pool's members atol 1e-5 for the moment backend (as the
  stacked slice's test). The lowrank backend appends below full rank
  (rank 4): each pool average, the next model's init, carries the
  projections' last-bit differences, and Adam's g/√v turns those of
  near-zero gradients into up to a few percent of the learning rate —
  atol 1e-4, a tenth of lr (measured 2.4e-5 in 2 of fc1.w's 4,096
  elements; a sign flip of a whole update would read ~1e-3).

The moment-form d1 has its exact gradient, 0, where the model equals the
pool mean (every client's first pool step). The reference's jitted step
computes it as a rounding residue (XLA contracts 2w − 2μ into a fused
multiply-add) that the 1/√1e-12 of the RMS and `log_scale`'s 1e5 blow up
to O(10), so its moment-form runs move away from the exact computation
in their first step (ROADMAP C6; its own eager, unjitted gradient is 0,
as the port's). The moment run is therefore held against the reference
with α = 0, and the d1 gradient separately: 0 at the tie, as the
reference's eager gradient; off the tie within 1e-5 of its jitted one.
Parameters come from the port's init carried across (the reference's CNN
init costs seconds to compile).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.core import distances as JD
from repro.core.pool import LowRankDeltaPool as JaxLowRankPool
from repro.core.pool import MomentPool as JaxMomentPool
from repro.core.pool import pool_nbytes as jax_pool_nbytes
from repro.data import batch_iterator as jax_batch_iterator
from repro.data import dirichlet_partition, make_image_dataset
from repro.kernels import ref as jref
from repro.kernels.pool_distance import factor_gram as jax_factor_gram
from repro.models import build_model as jax_build_model
from repro_torch.api import backend_for, list_pool_backends
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params, from_jax_pool, to_jax_params
from repro_torch.core import distances as TD
from repro_torch.core import prng
from repro_torch.core.pool import LowRankDeltaPool, MomentPool, pool_nbytes
from repro_torch.data import batch_iterator
from repro_torch.kernels.pool_distance import factor_gram
from repro_torch.kernels.ref import factor_gram_ref
from repro_torch.models import build_model

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ulps(a, b):
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max())


# ---------------------------------------------------------------------------
# 1. threefry and Ω
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,data,shape", [
    (0, 0, (5,)), (20240412, 3, (33, 7)), (20240412, 17, (2, 3, 4)),
    (12345, 2 ** 31 + 5, (1,))])
def test_threefry_keys_bits_and_uniforms_bitwise(seed, data, shape):
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    key = prng.fold_in(prng.prng_key(seed), data)
    np.testing.assert_array_equal(key, np.asarray(jax.random.key_data(jkey)))
    np.testing.assert_array_equal(
        prng.random_bits(key, shape),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)))
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    np.testing.assert_array_equal(
        prng.uniform(key, shape, lo, 1.0),
        np.asarray(jax.random.uniform(jkey, shape, jnp.float32, lo, 1.0)))


@pytest.mark.parametrize("leaf", [0, 5, 11])
def test_omega_within_four_ulps_of_jax(leaf):
    from repro_torch.core.pool import omega
    want = np.asarray(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(20240412), leaf), (512, 8),
        jnp.float32))
    got = omega(leaf, 512, 8)
    assert got.dtype == np.float32 and got.shape == (512, 8)
    assert _ulps(got, want) <= 4


# ---------------------------------------------------------------------------
# 2. pools against the reference
# ---------------------------------------------------------------------------

CNN = dataclasses.replace(get_arch("paper-cnn"), d_model=4, d_ff=16)
# reduced llama at 8 layers: its (8, 64) norm scales are factored
LLAMA8 = dataclasses.replace(get_arch("llama3.2-1b").reduced(), n_layers=8,
                             d_model=64, d_ff=128, vocab_size=96, head_dim=16)


def _inits(cfg, n):
    """n parameter sets of `cfg` from the port's init, as reference trees."""
    model = build_model(cfg, device="cpu")
    return [jax.tree.map(jnp.asarray, to_jax_params(model.init(s)))
            for s in range(n)]


def _pools(cfg, rank, n_appends=2):
    inits = _inits(cfg, n_appends + 1)
    jpool = JaxLowRankPool.create(inits[0], capacity=n_appends + 2,
                                  rank=rank)
    tpool = LowRankDeltaPool.create(from_jax_params(_np(inits[0]), "cpu"),
                                    capacity=n_appends + 2, rank=rank)
    for m in inits[1:]:
        jpool = jpool.append(m)
        tpool = tpool.append(from_jax_params(_np(m), "cpu"))
    return jpool, tpool


def _assert_params_close(got, want_tree, tol):
    want = from_jax_params(_np(want_tree), "cpu")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def cnn_pools():
    return _pools(CNN, 2)


@pytest.mark.parametrize("family", ["cnn", "llama8"])
def test_lowrank_pool_matches_reference(family, cnn_pools):
    # the CNN below full rank; the llama at rank 64, full rank everywhere
    jpool, tpool = cnn_pools if family == "cnn" else _pools(LLAMA8, 64)
    tol = 1e-4 if family == "cnn" else 1e-5
    # structure: which leaves are factored, at what rank, how many live
    assert sorted(tpool.u) == sorted(jpool.u)
    assert sorted(tpool.dense) == sorted(jpool.dense)
    assert {k: tuple(a.shape) for k, a in tpool.u.items()} == \
        {k: a.shape for k, a in jpool.u.items()}
    assert tpool.count == int(jpool.count) and tpool.rank == jpool.rank
    np.testing.assert_array_equal(tpool.mask().numpy(),
                                  np.asarray(jpool.mask()))
    if family == "llama8":      # the (L, D) norm scales are factored at L=8
        names = list(tpool.base)
        assert f"{names.index('layers.ln1.scale'):04d}" in tpool.u
    _assert_params_close(tpool.average(), jpool.average(), tol)
    for t in range(tpool.count):
        _assert_params_close(tpool.member(t), jpool.member(t), tol)
    _assert_params_close(tpool.materialize_members(),
                         jpool.materialize_members(), tol)
    assert pool_nbytes(tpool) == jax_pool_nbytes(jpool)
    # delta_tree: the same leaves in the same form, reconstructing alike
    deltas = tpool.delta_tree()
    assert list(deltas) == list(tpool.base)
    jdeltas = jax.tree.leaves(jpool.delta_tree(), is_leaf=lambda x: isinstance(
        x, tuple) and hasattr(x, "dense"))
    for (name, d), jd in zip(deltas.items(), jdeltas):
        assert (d.dense is None) == (jd.dense is None), name
        got = (d.dense if d.dense is not None
               else d.u @ d.v.transpose(-1, -2)).numpy()
        want = (np.asarray(jd.dense) if jd.dense is not None else np.einsum(
            "...ir,...or->...io", np.asarray(jd.u), np.asarray(jd.v)))
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                                   err_msg=name)


def test_full_rank_append_reconstructs_the_member():
    base = build_model(CNN, device="cpu").init(0)
    member = {k: v + 0.1 * torch.randn(v.shape, generator=torch.Generator()
                                       .manual_seed(i))
              for i, (k, v) in enumerate(base.items())}
    pool = LowRankDeltaPool.create(base, capacity=3, rank=10_000)
    pool = pool.append(member)
    got = pool.member(1)
    for k in base:
        np.testing.assert_allclose(got[k].numpy(), member[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(pool.first()["fc2.w"].numpy(),
                                  base["fc2.w"].numpy())


def test_moment_pool_matches_reference():
    inits = _inits(CNN, 5)
    jpool = JaxMomentPool.create(inits[0])
    tpool = MomentPool.create(from_jax_params(_np(inits[0]), "cpu"))
    for m in inits[1:4]:
        jpool = jpool.append(m)
        tpool = tpool.append(from_jax_params(_np(m), "cpu"))
    assert tpool.count == int(jpool.count) == 4
    _assert_params_close(tpool.average(), jpool.average(), 1e-6)
    np.testing.assert_allclose(float(tpool.sq_norm_mean),
                               float(jpool.sq_norm_mean), rtol=1e-6)
    probe = inits[4]
    np.testing.assert_allclose(
        float(TD.d1_moment(from_jax_params(_np(probe), "cpu"), tpool)),
        float(JD.d1_moment(probe, jpool)), rtol=1e-5)
    assert pool_nbytes(tpool) == jax_pool_nbytes(jpool)
    # carried across, it is the same pool
    carried = from_jax_pool(_np(jpool), "cpu")
    _assert_params_close(carried.average(), jpool.average(), 0)


# ---------------------------------------------------------------------------
# 3. factor-form distances and the Gram's plain version
# ---------------------------------------------------------------------------

def test_lowrank_distances_match_reference(cnn_pools):
    jpool, _ = cnn_pools
    tpool = from_jax_pool(_np(jpool), "cpu")
    probe = jax.tree.map(lambda a: a + 0.01, jpool.member(1))
    tprobe = from_jax_params(_np(probe), "cpu")
    np.testing.assert_allclose(TD.lowrank_member_sq(tprobe, tpool).numpy(),
                               np.asarray(JD.lowrank_member_sq(probe, jpool)),
                               rtol=1e-5)
    for measure in ("l2", "squared_l2"):
        np.testing.assert_allclose(
            float(TD.d1_lowrank(tprobe, tpool, measure)),
            float(JD.d1_lowrank(probe, jpool, measure)), rtol=1e-5)
    want = np.asarray(JD.lowrank_pairwise_sq(jpool))
    for gram in (factor_gram, factor_gram_ref):
        got = TD.lowrank_pairwise_sq(tpool, gram_fn=gram).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="l2/squared_l2"):
        TD.d1_lowrank(tprobe, tpool, "l1")


@pytest.mark.parametrize("b,m,p", [(1, 40, 2048), (3, 24, 3000),
                                   (2, 5, 77), (1, 16, 4097)])
def test_factor_gram_plain_matches_pallas_kernel(b, m, p):
    a = np.random.default_rng(b * 100 + p).normal(size=(b, m, p)).astype(
        np.float32)
    want = np.asarray(jax_factor_gram(jnp.asarray(a), interpret=True))
    got = factor_gram(torch.from_numpy(a)).numpy()
    bound = p * 2.0 ** -23 * np.einsum("bmp,bnp->bmn", np.abs(a), np.abs(a))
    assert np.all(np.abs(got - want) <= bound)
    np.testing.assert_allclose(got, np.asarray(jref.factor_gram_ref(a)),
                               rtol=0, atol=float(bound.max()))
    assert factor_gram(torch.from_numpy(a[0])).shape == (m, m)


# ---------------------------------------------------------------------------
# 4. fedelmy through the lowrank and moment backends
# ---------------------------------------------------------------------------

def test_moment_d1_gradient_exact_at_the_tie_and_off_it():
    inits = _inits(CNN, 2)
    jpool = JaxMomentPool.create(inits[0])
    tpool = MomentPool.create(from_jax_params(_np(inits[0]), "cpu"))

    def port_grad(tree):
        leaves = {k: v.requires_grad_(True)
                  for k, v in from_jax_params(_np(tree), "cpu").items()}
        g = torch.autograd.grad(TD.d1_moment(leaves, tpool),
                                list(leaves.values()))
        return dict(zip(leaves, g))

    at_tie = port_grad(inits[0])          # w == μ: the exact gradient is 0
    assert all(float(g.abs().max()) == 0.0 for g in at_tie.values())
    off = jax.tree.map(lambda a, b: 0.9 * a + 0.1 * b, *inits)
    want = from_jax_params(_np(jax.jit(jax.grad(
        lambda p: JD.d1_moment(p, jpool)))(off)), "cpu")
    for k, g in port_grad(off).items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


FED = dict(n_clients=2, pool_size=2, e_local=3, e_warmup=2,
           learning_rate=1e-3, alpha=0.06, beta=1.0)
BACKENDS = {"lowrank": dict(pool_backend="lowrank", pool_rank=4),
            "moment": dict(pool_backend="moment", alpha=0.0,
                           distance_measure="squared_l2")}


@pytest.fixture(scope="module", params=list(BACKENDS))
def fedelmy_runs(request):
    fed = dict(FED, **BACKENDS[request.param])
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("paper-cnn"), d_model=4, d_ff=16))
    tm = build_model(CNN, device="cpu")
    ds = make_image_dataset(n_samples=160, seed=0, noise=2.0)
    parts = dirichlet_partition(ds.labels, FED["n_clients"], 0.3, seed=0)
    arrays = [{"images": ds.images[p], "labels": ds.labels[p]}
              for p in parts]
    init = to_jax_params(tm.init(0))
    jres = J.launch(J.Experiment(
        model=jm, fed=JaxFedConfig(**fed), strategy="fedelmy",
        client_iters=[jax_batch_iterator(a, 8, seed=i)
                      for i, a in enumerate(arrays)],
        init_params=jax.tree.map(jnp.asarray, init)))
    tres = T.launch(T.Experiment(
        model=tm, fed=FedConfig(**fed), strategy="fedelmy",
        client_iters=[batch_iterator(a, 8, seed=i, device="cpu")
                      for i, a in enumerate(arrays)],
        init_params=from_jax_params(init, "cpu")))
    return request.param, jres, tres


def test_fedelmy_backends_match_reference(fedelmy_runs):
    backend, jres, tres = fedelmy_runs
    got = [m.task_loss for c in tres.clients for m in c.models]
    want = [m.task_loss for c in jres.clients for m in c.models]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tol = 1e-4 if backend == "lowrank" else 1e-5
    _assert_params_close(tres.params, jres.params, tol)
    pool = tres.final_pool
    assert type(pool).__name__ == type(jres.final_pool).__name__
    assert pool.count == int(jres.final_pool.count) == FED["pool_size"] + 1
    if backend == "lowrank":
        _assert_params_close(pool.materialize_members(),
                             jres.final_pool.materialize_members(), tol)
    else:
        _assert_params_close(pool.average(), jres.final_pool.average(), tol)


def test_fedconfig_rejects_measures_without_gram_form():
    assert list_pool_backends() == ["lowrank", "moment", "stacked"]
    for kw in (dict(pool_backend="lowrank", distance_measure="cosine"),
               dict(pool_backend="lowrank", distance_measure="l1"),
               dict(pool_backend="moment", distance_measure="l2")):
        with pytest.raises(ValueError) as port:
            FedConfig(**kw)
        with pytest.raises(ValueError) as ref:
            JaxFedConfig(**kw)
        assert str(port.value) == str(ref.value)
    assert backend_for(FedConfig(pool_backend="lowrank")).supported_measures \
        == ("l2", "squared_l2")
    # the registry's own check, for a config that skipped FedConfig's
    bad = dataclasses.replace(FedConfig(pool_backend="moment",
                                        distance_measure="squared_l2"))
    object.__setattr__(bad, "distance_measure", "l2")
    with pytest.raises(ValueError, match="supports distance measures"):
        backend_for(bad)
