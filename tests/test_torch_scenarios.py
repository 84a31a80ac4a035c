"""Port parity for `repro_torch.scenarios` and the partitioners of
`repro_torch.data.partition` against the JAX package's, on the CPU.

* Every ported partitioner is bitwise the reference's, over seeds and
  parameters.
* `materialize` of every registered scenario, at small `n`, is bitwise the
  reference's per client and for the eval split. Both sides run in one
  process: `domain_shift` draws in the order of a set of domain names,
  which follows the process's string hashing.
* `build_experiments`' structure: one Experiment per (strategy, seed), in
  order, `fed.n_clients` the spec's active count, fresh DataPlan streams
  on the model's device, the eval split's accuracy.
* `launch(spec)` (a strategy's seeds one batched group, `n_compiled_groups`
  1 as the reference counts it) on the paper CNN at width 8 / d_ff 16 (e_warmup 2,
  e_local 4, pool_size 2, batch 8) against the reference's
  `launch(Experiment)` per seed on the same scenario's per-step streams,
  from the same init: final params atol 1e-5, per-model task losses rtol
  1e-5, the final accuracy within one eval sample (test_torch_fedelmy.py's
  tolerances); `launch` by registered name; the parts not ported raise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as J
import repro.scenarios as JS
import repro_torch.api as T
import repro_torch.scenarios as TS
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.data import partition as JP
from repro.data import synthetic as JSyn
from repro.models import build_model as jax_build_model
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.data import DataPlan
from repro_torch.data import partition as TP
from repro_torch.data import synthetic as TSyn
from repro_torch.models import build_model

torch.set_num_threads(2)

FED = dict(n_clients=3, pool_size=2, e_local=4, e_warmup=2,
           learning_rate=1e-3, alpha=0.06, beta=1.0)
SMALL = dict(n_samples=240, n_test=60, batch_size=8)


def _labels(seed, n=300):
    return JSyn.make_image_dataset(n, seed=seed, side=8).labels


def _same_parts(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


# ---------------------------------------------------------------------------
# partitioners
# ---------------------------------------------------------------------------

INDEX_CASES = [
    ("shard_partition", dict(n_clients=4, classes_per_client=2)),
    ("shard_partition", dict(n_clients=7, classes_per_client=3)),
    ("quantity_skew_partition", dict(n_clients=4, beta=0.5)),
    ("quantity_skew_partition", dict(n_clients=6, beta=0.3, min_size=3)),
    ("mixed_skew_partition", dict(n_clients=4)),
    ("mixed_skew_partition", dict(n_clients=5, beta_label=0.1,
                                  beta_quantity=1.0, min_size=3)),
    ("dirichlet_partition", dict(n_clients=4, beta=0.3)),
]


@pytest.mark.parametrize("name,kw", INDEX_CASES)
@pytest.mark.parametrize("seed", [0, 3])
def test_index_partitioners_bitwise(name, kw, seed):
    labels = _labels(seed)
    _same_parts(getattr(TP, name)(labels, seed=seed, **kw),
                getattr(JP, name)(labels, seed=seed, **kw))


@pytest.mark.parametrize("name,kw", [
    ("shard_partition", dict(n_clients=200, classes_per_client=2)),
    ("quantity_skew_partition", dict(n_clients=4, min_size=100)),
    ("mixed_skew_partition", dict(n_clients=400)),
    ("shard_partition", dict(n_clients=4, classes_per_client=1,
                             min_size=100))])
def test_unsatisfiable_requests_raise_as_the_reference(name, kw):
    labels = _labels(1)
    with pytest.raises(ValueError) as want:
        getattr(JP, name)(labels, **kw)
    with pytest.raises(ValueError) as got:
        getattr(TP, name)(labels, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(), dict(max_severity=0.5),
                                dict(severities=(0.0, 1.0, 0.3)),
                                dict(domains=("sketch",), seed=4)])
def test_feature_shift_partition_bitwise(kw):
    ds = JSyn.make_image_dataset(90, seed=2, side=8)
    tds = TSyn.SyntheticImageDataset(ds.images, ds.labels, ds.n_classes)
    got = TP.feature_shift_partition(tds, 3, **kw)
    want = JP.feature_shift_partition(ds, 3, **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.images, w.images)
        assert np.array_equal(g.labels, w.labels)
    with pytest.raises(ValueError, match="severities"):
        TP.feature_shift_partition(tds, 3, severities=(0.1,))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_severity_ladder_and_train_val_split(n):
    assert TP.severity_ladder(n, 0.8) == JP.severity_ladder(n, 0.8)
    for seed in (0, 9):
        for got, want in zip(TP.train_val_split(50 * n, 0.1, seed=seed),
                             JP.train_val_split(50 * n, 0.1, seed=seed)):
            assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# materialize, the registry
# ---------------------------------------------------------------------------

def test_registries_match():
    assert TS.list_scenarios() == JS.list_scenarios()
    assert TS.list_partitioners() == JS.list_partitioners()
    for name in TS.list_scenarios():
        got = dataclasses.asdict(TS.get_scenario(name))
        assert got == dataclasses.asdict(JS.get_scenario(name))
    for name in TS.list_partitioners():
        assert TS.get_partitioner(name).kind == \
            JS.get_partitioner(name).kind


@pytest.mark.parametrize("name", sorted(JS.list_scenarios()))
@pytest.mark.parametrize("seed", [0, 1])
def test_materialize_bitwise(name, seed):
    kw = dict(n_samples=160, n_test=40, side=8)
    got = TS.materialize(TS.get_scenario(name).replace(**kw), seed)
    want = JS.materialize(JS.get_scenario(name).replace(**kw), seed)
    assert got.client_ids == want.client_ids
    assert got.sizes() == want.sizes() and got.n_classes == want.n_classes
    for g, w in zip(got.client_data + [got.eval_data],
                    want.client_data + [want.eval_data]):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    for g, w in zip(got.client_val, want.client_val):
        assert (g is None) == (w is None)


@pytest.mark.parametrize("spec_kw", [
    dict(eval_split="holdout", val_frac=0.2),
    dict(stragglers=(0, 2), straggler_keep=0.1, batch_size=64),
    dict(participation=0.5, dropout=(1,))])
def test_materialize_population_knobs_bitwise(spec_kw):
    base = dict(n_samples=160, n_test=40, side=8, **spec_kw)
    got = TS.materialize(TS.get_scenario("dir_label_skew").replace(**base),
                         3)
    want = JS.materialize(JS.get_scenario("dir_label_skew").replace(**base),
                          3)
    assert got.client_ids == want.client_ids and got.sizes() == want.sizes()
    for g, w in zip(got.client_val, want.client_val):
        assert (g is None) == (w is None)
        if g is not None:
            assert all(np.array_equal(g[k], w[k]) for k in w)
    for i in range(len(got.client_data)):
        for k, v in want._tiled_client(i).items():
            assert np.array_equal(got._tiled_client(i)[k], v)


def test_spec_validation_matches():
    for bad in (dict(family="nope"), dict(eval_split="x"),
                dict(participation=0.0), dict(dropout=(9,)),
                dict(dropout=(0, 1, 2, 3))):
        with pytest.raises(ValueError) as want:
            JS.ScenarioSpec(name="x", **{"family": "label_skew",
                                         "partitioner": "dirichlet", **bad})
        with pytest.raises(ValueError) as got:
            TS.ScenarioSpec(name="x", **{"family": "label_skew",
                                         "partitioner": "dirichlet", **bad})
        assert str(got.value) == str(want.value)
    spec = TS.get_scenario("partial_participation")
    assert spec.n_active == JS.get_scenario("partial_participation").n_active
    for seed in range(4):
        assert spec.active_clients(seed) == JS.get_scenario(
            "partial_participation").active_clients(seed)


def test_streams_are_one_batch_sequence():
    data = TS.materialize(TS.get_scenario("quantity_skew").replace(
        n_samples=160, n_test=40, side=8, batch_size=16), 0)
    plans = data.streams(to="cpu")
    per_step = data.streams(scan=False, to="cpu")
    iters = data.streams(device=False, to="cpu")
    assert all(isinstance(p, DataPlan) and p.scan for p in plans)
    assert not any(p.scan for p in per_step)
    # the device arrays are uploaded once per materialization
    assert plans[0].arrays["images"].data_ptr() == \
        per_step[0].arrays["images"].data_ptr()
    for p, q, it in zip(plans, per_step, iters):
        for _ in range(12):
            a, b, c = next(p), next(q), next(it)
            for k in a:
                assert torch.equal(a[k], b[k]) and torch.equal(a[k], c[k])


# ---------------------------------------------------------------------------
# build_experiments and launch(spec)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("paper-cnn"), d_model=8, d_ff=16))
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=8,
                                         d_ff=16), device="cpu")
    inits = {s: from_jax_params(jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(s))), "cpu") for s in (0, 1)}
    return jm, tm._replace(init=lambda s: dict(inits[s]))


def test_build_experiments_structure(models):
    _, tm = models
    spec = TS.get_scenario("partial_participation").replace(**SMALL)
    exps = TS.build_experiments(spec, tm, fed=FedConfig(**FED),
                                strategies=("fedelmy", "fedseq"),
                                seeds=(0, 1), scan=False)
    assert [(e.strategy, e.seed) for e in exps] == [
        ("fedelmy", 0), ("fedelmy", 1), ("fedseq", 0), ("fedseq", 1)]
    assert all(e.fed.n_clients == spec.n_active == 3 for e in exps)
    assert all(len(e.client_iters) == spec.n_active for e in exps)
    assert all(isinstance(it, DataPlan) and not it.scan and
               it.device == tm.device for e in exps for it in e.client_iters)
    # fresh cursors per experiment, shared device arrays per seed
    assert exps[0].client_iters[0] is not exps[2].client_iters[0]
    assert exps[0].client_iters[0].arrays["images"].data_ptr() == \
        exps[2].client_iters[0].arrays["images"].data_ptr()
    acc = float(exps[0].eval_fn(tm.init(0)))
    assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("scenario", ["dir_label_skew", "domain_shift"])
def test_launch_spec_matches_reference_per_seed(models, scenario):
    jm, tm = models
    seeds = (0, 1)
    spec_kw = dict(SMALL, n_clients=3)
    tspec = TS.get_scenario(scenario).replace(**spec_kw)
    batch = T.launch(tspec, tm, fed=FedConfig(**FED),
                     strategies=("fedelmy",), seeds=seeds)
    assert isinstance(batch, T.BatchResult)
    # the seeds of one strategy are one batched group, as the reference's
    assert len(batch) == len(seeds) and batch.n_compiled_groups == 1
    jspec = JS.get_scenario(scenario).replace(**spec_kw)
    for seed, tres in zip(seeds, batch):
        data = JS.materialize(jspec, seed)
        jres = J.launch(J.Experiment(
            model=jm, fed=JaxFedConfig(**FED), strategy="fedelmy",
            key=jax.random.PRNGKey(seed),
            client_iters=data.streams(scan=False),
            eval_fn=JS.accuracy_eval(jm, data)))
        ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
        for k in ref:
            np.testing.assert_allclose(tres.params[k].numpy(),
                                       ref[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"seed {seed} {k}")
        np.testing.assert_allclose(
            [m.task_loss for c in tres.clients for m in c.models],
            [m.task_loss for c in jres.clients for m in c.models],
            rtol=1e-5)
        n_eval = len(data.eval_data["labels"])
        assert abs(tres.final_metric - float(jres.final_metric)) <= \
            1.0 / n_eval + 1e-6


def test_launch_dispatch(models):
    _, tm = models
    fed = FedConfig(**FED)
    tiny = dict(SMALL, n_clients=2)
    by_name = T.launch("dir_label_skew", tm, fed=dataclasses.replace(
        fed, e_local=1, e_warmup=1, pool_size=1), strategies=("fedseq",))
    assert isinstance(by_name, T.BatchResult) and len(by_name) == 1
    spec = TS.get_scenario("dir_label_skew").replace(**tiny)
    exps = TS.build_experiments(spec, tm, fed=dataclasses.replace(
        fed, e_local=1, e_warmup=1), strategies=("fedseq", "local_only"))
    batch = T.launch(exps)
    assert [r.strategy for r in batch] == ["fedseq", "local_only"]
    assert batch.final_metrics() == [r.final_metric for r in batch.runs]
    with pytest.raises(ValueError, match="model= and fed="):
        T.launch(spec, tm)
    # names resolve to fleets first, then scenarios, as the reference's
    from repro_torch.api.launch import _resolve_name
    assert _resolve_name("fleet_100k") is TS.get_fleet("fleet_100k")
    assert _resolve_name("dir_label_skew") is \
        TS.get_scenario("dir_label_skew")
    with pytest.raises(ValueError, match="neither a registered fleet"):
        T.launch("no_such_scenario", tm, fed=fed)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.launch(exps[0], mesh=object())
    fleet = TS.get_fleet("fleet_smoke").replace(
        rounds=1, cohort_size=2, samples_per_client=16, batch_size=8,
        n_test=32)
    res = T.launch(fleet, tm, fed=dataclasses.replace(fed, e_local=1))
    assert isinstance(res, T.FleetResult) and res.clients_trained == 2
    with pytest.raises(TypeError, match="cannot dispatch"):
        T.launch(3.0)
