"""Batched sweeps in the port (`repro_torch.api.batch`, behind
`launch(exp, axes=...)` and `launch([exp, ...])`; `plan.interpret_batched`)
on the CPU.

* Grouping against the reference's `repro.api.batch` on tiny linear
  models: `BatchAxes.expand`, the groups `_group_key` / `_batchable` form,
  `n_compiled_groups` and the result order of `launch(list)` and
  `launch(exp, axes=)` (singleton and callback fallbacks, split on a
  static FedConfig field or another loss, α/β kept in one group), and the
  shared-iterator error.
* Every plan strategy, batched over two seeds on the paper CNN at width 8
  / d_ff 16 (3 Dirichlet clients, pool_size 2, e_warmup 2, e_local 4,
  batch 8, test_torch_strategies.py's configuration), against the port's
  sequential run of each seed: final params atol 1e-5 (the bound
  test_torch_strategies.py holds between the packages: the batched
  steps' plain products and reductions round differently from the single
  ones by a few ulps a step, and Adam carries it on), per-model task
  losses rtol 1e-5, the final metric within one test sample. The batched scanned
  phase is bitwise the batched per-step loop over the same DataPlans. A
  run's clients may hold shards of different lengths (the stacked arrays
  pad to the longest).
* The port's batched fedelmy and dfedsam against the reference's
  sequential `launch` on the same numpy data from the same (converted)
  inits, at test_torch_strategies.py's tolerances (params atol 1e-5, task
  losses rtol 1e-5, metrics within one test sample). The reference's own
  batched-against-sequential bit-identity is among its failing tests, so
  its batched path is no oracle here.
* The Fig. 10 (α, β) grid as one group, each point held to its own
  sequential run."""
import dataclasses
import itertools
import warnings
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import repro.api as J
import repro_torch.api as T
from repro.api import batch as JB
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.data import DataPlan as JaxDataPlan
from repro.data import dirichlet_partition, make_image_dataset
from repro.models import build_model as jax_build_model
from repro_torch.api import batch as TB
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.data import DataPlan
from repro_torch.models import build_model

torch.set_num_threads(2)

# ---------------------------------------------------------------------------
# Tiny linear models for the grouping tests (one per package)
# ---------------------------------------------------------------------------

JaxTiny = namedtuple("JaxTiny", "init loss_fn forward")
TorchTiny = namedtuple("TorchTiny", "init loss_fn forward device")
TINY_FED = dict(n_clients=2, pool_size=2, e_local=3, e_warmup=2,
                learning_rate=1e-2)


def _jax_tiny():
    def init(key):
        return {"b": jnp.zeros((3,)),
                "w": 0.1 * jax.random.normal(key, (4, 3))}

    def forward(params, batch):
        return batch["x"] @ params["w"] + params["b"]

    def loss_fn(params, batch):
        onehot = jax.nn.one_hot(batch["y"], 3)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(forward(params, batch))
                                 * onehot, -1))

    return JaxTiny(init, loss_fn, forward)


def _torch_tiny():
    def init(seed):
        gen = torch.Generator().manual_seed(int(seed))
        return {"b": torch.zeros(3),
                "w": 0.1 * torch.randn(4, 3, generator=gen)}

    def forward(params, batch):
        return batch["x"] @ params["w"] + params["b"]

    def loss_fn(params, batch):
        return F.cross_entropy(forward(params, batch), batch["y"].long())

    return TorchTiny(init, loss_fn, forward, torch.device("cpu"))


def _tiny_iters(package):
    out = []
    for c in range(2):
        x = np.random.default_rng(c).standard_normal((8, 4), np.float32)
        y = np.arange(8) % 3
        batch = ({"x": jnp.asarray(x), "y": jnp.asarray(y)} if package == "jax"
                 else {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        out.append(itertools.cycle([batch]))
    return out


# each case: experiments as (strategy, FedConfig overrides, model slot,
# callback) in input order
GROUPING_CASES = {
    "mixed_and_callback": [("fedelmy", {}, 0, False),
                           ("metafed", {}, 0, False),
                           ("fedelmy", {}, 0, True),
                           ("fedelmy", {}, 0, False)],
    "static_field_splits": [("fedelmy", {}, 0, False),
                            ("fedelmy", {"distance_measure": "l1"}, 0, False),
                            ("fedelmy", {"alpha": 0.5, "beta": 2.0}, 0,
                             False)],
    "other_loss_splits": [("fedelmy", {}, 0, False),
                          ("fedelmy", {}, 1, False)],
    "baselines": [("dfedavgm", {}, 0, False), ("dfedsam", {}, 0, False),
                  ("dfedavgm", {}, 0, False), ("dfedsam", {}, 0, False),
                  ("local_only", {}, 0, False)],
}


def _experiments(package, case, seen):
    if package == "jax":
        api, fed0, models = J, JaxFedConfig(**TINY_FED), \
            [_jax_tiny(), _jax_tiny()]
    else:
        api, fed0, models = T, FedConfig(**TINY_FED), \
            [_torch_tiny(), _torch_tiny()]
    exps = []
    for i, (strategy, over, slot, callback) in enumerate(
            GROUPING_CASES[case]):
        cb = api.Callbacks(on_model_end=(
            (lambda rec, p: seen.append(rec.index)) if callback else None))
        seed_kw = ({"key": jax.random.PRNGKey(i % 2)} if package == "jax"
                   else {"seed": i % 2})
        exps.append(api.Experiment(
            model=models[slot], client_iters=_tiny_iters(package),
            fed=dataclasses.replace(fed0, **over), strategy=strategy,
            callbacks=cb, **seed_kw))
    return exps


def _partition(batch_mod, exps):
    groups, sequential = {}, []
    for i, e in enumerate(exps):
        if batch_mod._batchable(e):
            groups.setdefault(batch_mod._group_key(e), []).append(i)
        else:
            sequential.append(i)
    return sorted(groups.values()), sequential


@pytest.mark.parametrize("case", sorted(GROUPING_CASES))
def test_grouping_and_results_match_reference(case):
    seen_j, seen_t = [], []
    jexps = _experiments("jax", case, seen_j)
    texps = _experiments("torch", case, seen_t)
    assert _partition(TB, texps) == _partition(JB, jexps)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jres = J.launch(jexps)
        tres = T.launch(texps)
    assert isinstance(tres, T.BatchResult)
    assert tres.n_compiled_groups == jres.n_compiled_groups
    assert [r.strategy for r in tres] == [r.strategy for r in jres] == \
        [e.strategy for e in texps]
    assert seen_t == seen_j         # callbacks fired on the sequential path
    for r in tres:
        assert all(bool(torch.isfinite(v).all()) for v in r.params.values())


def test_batch_axes_expand_like_reference():
    calls = {"jax": [], "torch": []}

    def axes(mod, package):
        return mod.BatchAxes(
            seeds=[3, 5], fed_grid=[{"alpha": 0.1}, {"beta": 2.0}],
            strategy_options_grid=[{}, {"rho": 0.1}],
            client_iters_for_seed=lambda s: calls[package].append(
                ("seed", s)) or _tiny_iters(package),
            eval_fn_for_seed=lambda s: calls[package].append(("eval", s)),
            client_iters_for_run=lambda i: calls[package].append(
                ("run", i)) or _tiny_iters(package))

    jbase = J.Experiment(model=_jax_tiny(), client_iters=_tiny_iters("jax"),
                         fed=JaxFedConfig(**TINY_FED),
                         strategy_options={"rho": 0.05})
    tbase = T.Experiment(model=_torch_tiny(),
                         client_iters=_tiny_iters("torch"),
                         fed=FedConfig(**TINY_FED),
                         strategy_options={"rho": 0.05})
    jexps = axes(J, "jax").expand(jbase)
    texps = axes(T, "torch").expand(tbase)
    assert len(texps) == len(jexps) == 8
    assert calls["torch"] == calls["jax"]
    for je, te in zip(jexps, texps):
        assert (te.fed.alpha, te.fed.beta) == (je.fed.alpha, je.fed.beta)
        assert te.strategy_options == je.strategy_options
        assert np.array_equal(np.asarray(je.key),
                              np.asarray(jax.random.PRNGKey(te.seed)))
    empty = T.launch([])
    assert len(empty) == 0 and empty.n_compiled_groups == 0
    with pytest.raises(ValueError, match="Experiment"):
        TB._run_batch(axes=axes(T, "torch"))


def test_shared_iterators_rejected_like_reference():
    for api, model, package, seed_kw in (
            (J, _jax_tiny(), "jax", {"key": jax.random.PRNGKey(0)}),
            (T, _torch_tiny(), "torch", {"seed": 0})):
        fed = (JaxFedConfig if package == "jax" else FedConfig)(**TINY_FED)
        base = api.Experiment(model=model, client_iters=_tiny_iters(package),
                              fed=fed, strategy="fedelmy", **seed_kw)
        with pytest.raises(ValueError, match="share client iterator"):
            api.launch(base, axes=api.BatchAxes(seeds=[0, 1]))


def test_launch_raises_for_what_is_not_ported():
    from repro_torch.scenarios import get_fleet
    exp = T.Experiment(model=_torch_tiny(), client_iters=_tiny_iters("torch"),
                       fed=FedConfig(**TINY_FED))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.launch(exp, mesh=object())
    # fleets are ported: a fleet runs through launch; its mesh= does not
    cnn = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=8,
                                          d_ff=16), device="cpu")
    fleet = get_fleet("fleet_smoke").replace(rounds=1, cohort_size=2,
                                             samples_per_client=16,
                                             batch_size=8, n_test=32)
    fed = FedConfig(**dict(TINY_FED, e_local=1))
    res = T.launch(fleet, cnn, fed=fed)
    assert isinstance(res, T.FleetResult) and res.clients_trained == 2
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.launch(fleet, cnn, fed=fed, mesh=object())
    with pytest.raises(NotImplementedError, match="not ported yet"):
        T.interpret_batched([exp, exp], T.get_plan("fedelmy"),
                            mesh=object())
    with pytest.warns(DeprecationWarning, match="launch"):
        out = T.run_batch(exp)
    assert len(out) == out.n_compiled_groups == 1


# ---------------------------------------------------------------------------
# The paper CNN: every strategy batched against its sequential runs
# ---------------------------------------------------------------------------

FED = dict(n_clients=3, pool_size=2, e_local=4, e_warmup=2,
           learning_rate=1e-3, alpha=0.06, beta=1.0)
BATCH = 8
N_TEST = 60
SEEDS = (0, 1)
PARAM_ATOL = 1e-5


@pytest.fixture(scope="module")
def cnn():
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("paper-cnn"), d_model=8, d_ff=16))
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=8,
                                         d_ff=16), device="cpu")
    ds = make_image_dataset(n_samples=240 + N_TEST, seed=0, noise=2.0)
    train = (ds.images[:240], ds.labels[:240])
    test = {"images": ds.images[240:], "labels": ds.labels[240:]}
    # each seed its own partition: the runs' shards at one rank differ
    shards = {s: [{"images": train[0][p], "labels": train[1][p]}
                  for p in dirichlet_partition(train[1], FED["n_clients"],
                                               0.3, seed=s)]
              for s in SEEDS}
    inits = {s: from_jax_params(jax.tree.map(
        np.asarray, jm.init(jax.random.PRNGKey(s))), "cpu") for s in SEEDS}
    for s in SEEDS:   # fedelmy_pfl's per-client inits (by the port's seeds)
        keys = jax.random.split(jax.random.PRNGKey(s), FED["n_clients"])
        for ps, k in zip(T.per_client_seeds(s, FED["n_clients"]), keys):
            inits[ps] = from_jax_params(jax.tree.map(np.asarray, jm.init(k)),
                                        "cpu")
    timages = torch.from_numpy(test["images"])
    tlabels = torch.from_numpy(test["labels"])

    def t_eval(params):
        with torch.no_grad():
            logits = tm.forward(params, {"images": timages})
        return float((logits.argmax(-1) == tlabels).float().mean())

    def j_eval(params):
        logits = jm.forward(params, {"images": jnp.asarray(test["images"])})
        return float(jnp.mean(jnp.argmax(logits, -1) == test["labels"]))

    return dict(jm=jm, tm=tm._replace(init=lambda s: dict(inits[s])),
                shards=shards, t_eval=t_eval, j_eval=j_eval)


def _plans(cnn, seed, scan):
    return [DataPlan(a, BATCH, seed=10 * seed + i, scan=scan, device="cpu")
            for i, a in enumerate(cnn["shards"][seed])]


def _torch_exp(cnn, strategy, seed, scan=True, **kw):
    return T.Experiment(model=cnn["tm"], client_iters=_plans(cnn, seed, scan),
                        fed=FedConfig(**FED), strategy=strategy, seed=seed,
                        eval_fn=cnn["t_eval"],
                        shots=2 if strategy == "fedelmy_fewshot" else 1, **kw)


def _batched(cnn, strategy, scan):
    base = _torch_exp(cnn, strategy, SEEDS[0], scan)
    return T.launch(base, axes=T.BatchAxes(
        seeds=SEEDS, client_iters_for_seed=lambda s: _plans(cnn, s, scan)))


def _model_losses(res):
    recs = res.clients or []
    return [m.task_loss for c in recs for m in c.models]


def _assert_run_close(got, want, what):
    assert list(got.params) == list(want.params)
    for k, w in want.params.items():
        err = float((got.params[k] - w).abs().max())
        assert err <= PARAM_ATOL, f"{what} {k}: {err:.2e}"
    np.testing.assert_allclose(_model_losses(got), _model_losses(want),
                               rtol=1e-5, err_msg=what)
    if want.final_metric is not None:
        assert abs(got.final_metric - want.final_metric) <= \
            1.0 / N_TEST + 1e-6, what
    assert (got.final_pool is None) == (want.final_pool is None), what


STRATEGIES = ["fedelmy", "fedelmy_fewshot", "fedelmy_pfl", "fedseq",
              "dfedavgm", "dfedsam", "metafed", "local_only"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_every_strategy_batched_matches_its_sequential_runs(cnn, strategy):
    scanned = _batched(cnn, strategy, scan=True)
    per_step = _batched(cnn, strategy, scan=False)
    assert scanned.n_compiled_groups == per_step.n_compiled_groups == 1
    for seed, a, b in zip(SEEDS, scanned, per_step):
        for k in a.params:        # the batched scanned phase: bitwise
            assert torch.equal(a.params[k], b.params[k]), (seed, k)
        assert _model_losses(a) == _model_losses(b)
        seq = T.launch(_torch_exp(cnn, strategy, seed, scan=False))
        _assert_run_close(a, seq, f"{strategy} seed {seed}")


@pytest.mark.parametrize("strategy", ["fedelmy", "dfedsam"])
def test_batched_port_matches_reference_sequential(cnn, strategy):
    batch = _batched(cnn, strategy, scan=True)
    opts = {"rho": 0.05} if strategy == "dfedsam" else {}
    for seed, tres in zip(SEEDS, batch):
        jres = J.launch(J.Experiment(
            model=cnn["jm"], fed=JaxFedConfig(**FED), strategy=strategy,
            key=jax.random.PRNGKey(seed), eval_fn=cnn["j_eval"],
            strategy_options=opts,
            client_iters=[JaxDataPlan(a, BATCH, seed=10 * seed + i,
                                      scan=False)
                          for i, a in enumerate(cnn["shards"][seed])]))
        ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
        for k in ref:
            np.testing.assert_allclose(tres.params[k].numpy(),
                                       ref[k].numpy(), rtol=0, atol=1e-5,
                                       err_msg=f"{strategy} {seed} {k}")
        np.testing.assert_allclose(
            _model_losses(tres),
            [m.task_loss for c in jres.clients for m in c.models], rtol=1e-5)
        assert abs(tres.final_metric - float(jres.final_metric)) <= \
            1.0 / N_TEST + 1e-6


def test_alpha_beta_grid_is_one_group_held_to_each_point(cnn):
    grid = [{"alpha": a, "beta": b} for a in (0.02, 0.18) for b in (0.25, 4.0)]
    base = _torch_exp(cnn, "fedelmy", 0)
    batch = T.launch(base, axes=T.BatchAxes(
        fed_grid=grid, client_iters_for_run=lambda i: _plans(cnn, 0, True)))
    assert batch.n_compiled_groups == 1 and len(batch) == len(grid)
    for point, res in zip(grid, batch):
        assert (res.fed.alpha, res.fed.beta) == (point["alpha"],
                                                 point["beta"])
        seq = T.launch(dataclasses.replace(
            base, fed=dataclasses.replace(base.fed, **point),
            client_iters=_plans(cnn, 0, False)))
        _assert_run_close(res, seq, f"grid {point}")
