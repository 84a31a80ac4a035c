"""The scanned local phase of the port (`LocalTrainer.train_scanned`,
`local_client_train_scanned`, `api.trainer.ScannedPhase`) and the
interpreter's routing of `DataPlan` streams, on the CPU, on the paper CNN
at width 8 / d_ff 16, 3 Dirichlet clients, pool_size 2, e_warmup 2,
e_local 4, batch 8 (test_torch_strategies.py's configuration).

* The scanned phase is bitwise the port's per-step path over the same
  DataPlan stream: trainer calls (two visits of different clients on one
  trainer, so the buffers are reloaded and grown) and whole runs of
  several strategies.
* It matches the JAX package's per-step path over its own DataPlan
  streams (`scan=False`) from the same init: per-model task losses rtol
  1e-5, final params and the final pool atol 1e-5, as
  test_torch_fedelmy.py holds the iterator path. (The reference's own
  scanned path is not the oracle: its bit-identity with its per-step
  path is among its failing tests.) These bounds hold runs in which no
  discontinuous decision of the forward falls differently in the two
  packages (test_torch_strategies.py's docstring): at e_local 3 the two
  packages' metafed runs end with fc1.w 1.9e-5 apart, over iterators as
  over plans, scanned or not; at e_local 4, 5.8e-7 apart.
* Routing: plain and pool visits of scan-wanting plans take the scanned
  methods; custom blocks, per-model callbacks, `scan=False` plans and
  `batch_iterator` streams keep the per-step loop.
* Adam's step as an int32 tensor equals the int step, bitwise; the
  capture-aware launch counting of `kernels.build` adds a capture's
  launches once per replay."""
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
from repro.data import DataPlan as JaxDataPlan
from repro.data import dirichlet_partition, make_image_dataset
from repro.models import build_model as jax_build_model
from repro_torch.api.trainer import LocalTrainer
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params, from_jax_pool
from repro_torch.data import DataPlan, batch_iterator
from repro_torch.kernels import build
from repro_torch.models import build_model
from repro_torch.optim import optimizers as TO

torch.set_num_threads(2)

FED = dict(n_clients=3, pool_size=2, e_local=4, e_warmup=2,
           learning_rate=1e-3, alpha=0.06, beta=1.0)
SEED = 0
BATCH = 8


@pytest.fixture(scope="module")
def setup():
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("paper-cnn"), d_model=8, d_ff=16))
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=8,
                                         d_ff=16), device="cpu")
    ds = make_image_dataset(n_samples=240, seed=0, noise=2.0)
    parts = dirichlet_partition(ds.labels, FED["n_clients"], 0.3, seed=0)
    arrays = [{"images": ds.images[p], "labels": ds.labels[p]}
              for p in parts]
    key = jax.random.PRNGKey(SEED)
    inits = {SEED: jm.init(key)}
    for s, k in zip(T.per_client_seeds(SEED, FED["n_clients"]),
                    jax.random.split(key, FED["n_clients"])):
        inits[s] = jm.init(k)
    torch_inits = {s: from_jax_params(jax.tree.map(np.asarray, p), "cpu")
                   for s, p in inits.items()}
    return dict(jm=jm, tm=tm._replace(init=lambda s: dict(torch_inits[s])),
                arrays=arrays)


def _plans(arrays, scan):
    return [DataPlan(a, BATCH, seed=i, scan=scan, device="cpu")
            for i, a in enumerate(arrays)]


def _assert_equal_trees(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _assert_equal_pools(a, b):
    assert type(a) is type(b)
    for x, y in zip(a, b):
        if isinstance(x, dict):
            _assert_equal_trees(x, y)
        else:
            assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# scanned = per-step, bitwise, in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["stacked", "moment", "lowrank"])
def test_trainer_scanned_bitwise_to_per_step(setup, backend):
    tm, arrays = setup["tm"], setup["arrays"]
    kw = {"stacked": {}, "moment": dict(pool_backend="moment",
                                        distance_measure="squared_l2"),
          "lowrank": dict(pool_backend="lowrank", pool_rank=4)}[backend]
    fed = FedConfig(**FED, **kw)
    per_step = LocalTrainer(tm.loss_fn, fed)
    scanned = LocalTrainer(tm.loss_fn, fed)
    a, b = _plans(arrays, False), _plans(arrays, True)
    m_a = m_b = tm.init(SEED)
    m_a, _ = per_step.train(m_a, a[0], fed.e_warmup)
    m_b, _ = scanned.train_scanned(m_b, b[0], fed.e_warmup)
    _assert_equal_trees(m_a, m_b)
    for c in (0, 2, 1):
        m_a, pool_a, rec_a = per_step.local_client_train(m_a, a[c])
        m_b, pool_b, rec_b = scanned.local_client_train_scanned(m_b, b[c])
        _assert_equal_trees(m_a, m_b)
        _assert_equal_pools(pool_a, pool_b)
        assert [(r.index, r.task_loss) for r in rec_a] == \
            [(r.index, r.task_loss) for r in rec_b]
    # the cursors moved alike, and the CPU route captured nothing
    assert np.array_equal(a[1].take(2).numpy(), b[1].take(2).numpy())
    assert scanned.scanned.captures == scanned.scanned.replays == 0


def test_returned_pool_does_not_alias_the_buffers(setup):
    tm, arrays = setup["tm"], setup["arrays"]
    trainer = LocalTrainer(tm.loss_fn, FedConfig(**FED))
    plans = _plans(arrays, True)
    m, pool, _ = trainer.local_client_train_scanned(tm.init(SEED), plans[0])
    kept = {k: v.clone() for k, v in pool.members.items()}
    kept_m = {k: v.clone() for k, v in m.items()}
    trainer.local_client_train_scanned(m, plans[1])
    _assert_equal_trees(pool.members, kept)
    _assert_equal_trees(m, kept_m)
    assert int(pool.count) == FED["pool_size"] + 1


STRATEGIES = ["fedelmy", "fedseq", "metafed", "fedelmy_pfl", "dfedavgm",
              "fedelmy_fewshot"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_runs_scanned_bitwise_to_per_step(setup, strategy):
    tm, arrays = setup["tm"], setup["arrays"]

    def run(scan):
        return T.launch(T.Experiment(
            model=tm, fed=FedConfig(**FED), strategy=strategy, seed=SEED,
            client_iters=_plans(arrays, scan),
            shots=2 if strategy == "fedelmy_fewshot" else 1))

    a, b = run(False), run(True)
    _assert_equal_trees(a.params, b.params)
    assert [[(m.index, m.task_loss) for m in c.models] for c in a.clients] \
        == [[(m.index, m.task_loss) for m in c.models] for c in b.clients]
    if a.final_pool is not None:
        _assert_equal_pools(a.final_pool, b.final_pool)


# ---------------------------------------------------------------------------
# scanned (port) against the reference's per-step path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", ["fedelmy", "fedseq", "metafed",
                                      "fedelmy_pfl"])
def test_scanned_matches_reference_per_step(setup, strategy):
    jm, tm, arrays = setup["jm"], setup["tm"], setup["arrays"]
    jres = J.launch(J.Experiment(
        model=jm, fed=JaxFedConfig(**FED), strategy=strategy,
        key=jax.random.PRNGKey(SEED),
        client_iters=[JaxDataPlan(a, BATCH, seed=i, scan=False)
                      for i, a in enumerate(arrays)]))
    tres = T.launch(T.Experiment(
        model=tm, fed=FedConfig(**FED), strategy=strategy, seed=SEED,
        client_iters=_plans(arrays, True)))
    ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
    for k in ref:
        np.testing.assert_allclose(tres.params[k].numpy(), ref[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    got = [m.task_loss for c in tres.clients for m in c.models]
    want = [m.task_loss for c in jres.clients for m in c.models]
    assert len(got) == len(want)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if jres.final_pool is not None:
        jpool = from_jax_pool(jax.tree.map(np.asarray, jres.final_pool),
                              "cpu")
        assert int(tres.final_pool.count) == int(jpool.count)
        for k, s in jpool.members.items():
            np.testing.assert_allclose(tres.final_pool.members[k].numpy(),
                                       s.numpy(), rtol=0, atol=1e-5,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

ROUTES = ("train", "train_scanned", "local_client_train",
          "local_client_train_scanned")


@pytest.fixture
def calls(monkeypatch):
    seen = {name: 0 for name in ROUTES}
    for name in ROUTES:
        orig = getattr(LocalTrainer, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            seen[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(LocalTrainer, name, counted)
    return seen


@pytest.mark.parametrize("case,want", [
    # (strategy, streams, callback) → calls of each route
    (("fedelmy", "plan", False), dict(train_scanned=1,
                                      local_client_train_scanned=3)),
    (("fedelmy", "plan", True), dict(train_scanned=1, local_client_train=3,
                                     train=6)),
    (("fedelmy", "plan_noscan", False), dict(train=7,
                                             local_client_train=3)),
    (("fedelmy", "iterator", False), dict(train=7, local_client_train=3)),
    (("fedseq", "plan", False), dict(train_scanned=3)),
    (("metafed", "plan", False), dict(train_scanned=3, train=3)),
    (("dfedsam", "plan", False), dict(train=3)),
    (("fedelmy_pfl", "plan", False), dict(train_scanned=3,
                                          local_client_train_scanned=3)),
], ids=lambda c: "-".join(map(str, c)) if isinstance(c, tuple) else None)
def test_routing_as_the_reference(setup, calls, case, want):
    strategy, streams, callback = case
    tm, arrays = setup["tm"], setup["arrays"]
    its = {"plan": lambda: _plans(arrays, True),
           "plan_noscan": lambda: _plans(arrays, False),
           "iterator": lambda: [batch_iterator(a, BATCH, seed=i,
                                               device="cpu")
                                for i, a in enumerate(arrays)]}[streams]()
    cb = T.Callbacks(on_model_end=lambda rec, p: None) if callback \
        else T.Callbacks()
    T.launch(T.Experiment(model=tm, fed=FedConfig(**FED), strategy=strategy,
                          seed=SEED, client_iters=its, callbacks=cb))
    assert calls == {name: want.get(name, 0) for name in ROUTES}


# ---------------------------------------------------------------------------
# Adam's device step; the launch counters under capture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,wd", [("adam", 1e-4), ("adam", 0.0),
                                     ("adamw", 1e-4)])
def test_adam_device_step_equals_int_step(name, wd):
    rng = np.random.default_rng(3)
    p0 = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for k, s in (("w", (7, 5)), ("b", (5,)))}
    opt = TO.make_optimizer(name, 1e-3, weight_decay=wd)
    pa, sa = dict(p0), opt.init(p0)
    pb, sb = dict(p0), opt.init(p0)
    step = torch.zeros((), dtype=torch.int32)
    for s in range(6):
        g = {k: torch.from_numpy(rng.normal(size=v.shape).astype(
            np.float32)) for k, v in p0.items()}
        pa, sa = opt.update(pa, g, sa, s)
        pb, sb = opt.update(pb, g, sb, step)
        step = step + 1
        _assert_equal_trees(pa, pb)
        _assert_equal_trees(sa["m"], sb["m"])
        _assert_equal_trees(sa["v"], sb["v"])


def test_capture_counts_add_once_per_replay():
    def wrapper():
        pass
    wrapper.launches = 0
    build.count_launches(wrapper, 2)          # no capture: counted now
    assert wrapper.launches == 2
    with build.capture_counts() as counts:
        build._captured[wrapper] = 3          # what a capture tallies
    assert counts == {wrapper: 3} and not build._captured
    build.add_replays(counts, 4)
    assert wrapper.launches == 2 + 12


def test_a_finished_run_frees_without_the_cycle_collector(setup):
    """The trainer → scanned phase link is one way: a run's trainer (and
    with it its graphs and buffers) goes when its last reference does,
    never later in a collection that could fall inside another run's
    capture."""
    import gc
    import weakref
    tm, arrays = setup["tm"], setup["arrays"]
    trainer = LocalTrainer(tm.loss_fn, FedConfig(**FED))
    trainer.train_scanned(tm.init(SEED), _plans(arrays, True)[0], 2)
    phase = weakref.ref(trainer.scanned)
    alive = weakref.ref(trainer)
    was_on = gc.isenabled()
    gc.disable()
    try:
        del trainer
        assert alive() is None and phase() is None
    finally:
        if was_on:
            gc.enable()
