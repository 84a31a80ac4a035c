"""Port parity for the slice as a whole: paper Algorithm 1 through
`repro.api.launch` and `repro_torch.api.launch` — `Experiment(strategy=
"fedelmy")` on the paper CNN at width 8 / d_ff 16, 3 Dirichlet clients,
pool_size 2, e_warmup 2, e_local 3, batch 8, per-step iterator streams —
from the same `init_params`.

Tolerances: per-model task losses rtol 1e-5; final params and the final
pool atol 1e-5 (measured drift after the run's 20 Adam steps is ~1e-6; one
step whose Adam update flipped sign would move an element by ~lr = 1e-3);
the final accuracy within one test sample. The `log_scale` floors of every
step's d1 and d2 calibration agree exactly. Record structure is equal."""
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
from repro.data import batch_iterator as jax_batch_iterator
from repro.data import dirichlet_partition, make_image_dataset
from repro.models import build_model as jax_build_model
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.core import distances as TD
from repro_torch.data import batch_iterator
from repro_torch.models import build_model

torch.set_num_threads(2)

FED = dict(n_clients=3, pool_size=2, e_local=3, e_warmup=2,
           learning_rate=1e-3, alpha=0.06, beta=1.0)
N_TEST = 60


def _torch_floor(x):
    """floor(log10(x)) in f32, as `log_scale` computes it."""
    return float(torch.floor(torch.log10(torch.clamp_min(x.detach(),
                                                         1e-12))))


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    jax_floors, torch_floors = [], []
    jax_log_scale, torch_log_scale = JD.log_scale, TD.log_scale

    def jax_recording(dist, task):
        mag_d = jnp.floor(jnp.log10(jnp.maximum(dist, 1e-12)))
        mag_l = jnp.floor(jnp.log10(jnp.maximum(task, 1e-12)))
        jax.debug.callback(
            lambda d, t: jax_floors.append((float(d), float(t))),
            mag_d, mag_l, ordered=True)
        return jax_log_scale(dist, task)

    def torch_recording(dist, task):
        torch_floors.append((_torch_floor(dist), _torch_floor(task)))
        return torch_log_scale(dist, task)

    mp.setattr(JD, "log_scale", jax_recording)
    mp.setattr(TD, "log_scale", torch_recording)

    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("paper-cnn"), d_model=8, d_ff=16))
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=8,
                                         d_ff=16), device="cpu")
    ds = make_image_dataset(n_samples=240, seed=0, noise=2.0)
    test = make_image_dataset(n_samples=N_TEST, seed=5, noise=2.0)
    parts = dirichlet_partition(ds.labels, FED["n_clients"], 0.3, seed=0)
    arrays = [{"images": ds.images[p], "labels": ds.labels[p]}
              for p in parts]
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))

    def jax_acc(params):
        logits = jm.forward(params, {"images": jnp.asarray(test.images)})
        return jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(test.labels))

    def torch_acc(params):
        with torch.no_grad():
            logits = tm.forward(params,
                                {"images": torch.from_numpy(test.images)})
        return float((logits.argmax(-1).numpy() == test.labels).mean())

    try:
        jres = J.launch(J.Experiment(
            model=jm, fed=JaxFedConfig(**FED), strategy="fedelmy",
            client_iters=[jax_batch_iterator(a, 8, seed=i)
                          for i, a in enumerate(arrays)],
            init_params=jax.tree.map(jnp.asarray, init), eval_fn=jax_acc))
        jax.effects_barrier()
        tres = T.launch(T.Experiment(
            model=tm, fed=FedConfig(**FED), strategy="fedelmy",
            client_iters=[batch_iterator(a, 8, seed=i, device="cpu")
                          for i, a in enumerate(arrays)],
            init_params=from_jax_params(init, "cpu"), eval_fn=torch_acc))
    finally:
        mp.undo()
    return jres, tres, jax_floors, torch_floors


def test_record_structure_matches(runs):
    jres, tres, _, _ = runs
    assert tres.strategy == jres.strategy == "fedelmy"
    assert [(c.client, c.rank) for c in tres.clients] == \
        [(c.client, c.rank) for c in jres.clients]
    assert [[m.index for m in c.models] for c in tres.clients] == \
        [[m.index for m in c.models] for c in jres.clients]
    assert all(len(c.models) == FED["pool_size"] for c in tres.clients)
    assert tres.final_pool.count == int(jres.final_pool.count) == \
        FED["pool_size"] + 1


def test_per_model_task_losses_match(runs):
    jres, tres, _, _ = runs
    got = [m.task_loss for c in tres.clients for m in c.models]
    want = [m.task_loss for c in jres.clients for m in c.models]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert all(np.isfinite(got))


def test_final_params_and_pool_match(runs):
    jres, tres, _, _ = runs
    ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
    assert list(tres.params) == list(ref)
    for k in ref:
        np.testing.assert_allclose(tres.params[k].numpy(), ref[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    pool_ref = from_jax_params(
        jax.tree.map(np.asarray, jres.final_pool.members), "cpu")
    for k in pool_ref:
        np.testing.assert_allclose(tres.final_pool.members[k].numpy(),
                                   pool_ref[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_log_scale_floors_agree_on_every_step(runs):
    _, _, jax_floors, torch_floors = runs
    # warm-up steps are plain; every pool step calibrates d1 then d2
    n_pool_steps = FED["n_clients"] * FED["pool_size"] * FED["e_local"]
    assert len(torch_floors) == len(jax_floors) == 2 * n_pool_steps
    assert torch_floors == jax_floors


def test_final_accuracy_matches(runs):
    jres, tres, _, _ = runs
    assert abs(tres.final_metric - float(jres.final_metric)) <= 1 / N_TEST
    assert [c.global_metric for c in tres.clients][-1] == tres.final_metric


def test_order_is_honored_and_unknown_strategy_rejected():
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=4,
                                         d_ff=8), device="cpu")
    ds = make_image_dataset(n_samples=60, seed=1)
    parts = dirichlet_partition(ds.labels, 3, 0.5, seed=1)
    its = [batch_iterator({"images": ds.images[p], "labels": ds.labels[p]},
                          4, seed=i, device="cpu")
           for i, p in enumerate(parts)]
    fed = FedConfig(n_clients=3, pool_size=1, e_local=1, e_warmup=1)
    res = T.launch(T.Experiment(model=tm, client_iters=its, fed=fed,
                                order=[2, 0, 1], seed=4))
    assert [(c.client, c.rank) for c in res.clients] == [(2, 0), (0, 1),
                                                         (1, 2)]
    with pytest.raises(ValueError, match="unknown strategy 'fedsgd'; "
                       "registered: dfedavgm, dfedsam, fedelmy"):
        T.launch(T.Experiment(model=tm, client_iters=its, fed=fed,
                              strategy="fedsgd"))
    with pytest.raises(TypeError, match="Experiment"):
        T.launch([res])


# ---------------------------------------------------------------------------
# The interpreter's other reachable paths, against the reference's plans
# ---------------------------------------------------------------------------

def _variant_setup():
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("paper-cnn"), d_model=4, d_ff=8))
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=4,
                                         d_ff=8), device="cpu")
    ds = make_image_dataset(n_samples=96, seed=2, noise=2.0)
    parts = dirichlet_partition(ds.labels, 2, 0.5, seed=2)
    arrays = [{"images": ds.images[p], "labels": ds.labels[p]}
              for p in parts]
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    return jm, tm, arrays, init


# FedConfig overrides of fedelmy
VARIANTS = {
    "fedelmy_no_pool": {"use_pool": False},
    "fedelmy_l1_unscaled": {"distance_measure": "l1",
                            "log_scale_distances": False},
    "fedelmy_squared_l2": {"distance_measure": "squared_l2"},
    "fedelmy_no_d1": {"use_d1": False},
    "fedelmy_no_d2": {"use_d2": False},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_interpreter_variants_match_reference(name):
    """The no-pool, no-d1 and no-d2 ablations, an l1 objective without
    calibration and the squared-l2 measure, each against the reference on
    the same init and streams (tolerances as above). The cosine measure is
    held in test_torch_core only: at the first step of a pool model the
    weights equal the d2 anchor, where the cosine distance's gradient is
    rounding noise that Adam's first update (≈ g/|g|) turns into ±lr."""
    jm, tm, arrays, init = _variant_setup()
    fed = dict(n_clients=2, pool_size=2, e_local=2, e_warmup=1,
               learning_rate=1e-3, **VARIANTS[name])
    jres = J.launch(J.Experiment(
        model=jm, fed=JaxFedConfig(**fed), strategy="fedelmy",
        client_iters=[jax_batch_iterator(a, 4, seed=i)
                      for i, a in enumerate(arrays)],
        init_params=jax.tree.map(jnp.asarray, init)))
    tres = T.launch(T.Experiment(
        model=tm, fed=FedConfig(**fed), strategy="fedelmy",
        client_iters=[batch_iterator(a, 4, seed=i, device="cpu")
                      for i, a in enumerate(arrays)],
        init_params=from_jax_params(init, "cpu")))
    ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
    for k in ref:
        np.testing.assert_allclose(tres.params[k].numpy(), ref[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=k)
    assert [(c.client, c.rank, len(c.models)) for c in tres.clients] == \
        [(c.client, c.rank, len(c.models)) for c in jres.clients]
    np.testing.assert_allclose(
        [m.task_loss for c in tres.clients for m in c.models],
        [m.task_loss for c in jres.clients for m in c.models], rtol=1e-5)
    assert (tres.final_pool is None) == (jres.final_pool is None)


# The reference's construction checks (tests/test_plan.py): what each
# package is given, and what its error says.
MALFORMED = {
    "topology": (lambda P: P.Topology("mesh"), "topology"),
    "block_kind": (lambda P: P.LocalBlock("sam"), "local block"),
    "custom_without_factory": (lambda P: P.LocalBlock("custom"),
                               "step_factory"),
    "pool_epochs_div": (lambda P: P.LocalBlock("pool", epochs_div=2),
                        "e_local"),
    "aggregate": (lambda P: P.StrategyPlan(
        topology=P.Topology("chain"), phases=(P.LocalBlock("plain"),),
        aggregate="median"), "aggregate"),
    "no_phase": (lambda P: P.StrategyPlan(topology=P.Topology("chain"),
                                          phases=()), "at least one phase"),
    "independent_two_phases": (lambda P: P.StrategyPlan(
        topology=P.Topology("independent"),
        phases=(P.LocalBlock("plain"), P.LocalBlock("plain")),
        broadcast="shared_init"), "single-phase"),
    "independent_handoff": (lambda P: P.StrategyPlan(
        topology=P.Topology("independent"), phases=(P.LocalBlock("plain"),)),
        "hand off"),
    "chain_shared_init": (lambda P: P.StrategyPlan(
        topology=P.Topology("chain"), phases=(P.LocalBlock("plain"),),
        broadcast="shared_init"), "handoff"),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_plans_fail_at_construction(case):
    """Both packages refuse the malformed plan with the same message —
    except a custom block without factories, which the reference refuses
    for lacking a batched factory too and the port (which has no batched
    backend) only for lacking its step factory."""
    make, match = MALFORMED[case]
    messages = []
    for pkg in (J, T):
        with pytest.raises(ValueError, match=match) as err:
            make(pkg)
        messages.append(str(err.value))
    if case != "custom_without_factory":
        assert messages[1] == messages[0]


def test_model_end_callback_sees_every_pool_model():
    _, tm, arrays, init = _variant_setup()
    fed = FedConfig(n_clients=2, pool_size=2, e_local=1, e_warmup=1)
    seen = []
    exp = T.Experiment(
        model=tm, fed=fed,
        client_iters=[batch_iterator(a, 4, seed=i, device="cpu")
                      for i, a in enumerate(arrays)],
        init_params=from_jax_params(init, "cpu"),
        callbacks=T.Callbacks(
            on_model_end=lambda rec, p: seen.append((rec.index,
                                                     rec.task_loss))))
    res = T.launch(exp)
    assert [i for i, _ in seen] == [0, 1, 0, 1]
    assert [t for _, t in seen] == [m.task_loss for c in res.clients
                                    for m in c.models]
