"""Port parity for the seven strategies beside `fedelmy`: each through
`repro.api.launch` and `repro_torch.api.launch` on the paper CNN at width
8 / d_ff 16, 3 Dirichlet clients, pool_size 2, e_warmup 2, e_local 4,
batch 8, per-step iterator streams, from the same initial parameters.

Both packages draw their inits from `model.init`. The port is given a
model whose `init` returns the reference's init for the same seed
(converted), and for ``fedelmy_pfl``'s per-client inits the reference's
init from the split key of that client, looked up by the seed the port
derives for it (`per_client_seeds`). One case (`fedseq_resumed`) passes
`init_params` and a visit order instead.

Tolerances, as in test_torch_fedelmy: final params (and the final pool)
atol 1e-5; per-model task losses rtol 1e-5; every recorded metric and
the final metric within one test sample. Record structure is equal.
`tree_mean` is bitwise equal to the reference's.

These tolerances hold runs in which no discontinuous decision of the
forward (a ReLU sign, a max-pool argmax) falls differently in the two
packages, whose f32 conv sums differ in the last bit. Where one does,
one gradient term moves and Adam carries it on: `fedseq_resumed` first
started from the init of PRNGKey(9), where the first client's 4th step
flips one decision in c1 and c1.w ends 8e-5 apart (2e-7 before that
step). It starts from PRNGKey(1) instead (1.4e-6 apart)."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.api as J
import repro_torch.api as T
from repro.api.plan import tree_mean as jax_tree_mean
from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.data import batch_iterator as jax_batch_iterator
from repro.data import dirichlet_partition, make_image_dataset
from repro.models import build_model as jax_build_model
from repro_torch.api.strategies import STRATEGIES
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.data import batch_iterator
from repro_torch.models import build_model

torch.set_num_threads(2)

FED = dict(n_clients=3, pool_size=2, e_local=4, e_warmup=2,
           learning_rate=1e-3, alpha=0.06, beta=1.0)
N_TEST = 60
SEED = 0

# strategy, Experiment fields shared by both packages
CASES = {
    "fedseq": ("fedseq", {}),
    "fedseq_resumed": ("fedseq", {"order": [2, 0, 1], "init": True}),
    "dfedavgm": ("dfedavgm", {}),
    "dfedsam": ("dfedsam", {"strategy_options": {"rho": 0.05}}),
    "metafed": ("metafed", {"strategy_options": {"anchor_beta": 0.5}}),
    "fedelmy_pfl": ("fedelmy_pfl", {}),
    "fedelmy_fewshot": ("fedelmy_fewshot", {"shots": 2}),
    "local_only": ("local_only", {"strategy_options": {"client": 1}}),
}


@pytest.fixture(scope="module")
def setup():
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("paper-cnn"), d_model=8, d_ff=16))
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=8,
                                         d_ff=16), device="cpu")
    ds = make_image_dataset(n_samples=240, seed=0, noise=2.0)
    test = make_image_dataset(n_samples=N_TEST, seed=5, noise=2.0)
    parts = dirichlet_partition(ds.labels, FED["n_clients"], 0.3, seed=0)
    arrays = [{"images": ds.images[p], "labels": ds.labels[p]}
              for p in parts]

    # the reference's inits, keyed by the seed the port asks for
    key = jax.random.PRNGKey(SEED)
    inits = {SEED: jm.init(key)}
    for s, k in zip(T.per_client_seeds(SEED, FED["n_clients"]),
                    jax.random.split(key, FED["n_clients"])):
        inits[s] = jm.init(k)
    inits = {s: from_jax_params(jax.tree.map(np.asarray, p), "cpu")
             for s, p in inits.items()}
    tm_jax_init = tm._replace(init=lambda seed: dict(inits[seed]))

    def jax_acc(params):
        logits = jm.forward(params, {"images": jnp.asarray(test.images)})
        return jnp.mean(jnp.argmax(logits, -1) == jnp.asarray(test.labels))

    def torch_acc(params):
        with torch.no_grad():
            logits = tm.forward(params,
                                {"images": torch.from_numpy(test.images)})
        return float((logits.argmax(-1).numpy() == test.labels).mean())

    return dict(jm=jm, tm=tm_jax_init, arrays=arrays, jax_acc=jax_acc,
                torch_acc=torch_acc,
                init=jax.tree.map(np.asarray,
                                  jm.init(jax.random.PRNGKey(1))))


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, setup):
    strategy, fields = CASES[request.param]
    fields = dict(fields)
    jkw, tkw = {}, {}
    if fields.pop("init", False):
        jkw["init_params"] = jax.tree.map(jnp.asarray, setup["init"])
        tkw["init_params"] = from_jax_params(setup["init"], "cpu")
    arrays = setup["arrays"]
    jres = J.launch(J.Experiment(
        model=setup["jm"], fed=JaxFedConfig(**FED), strategy=strategy,
        client_iters=[jax_batch_iterator(a, 8, seed=i)
                      for i, a in enumerate(arrays)],
        eval_fn=setup["jax_acc"], **fields, **jkw))
    tres = T.launch(T.Experiment(
        model=setup["tm"], fed=FedConfig(**FED), strategy=strategy,
        client_iters=[batch_iterator(a, 8, seed=i, device="cpu")
                      for i, a in enumerate(arrays)],
        seed=SEED, eval_fn=setup["torch_acc"], **fields, **tkw))
    return request.param, jres, tres


def test_final_params_match(runs):
    case, jres, tres = runs
    ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
    assert list(tres.params) == list(ref)
    for k in ref:
        np.testing.assert_allclose(tres.params[k].numpy(), ref[k].numpy(),
                                   rtol=0, atol=1e-5, err_msg=f"{case} {k}")
    assert (tres.final_pool is None) == (jres.final_pool is None)
    if jres.final_pool is not None:
        assert tres.final_pool.count == int(jres.final_pool.count)
        pool_ref = from_jax_params(
            jax.tree.map(np.asarray, jres.final_pool.members), "cpu")
        for k in pool_ref:
            np.testing.assert_allclose(tres.final_pool.members[k].numpy(),
                                       pool_ref[k].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f"{case} pool {k}")


def test_records_and_rounds_match(runs):
    case, jres, tres = runs
    assert tres.strategy == jres.strategy
    assert [(c.client, c.rank, [m.index for m in c.models])
            for c in tres.clients] == \
        [(c.client, c.rank, [m.index for m in c.models])
         for c in jres.clients], case
    np.testing.assert_allclose(
        [m.task_loss for c in tres.clients for m in c.models],
        [m.task_loss for c in jres.clients for m in c.models], rtol=1e-5)
    assert [r.round for r in tres.rounds] == [r.round for r in jres.rounds]
    for got, want in ((tres.clients, jres.clients),
                      (tres.rounds, jres.rounds)):
        for g, w in zip(got, want):
            assert (g.global_metric is None) == (w.global_metric is None)
            if w.global_metric is not None:
                assert abs(g.global_metric - float(w.global_metric)) <= \
                    1 / N_TEST, case


def test_final_metric_matches(runs):
    case, jres, tres = runs
    assert abs(tres.final_metric - float(jres.final_metric)) <= 1 / N_TEST
    assert np.isfinite(tres.final_metric)


# ---------------------------------------------------------------------------
# The registry, the engine's warnings, the aggregate
# ---------------------------------------------------------------------------

def test_registry_and_plan_metadata_match_reference():
    assert T.list_strategies() == J.list_strategies()
    ref = J.describe_strategies()
    for name, row in T.describe_strategies().items():
        assert row == ref[name], name


@pytest.mark.parametrize("strategy,field,value", [
    ("metafed", "order", [1, 0]), ("local_only", "shots", 2),
    ("fedelmy_pfl", "init_params", "init"), ("dfedavgm", "order", [1, 0])])
def test_unsupported_fields_warn_like_reference(setup, strategy, field,
                                                value):
    """The engine warns, before running, about a set field the strategy
    ignores, with the reference's message (the runs themselves are cut
    short by a stream that raises)."""
    class Stop(Exception):
        pass

    def stream():
        raise Stop
        yield

    messages = []
    for pkg, fed in ((J, JaxFedConfig), (T, FedConfig)):
        kw = {field: value}
        if value == "init":
            kw[field] = (jax.tree.map(jnp.asarray, setup["init"])
                         if pkg is J else from_jax_params(setup["init"],
                                                          "cpu"))
        model = setup["jm"] if pkg is J else setup["tm"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with pytest.raises(Stop):
                pkg.launch(pkg.Experiment(
                    model=model, fed=fed(**FED), strategy=strategy,
                    client_iters=[stream(), stream()], **kw))
        messages.append([str(w.message) for w in caught
                         if issubclass(w.category, UserWarning)
                         and "ignores" in str(w.message)])
    assert messages[1] == messages[0] and len(messages[0]) == 1


def test_register_strategy_runs_opaque_callables():
    seen = []

    @T.register_strategy("opaque_probe", supports=("order",))
    def probe(exp):
        seen.append(exp.resolved_order())
        return T.StrategyOutput(params={"w": torch.ones(2)})

    try:
        spec = T.get_strategy_spec("opaque_probe")
        assert spec.plan is None and spec.supports == {"order"}
        assert T.describe_strategies()["opaque_probe"]["topology"] == \
            "(opaque callable)"
        res = T.launch(T.Experiment(model=None, client_iters=[0, 0, 0],
                                    fed=FedConfig(), strategy="opaque_probe",
                                    order=[2, 1, 0], eval_fn=lambda p: 0.5))
        assert seen == [[2, 1, 0]] and res.final_metric == 0.5
        assert torch.equal(res.params["w"], torch.ones(2))
        with pytest.raises(ValueError, match="already registered"):
            T.register_strategy("opaque_probe")(probe)
    finally:
        STRATEGIES._items.pop("opaque_probe", None)


def test_tree_mean_bitwise_to_reference():
    rng = np.random.default_rng(8)
    trees = [{"a": {"b": rng.normal(size=(7,)).astype(np.float32),
                    "w": rng.normal(size=(5, 3)).astype(np.float32)},
              "c": {"w": (1e3 * rng.normal(size=(4,))).astype(np.float32)}}
             for _ in range(5)]
    want = from_jax_params(jax.tree.map(
        np.asarray, jax_tree_mean([jax.tree.map(jnp.asarray, t)
                                   for t in trees])), "cpu")
    got = T.tree_mean([from_jax_params(t, "cpu") for t in trees])
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_per_client_seeds_are_deterministic_and_distinct():
    seeds = T.per_client_seeds(3, 16)
    assert seeds == T.per_client_seeds(3, 16)
    assert len(set(seeds)) == 16
    assert seeds[:4] == T.per_client_seeds(3, 4)
    assert seeds != T.per_client_seeds(4, 16)
