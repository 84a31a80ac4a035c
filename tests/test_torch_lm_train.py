"""Dense LM training through the engine, against the reference: the
Markov-domain token streams (`data.make_lm_dataset`, bitwise), the reduced
llama3.2-1b's loss gradient per leaf against `jax.grad`, and
`launch(Experiment(strategy="fedelmy"))` on both packages from one init
over `DataPlan` streams with a held-out set taken inside each training
domain. Also the pieces the card's full-width run needs and the CPU can
hold: the in-place optimizer update and pool append of the captured
phase (bitwise their functional forms), the held-out set scored in
chunks, and ROADMAP C15's repair (the native CNN steps under
deterministic cuDNN flags) bitwise the steps without them on the CPU.

The model is `reduced()` llama3.2-1b with 2 kv heads (4 query heads, so a
GQA group of 2): 2 layers, d_model 256, hd 64, vocab 1,024, its sliding
window 64 (which the 32-token sequences do not reach).

Tolerances: gradients 1e-5 normwise per leaf (two layers of f32 products
in another order); over the run's 10 Adam steps, task losses rtol 1e-5
and final params 1e-4 normwise per leaf (as the other fedelmy runs:
Adam's g/√v passes last-bit differences of small gradients on as up to a
few percent of lr), the held-out NLL rtol 1e-4."""
import contextlib
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
from repro.data import make_lm_dataset as jax_make_lm_dataset
from repro.models import build_model as jax_build_model
from repro.models.transformer import lm_eval_fn as jax_lm_eval_fn
from repro_torch.api import strategies as TS
from repro_torch.api.trainer import _append_into
from repro_torch.configs import FedConfig, get_arch
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core.pool import ModelPool, MomentPool
from repro_torch.data import (DataPlan, SyntheticTextDataset,
                              batch_iterator, make_lm_dataset)
from repro_torch.models import build_model, cnn, lm_eval_fn
from repro_torch.models import transformer as TT
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import apply_in_place

torch.set_num_threads(2)

LM = dict(n_kv_heads=2)
SEQ, VOCAB, DOMAINS, HELD = 32, 1024, 2, 4
FED = dict(n_clients=DOMAINS, pool_size=2, e_warmup=2, e_local=2,
           learning_rate=3e-4, alpha=0.06, beta=1.0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jax_get_arch("llama3.2-1b").reduced(), **LM)
    tcfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(), **LM)
    assert tcfg.n_heads // tcfg.n_kv_heads == 2
    return jax_build_model(jcfg), build_model(tcfg, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(n_seqs=64, seq_len=16, vocab=300, n_domains=1, seed=0),
    dict(n_seqs=40, seq_len=SEQ, vocab=VOCAB, n_domains=4, seed=3),
    dict(n_seqs=9, seq_len=5, vocab=64, n_domains=2, seed=99)])
def test_make_lm_dataset_bitwise(kw):
    want = jax_make_lm_dataset(**kw)
    got = make_lm_dataset(**kw)
    assert len(got) == len(want) == kw["n_domains"]
    for g, w in zip(got, want):
        assert isinstance(g, SyntheticTextDataset) and g.vocab == w.vocab
        assert g.tokens.dtype == w.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, w.tokens)


def test_loss_gradient_per_leaf_matches_jax_grad(models):
    jm, tm = models
    params = tm.init(0)
    jp = jax.tree.map(jnp.asarray, to_jax_params(params))
    seqs = make_lm_dataset(n_seqs=4, seq_len=SEQ, vocab=VOCAB, seed=1)[0]
    batch = {"tokens": seqs.tokens[:, :-1], "labels": seqs.tokens[:, 1:]}
    jg = from_jax_params(jax.tree.map(np.asarray, jax.grad(jm.loss_fn)(
        jp, jax.tree.map(jnp.asarray, batch))), "cpu")
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = tm.loss_fn(leaves, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert list(jg) == list(leaves)
    for k, g in zip(leaves, grads):
        assert _rel(g.numpy(), jg[k].numpy()) <= 1e-5, k


def _lm_data():
    """Each domain's first rows are its client's stream; its last HELD
    rows are the held-out set (the same Markov chain)."""
    domains = make_lm_dataset(n_seqs=DOMAINS * 24, seq_len=SEQ, vocab=VOCAB,
                              n_domains=DOMAINS, seed=0)
    train = [{"tokens": d.tokens[:-HELD, :-1], "labels": d.tokens[:-HELD, 1:]}
             for d in domains]
    held = {"tokens": np.concatenate([d.tokens[-HELD:, :-1]
                                      for d in domains]),
            "labels": np.concatenate([d.tokens[-HELD:, 1:]
                                      for d in domains])}
    return train, held


@pytest.fixture(scope="module")
def lm_runs(models):
    jm, tm = models
    train, held = _lm_data()
    init = to_jax_params(tm.init(0))
    jres = J.launch(J.Experiment(
        model=jm, fed=JaxFedConfig(**FED), strategy="fedelmy",
        client_iters=[JaxDataPlan(a, 4, seed=i) for i, a in enumerate(train)],
        init_params=jax.tree.map(jnp.asarray, init),
        eval_fn=jax_lm_eval_fn(jm, held)))
    tres = T.launch(T.Experiment(
        model=tm, fed=FedConfig(**FED), strategy="fedelmy",
        client_iters=[DataPlan(a, 4, seed=i, device="cpu")
                      for i, a in enumerate(train)],
        init_params=from_jax_params(init, "cpu"),
        eval_fn=lm_eval_fn(tm, held)))
    return jres, tres


def test_fedelmy_lm_launch_matches_reference(lm_runs):
    jres, tres = lm_runs
    got = [m.task_loss for c in tres.clients for m in c.models]
    want = [m.task_loss for c in jres.clients for m in c.models]
    assert len(got) == DOMAINS * FED["pool_size"]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    ref = from_jax_params(jax.tree.map(np.asarray, jres.params), "cpu")
    for k in ref:
        assert _rel(tres.params[k].numpy(), ref[k].numpy()) <= 1e-4, k
    # held-out NLL after every client, beside the reference's
    np.testing.assert_allclose([c.global_metric for c in tres.clients],
                               [c.global_metric for c in jres.clients],
                               rtol=1e-4)
    assert int(tres.final_pool.count) == FED["pool_size"] + 1


def test_held_out_scored_in_chunks(models):
    """More held-out rows than `EVAL_ROWS`: the chunks' losses averaged by
    rows give the whole batch's mean NLL, beside the reference's."""
    jm, tm = models
    seqs = make_lm_dataset(n_seqs=TT.EVAL_ROWS + 5, seq_len=16, vocab=VOCAB,
                           seed=2)[0]
    held = {"tokens": seqs.tokens[:, :-1], "labels": seqs.tokens[:, 1:]}
    params = tm.init(0)
    jp = jax.tree.map(jnp.asarray, to_jax_params(params))
    np.testing.assert_allclose(float(lm_eval_fn(tm, held)(params)),
                               float(jax_lm_eval_fn(jm, held)(jp)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the captured phase's in-place update and append
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "adamw", "sgd", "momentum"])
def test_in_place_update_writes_the_functional_bits(name):
    rng = np.random.default_rng(0)
    params = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
              for k, s in (("a", (5, 7)), ("b", (3,)), ("c", (65_537,)))}
    grads = {k: torch.from_numpy(rng.normal(size=p.shape).astype(np.float32))
             for k, p in params.items()}
    opt = make_optimizer(name, 1e-2, weight_decay=1e-4)
    state = opt.init(params)
    for step in range(3):        # a state that is not all zeros
        params, state = opt.update(params, grads, state,
                                   torch.tensor(step, dtype=torch.int32))
    want_p, want_s = opt.update(params, grads, state,
                                torch.tensor(3, dtype=torch.int32))
    apply_in_place(opt, params, grads, state,
                   torch.tensor(3, dtype=torch.int32))
    for k in params:
        torch.testing.assert_close(params[k], want_p[k], rtol=0, atol=0)
    if state:
        for part in state:
            for k in params:
                torch.testing.assert_close(state[part][k], want_s[part][k],
                                           rtol=0, atol=0)


@pytest.mark.parametrize("form", ["stacked", "moment"])
def test_append_into_writes_append(form):
    rng = np.random.default_rng(1)

    def tree():
        return {k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
                for k, s in (("w", (4, 6)), ("b", (6,)))}
    m0, m1, m2 = tree(), tree(), tree()
    pool = (ModelPool.create(m0, 3) if form == "stacked"
            else MomentPool.create(m0))
    want = pool.append(m1).append(m2)
    _append_into(pool, m1)
    _append_into(pool, m2)
    for a, b in zip(torch.utils._pytree.tree_leaves(pool),
                    torch.utils._pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if form == "stacked":
        with pytest.raises(ValueError, match="full"):
            _append_into(pool, m1)


# ---------------------------------------------------------------------------
# C15: the native CNN steps under deterministic cuDNN flags
# ---------------------------------------------------------------------------

def _cnn_run(strategy, options):
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"), d_model=4,
                                         d_ff=16), device="cpu")
    ds = make_image_dataset(n_samples=120, seed=0, noise=2.0)
    parts = dirichlet_partition(ds.labels, 2, 0.3, seed=0)
    return T.launch(T.Experiment(
        model=tm, strategy=strategy, strategy_options=options,
        fed=FedConfig(n_clients=2, e_local=4, e_warmup=2, learning_rate=1e-3),
        client_iters=[batch_iterator({"images": ds.images[p],
                                      "labels": ds.labels[p]}, 8, seed=i,
                                     device="cpu")
                      for i, p in enumerate(parts)],
        init_params=tm.init(0)))


@pytest.mark.parametrize("strategy,options", [
    ("dfedsam", {"rho": 0.05}), ("metafed", {"anchor_beta": 0.5})])
def test_c15_flags_leave_cpu_runs_bitwise(strategy, options, monkeypatch):
    """After the repair (each native step whole under `native_conv_flags`)
    against before it (the steps without flags; the forward under cuDNN's
    TF32-off flags alone): bitwise the same params and records."""
    after = _cnn_run(strategy, options)
    monkeypatch.setattr(TS, "native_conv_flags", contextlib.nullcontext)
    monkeypatch.setattr(cnn, "native_conv_flags",
                        lambda: torch.backends.cudnn.flags(
                            enabled=True, allow_tf32=False))
    before = _cnn_run(strategy, options)
    for k in after.params:
        torch.testing.assert_close(after.params[k], before.params[k],
                                   rtol=0, atol=0)
    assert [c.global_metric for c in after.clients] == \
        [c.global_metric for c in before.clients]
    assert [[m.task_loss for m in c.models] for c in after.clients] == \
        [[m.task_loss for m in c.models] for c in before.clients]
