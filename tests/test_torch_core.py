"""Port parity: configs, optimizer, pool and distance regularizers of
`repro_torch` against the JAX reference on the same numpy inputs.

Tolerances (f32): pool averaging, the distances and `log_scale` agree to
rtol 1e-6 / atol 1e-7 (reductions over a few hundred elements, summed in
another order); Adam over 10 steps to rtol 1e-5 / atol 1e-6 (each step
divides by √v, which magnifies last-bit differences of the inputs); the
`log_scale` floors exactly. Validation errors match message for message."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FedConfig as JaxFedConfig
from repro.core import distances as JD
from repro.core.pool import ModelPool as JaxModelPool
from repro.optim import optimizers as JO
from repro_torch.configs import FedConfig
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.core import distances as TD
from repro_torch.core.pool import ModelPool
from repro_torch.optim import optimizers as TO

torch.set_num_threads(2)

MEASURES = ("l2", "l1", "cosine", "squared_l2")


def _tree(rng, scale=1.0):
    return {"a": {"b": (scale * rng.normal(size=(3,))).astype(np.float32),
                  "w": (scale * rng.normal(size=(4, 5))).astype(np.float32)},
            "c": {"w": (scale * rng.normal(size=(2, 3, 2))).astype(
                np.float32)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(out, ref, rtol, atol):
    for k in ref:
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


def _pools(seed, n_members, capacity=4):
    rng = np.random.default_rng(seed)
    trees = [_tree(rng) for _ in range(n_members)]
    jp = JaxModelPool.create(_jax(trees[0]), capacity)
    tp = ModelPool.create(from_jax_params(trees[0], "cpu"), capacity)
    for t in trees[1:]:
        jp = jp.append(_jax(t))
        tp = tp.append(from_jax_params(t, "cpu"))
    return jp, tp, rng


# ---------------------------------------------------------------------------
# FedConfig
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(distance_measure="cos"), dict(optimizer="adagrad"),
    dict(moment_form=True, pool_backend="lowrank"), dict(pool_rank=0),
    dict(pool_backend="lowrank", distance_measure="l1"),
    dict(pool_backend="moment", distance_measure="l2"),
    dict(moment_form=True)])
def test_fedconfig_validation_identical(kwargs):
    with pytest.raises(ValueError) as ref:
        JaxFedConfig(**kwargs)
    with pytest.raises(ValueError) as out:
        FedConfig(**kwargs)
    assert str(out.value) == str(ref.value)


def test_fedconfig_fields_and_defaults_match():
    ref, out = JaxFedConfig(), FedConfig()
    assert dataclasses.asdict(out) == dataclasses.asdict(ref)
    for kw in (dict(), dict(moment_form=True, distance_measure="squared_l2"),
               dict(pool_backend="lowrank")):
        assert FedConfig(**kw).resolved_pool_backend == \
            JaxFedConfig(**kw).resolved_pool_backend


# ---------------------------------------------------------------------------
# ModelPool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_members", [1, 2, 4])
def test_model_pool_matches_reference(n_members):
    jp, tp, _ = _pools(n_members, n_members)
    assert tp.count == int(jp.count) and tp.capacity == jp.capacity
    members = from_jax_params(jax.tree.map(np.asarray, jp.members), "cpu")
    for k, s in members.items():
        assert torch.equal(tp.members[k], s), k
    np.testing.assert_array_equal(tp.mask().numpy(), np.asarray(jp.mask()))
    avg = from_jax_params(jax.tree.map(np.asarray, jp.average()), "cpu")
    _close(tp.average(), avg, rtol=1e-6, atol=1e-7)
    first = from_jax_params(jax.tree.map(np.asarray, jp.first()), "cpu")
    for k in first:
        assert torch.equal(tp.first()[k], first[k])


def test_model_pool_append_is_functional_and_bounded():
    _, tp, rng = _pools(0, 2, capacity=2)
    with pytest.raises(ValueError, match="full"):
        tp.append(from_jax_params(_tree(rng), "cpu"))
    _, tp, rng = _pools(0, 1, capacity=2)
    before = {k: v.clone() for k, v in tp.members.items()}
    tp.append(from_jax_params(_tree(rng), "cpu"))
    assert all(torch.equal(tp.members[k], before[k]) for k in before)


# ---------------------------------------------------------------------------
# d1 / d2 and log_scale
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
@pytest.mark.parametrize("n_members", [1, 3])
def test_d1_value_and_grad_match(measure, n_members):
    jp, tp, rng = _pools(10 + n_members, n_members)
    w = _tree(rng)
    ref_val, ref_grad = jax.value_and_grad(
        lambda p: JD.d1_pool_distance(p, jp, measure))(_jax(w))
    params = {k: v.requires_grad_(True)
              for k, v in from_jax_params(w, "cpu").items()}
    val = TD.d1_pool_distance(params, tp, measure)
    grads = torch.autograd.grad(val, list(params.values()))
    np.testing.assert_allclose(float(val.detach()), float(ref_val), rtol=1e-6)
    ref_g = from_jax_params(jax.tree.map(np.asarray, ref_grad), "cpu")
    _close(dict(zip(params, grads)), ref_g, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("measure", MEASURES)
def test_d2_value_and_grad_match(measure):
    rng = np.random.default_rng(3)
    w, anchor = _tree(rng), _tree(rng)
    ref_val, ref_grad = jax.value_and_grad(
        lambda p: JD.d2_anchor_distance(p, _jax(anchor), measure))(_jax(w))
    params = {k: v.requires_grad_(True)
              for k, v in from_jax_params(w, "cpu").items()}
    val = TD.d2_anchor_distance(params, from_jax_params(anchor, "cpu"),
                                measure)
    grads = torch.autograd.grad(val, list(params.values()))
    np.testing.assert_allclose(float(val.detach()), float(ref_val), rtol=1e-6)
    ref_g = from_jax_params(jax.tree.map(np.asarray, ref_grad), "cpu")
    _close(dict(zip(params, grads)), ref_g, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("measure", MEASURES)
def test_distance_grad_at_identity_matches(measure):
    """At w == m — the first step of every pool model, against its d2
    anchor — the gradients agree too: zero for l2 (sqrt(0 + 1e-12)) and
    squared_l2, +1 per element for l1 (the reference differentiates |x|
    as select(x >= 0, g, -g))."""
    w = _tree(np.random.default_rng(0))
    ref_val, ref_grad = jax.value_and_grad(
        lambda p: JD.d2_anchor_distance(p, _jax(w), measure))(_jax(w))
    params = {k: v.requires_grad_(True)
              for k, v in from_jax_params(w, "cpu").items()}
    val = TD.d2_anchor_distance(params, from_jax_params(w, "cpu"), measure)
    grads = torch.autograd.grad(val, list(params.values()))
    np.testing.assert_allclose(float(val.detach()), float(ref_val),
                               rtol=1e-6, atol=1e-7)
    ref_g = from_jax_params(jax.tree.map(np.asarray, ref_grad), "cpu")
    _close(dict(zip(params, grads)), ref_g, rtol=1e-5, atol=1e-7)


def test_log_scale_matches_including_floors():
    dists = np.array([1e-6, 9.99e-7, 1e-12, 0.0, 3.2e-4, 0.0999, 0.1, 1.0,
                      45.0, 123.4, 9.9999e3], np.float32)
    tasks = np.array([6.02, 2.3, 0.9, 1.0, 0.0999, 12.0, 2.30258, 1e-3,
                      6.02, 0.45, 1.5], np.float32)
    ref = JD.log_scale(jnp.asarray(dists), jnp.asarray(tasks))
    d = torch.from_numpy(dists).requires_grad_(True)
    out = TD.log_scale(d, torch.from_numpy(tasks))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=0)
    # the floors agree: the ratio dist/out is the (power of ten) scale
    for name, x in (("dist", dists), ("task", tasks)):
        jf = np.asarray(jnp.floor(jnp.log10(jnp.maximum(x, 1e-12))))
        tf = torch.floor(torch.log10(torch.clamp_min(
            torch.from_numpy(x), 1e-12))).numpy()
        np.testing.assert_array_equal(tf, jf, err_msg=name)
    (g,) = torch.autograd.grad(out.sum(), d)
    ref_g = jax.grad(lambda x: JD.log_scale(x, jnp.asarray(tasks)).sum())(
        jnp.asarray(dists))
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,wd", [("adam", 1e-4), ("adam", 0.0),
                                     ("adamw", 1e-2)])
def test_adam_matches_reference_over_steps(name, wd):
    rng = np.random.default_rng(11)
    p0 = _tree(rng)
    grads = [_tree(rng, scale=10.0 ** -i) for i in range(10)]
    jopt = JO.make_optimizer(name, 1e-3, weight_decay=wd)
    topt = TO.make_optimizer(name, 1e-3, weight_decay=wd)
    jp, tp = _jax(p0), from_jax_params(p0, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step, g in enumerate(grads):
        jp, js = jopt.update(jp, _jax(g), js, jnp.int32(step))
        tp, ts = topt.update(tp, from_jax_params(g, "cpu"), ts, step)
        ref = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
        _close(tp, ref, rtol=1e-5, atol=1e-6)
    ref_m = from_jax_params(jax.tree.map(np.asarray, js["m"]), "cpu")
    _close(ts["m"], ref_m, rtol=1e-5, atol=1e-9)


def test_adam_update_is_functional():
    tp = from_jax_params(_tree(np.random.default_rng(0)), "cpu")
    before = {k: v.clone() for k, v in tp.items()}
    opt = TO.adam(1e-3, weight_decay=1e-4)
    opt.update(tp, {k: torch.ones_like(v) for k, v in tp.items()},
               opt.init(tp), 0)
    assert all(torch.equal(tp[k], before[k]) for k in tp)


def test_converter_round_trip_of_nested_tree():
    tree = _tree(np.random.default_rng(5))
    back = to_jax_params(from_jax_params(tree, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
