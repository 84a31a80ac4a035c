"""Port parity: the SGD, momentum and SAM optimizers of `repro_torch.optim`,
the SGD sweep of `repro_torch.kernels.local_step` and the gradient of the
paper CNN's native forward, against the JAX reference on the same numpy
inputs.

Tolerances:
* `sgd` and `momentum` — bitwise over 5 steps, against the reference's
  update as the engine runs it (inside `jax.jit`, where XLA's CPU backend
  contracts g + wd·p and p − lr·g into FMAs; the port's `torch.add(…,
  alpha=)` rounds the same way). The leaves are the full-width paper CNN's
  (1,422,218 elements).
* The plain SGD sweep — bitwise against the Pallas sweep
  `sgd_update_flat` in interpret mode, over the concatenated leaves.
* The native forward's gradient (`F.conv2d` + `F.max_pool2d` against
  `lax.conv` + `reduce_window`) — rtol 1e-4 / atol 1e-6 per leaf, as for
  the fused forward in test_torch_cnn (f32 products of length ≤ 512 in
  another order).
* `sam_update` — params rtol 1e-5 / atol 1e-6 after 5 steps (the two
  gradients of each step differ as the native forward's do; SGD and
  momentum pass them on linearly, scaled by lr = 1e-2), the global norm
  rtol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.local_step import sgd_update_flat
from repro.models import build_model as jax_build_model
from repro.optim import optimizers as JO
from repro.optim import sam as JS
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_params
from repro_torch.kernels import local_step as TL
from repro_torch.models import build_model
from repro_torch.optim import optimizers as TO
from repro_torch.optim import sam as TS

torch.set_num_threads(2)

# the full-width paper CNN's leaves, in the reference's order
CNN_SHAPES = {"c1.b": (64,), "c1.w": (3, 3, 3, 64), "c2.b": (128,),
              "c2.w": (3, 3, 64, 128), "c3.b": (256,),
              "c3.w": (3, 3, 128, 256), "fc1.b": (256,),
              "fc1.w": (4096, 256), "fc2.b": (10,), "fc2.w": (256, 10)}
WIDTH, D_FF, BATCH = 8, 16, 8


def _leaves(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in CNN_SHAPES.items()}


def _nest(flat):
    """{"c1.b": x} → {"c1": {"b": x}} for the reference's pytrees."""
    tree = {}
    for k, v in flat.items():
        layer, leaf = k.split(".")
        tree.setdefault(layer, {})[leaf] = jnp.asarray(v)
    return tree


def _assert_bitwise(tparams, jtree):
    ref = from_jax_params(jax.tree.map(np.asarray, jtree), "cpu")
    assert list(tparams) == list(ref)
    for k in ref:
        n_diff = int((tparams[k] != ref[k]).sum())
        assert n_diff == 0, f"{k}: {n_diff} elements differ"


# ---------------------------------------------------------------------------
# sgd, momentum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,wd", [("sgd", 1e-4), ("sgd", 0.0),
                                     ("momentum", 1e-4), ("momentum", 0.0)])
def test_sgd_and_momentum_bitwise_over_steps(name, wd):
    rng = np.random.default_rng(21)
    p0 = _leaves(rng)
    jopt = JO.make_optimizer(name, 1e-2, weight_decay=wd)
    topt = TO.make_optimizer(name, 1e-2, weight_decay=wd)
    update = jax.jit(jopt.update)
    jp, tp = _nest(p0), from_jax_params(p0, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _leaves(rng, scale=10.0 ** -step)
        jp, js = update(jp, _nest(g), js, jnp.int32(step))
        tp, ts = topt.update(tp, from_jax_params(g, "cpu"), ts, step)
        _assert_bitwise(tp, jp)
    if name == "momentum":
        _assert_bitwise(ts["m"], js["m"])


def test_plain_sgd_sweep_bitwise_to_pallas_sweep():
    """The port's CPU route of the sweep against the reference's Pallas
    kernel (interpret mode) over the same leaves flattened: 22 blocks of
    65,536, the last one ragged."""
    rng = np.random.default_rng(3)
    p, g = _leaves(rng), _leaves(rng)
    flat = np.concatenate([v.ravel() for v in p.values()])
    gflat = np.concatenate([v.ravel() for v in g.values()])
    want = np.asarray(sgd_update_flat(jnp.asarray(flat), jnp.asarray(gflat),
                                      lr=1e-2, wd=1e-4, interpret=True))
    out = TL.sgd_update_tree(from_jax_params(p, "cpu"),
                             from_jax_params(g, "cpu"), lr=1e-2, wd=1e-4)
    got = torch.cat([v.reshape(-1) for v in out.values()]).numpy()
    assert got.shape == want.shape == (1_422_218,)
    assert int((got != want).sum()) == 0


def test_sgd_update_is_functional_and_routes_by_device():
    """CPU leaves take the plain version (no kernel launch is counted), the
    inputs stay unchanged; the kernel wrapper refuses CPU tensors; leaves
    on another device, or on two devices, have no route."""
    rng = np.random.default_rng(4)
    p = from_jax_params(_leaves(rng), "cpu")
    g = from_jax_params(_leaves(rng), "cpu")
    before = {k: v.clone() for k, v in p.items()}
    launches = TL.sgd_f32.launches
    out = TO.sgd(1e-2, weight_decay=1e-4).update(p, g, (), 0)[0]
    assert TL.sgd_f32.launches == launches
    assert all(torch.equal(p[k], before[k]) for k in p)
    assert all(out[k] is not p[k] for k in p)
    with pytest.raises(ValueError, match="not CUDA"):
        TL.sgd_f32(list(p.values()), list(g.values()), lr=1e-2)
    with pytest.raises(ValueError, match="no route"):
        TL.sgd_update_tree({"a": torch.ones(2, device="meta")},
                           {"a": torch.ones(2, device="meta")}, lr=1e-2)
    with pytest.raises(ValueError, match="no route"):
        TL.sgd_update_tree({"a": torch.ones(2),
                            "b": torch.ones(2, device="meta")},
                           {"a": torch.ones(2),
                            "b": torch.ones(2, device="meta")}, lr=1e-2)
    assert TL.sgd_f32.launches == launches


def test_make_optimizer_names_match_reference():
    p = from_jax_params(_leaves(np.random.default_rng(0)), "cpu")
    for name in ("sgd", "momentum", "adam", "adamw"):
        opt = TO.make_optimizer(name, 1e-3, weight_decay=1e-4)
        assert opt.name == JO.make_optimizer(name, 1e-3).name == name
        opt.init(p)


# ---------------------------------------------------------------------------
# The native forward's gradient, SAM
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cnn():
    jm = jax_build_model(dataclasses.replace(jax_get_arch("paper-cnn"),
                                             d_model=WIDTH, d_ff=D_FF))
    tm = build_model(dataclasses.replace(get_arch("paper-cnn"),
                                         d_model=WIDTH, d_ff=D_FF),
                     device="cpu")
    init = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(6)
    batches = [{"images": rng.normal(size=(BATCH, 32, 32, 3)).astype(
                    np.float32),
                "labels": rng.integers(0, 10, size=BATCH).astype(np.int32)}
               for _ in range(5)]
    return jm, tm, init, batches


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_native_forward_gradient_matches_jax_grad(cnn):
    """`model.loss_fn` (F.conv2d + F.max_pool2d, the forward the SAM and
    MetaFed steps differentiate) against `jax.grad` of the reference's
    `lax.conv` + `reduce_window` loss."""
    jm, tm, init, batches = cnn
    ref_loss, ref_grads = jax.value_and_grad(jm.loss_fn)(
        jax.tree.map(jnp.asarray, init), _jb(batches[0]))
    params = {k: v.requires_grad_(True)
              for k, v in from_jax_params(init, "cpu").items()}
    loss = tm.loss_fn(params, _tb(batches[0]))
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref = from_jax_params(jax.tree.map(np.asarray, ref_grads), "cpu")
    for k in ref:
        np.testing.assert_allclose(grads[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_global_norm_matches(cnn):
    _, _, init, _ = cnn
    tree = jax.tree.map(jnp.asarray, init)
    np.testing.assert_allclose(
        float(TS._global_norm(from_jax_params(init, "cpu"))),
        float(JS._global_norm(tree)), rtol=1e-6)


@pytest.mark.parametrize("base", ["sgd", "momentum"])
def test_sam_update_matches_reference_over_steps(cnn, base):
    jm, tm, init, batches = cnn
    jopt = JO.make_optimizer(base, 1e-2, weight_decay=1e-4)
    topt = TO.make_optimizer(base, 1e-2, weight_decay=1e-4)
    jstep = jax.jit(lambda p, s, b, i: JS.sam_update(jm.loss_fn, p, b, jopt,
                                                     s, i, rho=0.05))
    jp = jax.tree.map(jnp.asarray, init)
    tp = from_jax_params(init, "cpu")
    js, ts = jopt.init(jp), topt.init(tp)
    for i, batch in enumerate(batches):
        jp, js = jstep(jp, js, _jb(batch), jnp.int32(i))
        tp, ts = TS.sam_update(tm.loss_fn, tp, _tb(batch), topt, ts, i,
                               rho=0.05)
    ref = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
    moved = max(float((ref[k] - from_jax_params(init, "cpu")[k]).abs().max())
                for k in ref)
    assert moved > 1e-4          # the steps did move the parameters
    for k in ref:
        np.testing.assert_allclose(tp[k].numpy(), ref[k].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
