"""Port parity: the paper CNN of `repro_torch.models` against
`repro.models.cnn` at width 8 / d_ff 16 on one batch of 6 images, with the
reference's `init` parameters carried across by `repro_torch.convert`.

Tolerances: the converter round-trips exactly; logits and the loss agree
to rtol 1e-5 / atol 1e-5 and every leaf gradient to rtol 1e-4 / atol
1e-6 (f32 products of length ≤ 4·4·32 = 512 in three chained layers,
summed in another order; gradients pass through one more product)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from repro.configs import get_arch as jax_get_arch
from repro.kernels.local_step import FUSED_LOSS_ATTR as JAX_FUSED_ATTR
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels.local_step import FUSED_LOSS_ATTR, fused_loss_for
from repro_torch.models import PaperCNN, build_model

torch.set_num_threads(2)

WIDTH, D_FF, BATCH = 8, 16, 6


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jax_get_arch("paper-cnn"), d_model=WIDTH,
                               d_ff=D_FF)
    tcfg = dataclasses.replace(get_arch("paper-cnn"), d_model=WIDTH,
                               d_ff=D_FF)
    jm = jax_build_model(jcfg)
    tm = build_model(tcfg, device="cpu")
    jparams = jm.init(jax.random.PRNGKey(3))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    batch = {"images": rng.normal(size=(BATCH, 32, 32, 3)).astype(np.float32),
             "labels": rng.integers(0, 10, size=BATCH).astype(np.int32)}
    return jm, tm, tcfg, jparams, np_params, batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_converter_round_trips_exactly_in_leaf_order(setup):
    jm, tm, _, jparams, np_params, _ = setup
    params = from_jax_params(np_params, "cpu")
    jax_names = [".".join(p.key for p in path) for path, _ in
                 jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert list(params) == jax_names
    back = to_jax_params(params)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_matches_reference_names_shapes_and_scale(setup):
    jm, tm, _, jparams, np_params, _ = setup
    params = tm.init(0)
    ref = from_jax_params(np_params, "cpu")
    assert list(params) == list(ref)
    for k in ref:
        assert params[k].shape == ref[k].shape and params[k].dtype == \
            torch.float32, k
    assert torch.equal(tm.init(0)["c2.w"], params["c2.w"])   # seeded
    # He init: std 1/sqrt(fan_in) (fan_in = 9·C_in for convs)
    std = float(params["c3.w"].std())
    assert abs(std - 1 / np.sqrt(9 * 2 * WIDTH)) < 0.1 / np.sqrt(
        9 * 2 * WIDTH)
    assert all(float(params[f"{n}.b"].abs().max()) == 0
               for n in ("c1", "c2", "c3", "fc1", "fc2"))


def test_module_parameters_carry_reference_leaf_names(setup):
    _, _, tcfg, _, np_params, _ = setup
    names = [n for n, _ in PaperCNN(tcfg, device="meta").named_parameters()]
    assert names == list(from_jax_params(np_params, "cpu"))


def test_forward_logits_and_loss_match(setup):
    jm, tm, tcfg, jparams, np_params, batch = setup
    params = from_jax_params(np_params, "cpu")
    ref_logits = np.asarray(jm.forward(jparams, _jbatch(batch)))
    with torch.no_grad():
        logits = tm.forward(params, _tbatch(batch))
        fused = functional_call(PaperCNN(tcfg, device="meta"), params,
                                (_tbatch(batch)["images"],),
                                {"fused": True})
        loss = tm.loss_fn(params, _tbatch(batch))
        fused_loss = fused_loss_for(tm.loss_fn)(params, _tbatch(batch))
    assert logits.shape == (BATCH, 10)
    np.testing.assert_allclose(logits.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(fused.numpy(), ref_logits, rtol=1e-5,
                               atol=1e-5)
    ref_loss = float(jm.loss_fn(jparams, _jbatch(batch)))
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-5)
    np.testing.assert_allclose(float(fused_loss), ref_loss, rtol=1e-5)


def test_fused_loss_gradients_match(setup):
    jm, tm, _, jparams, np_params, batch = setup
    jax_fused = getattr(jm.loss_fn, JAX_FUSED_ATTR)
    ref_loss, ref_grads = jax.value_and_grad(jax_fused)(jparams,
                                                        _jbatch(batch))
    params = {k: v.requires_grad_(True)
              for k, v in from_jax_params(np_params, "cpu").items()}
    loss = getattr(tm.loss_fn, FUSED_LOSS_ATTR)(params, _tbatch(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    ref = from_jax_params(jax.tree.map(np.asarray, ref_grads), "cpu")
    for (k, g) in zip(params, grads):
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_build_model_needs_gpu_or_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_arch("paper-cnn"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params({"w": np.zeros(2, np.float32)})
    assert build_model(get_arch("paper-cnn"), device="cpu").device.type \
        == "cpu"
