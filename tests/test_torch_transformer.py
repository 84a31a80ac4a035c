"""Port parity for the dense decoder family: `models/transformer.py` and
`models/layers.py` against the JAX reference on converted parameters,
and the flash-attention kernel's plain version against the Pallas kernel
in interpret mode.

Tolerances (f32): logits atol 2e-5 and the loss rtol 1e-5 (a few layers
of f32 products in another order; logits are O(1)); the chunked attention
and the kernel's plain version atol 2e-6 against the reference's (one
softmax over ≤ 200 keys, summed in another order)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro.models.transformer import lm_eval_fn as jax_lm_eval_fn
from repro_torch.configs import ARCHS, ArchConfig, MoEConfig, get_arch
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import build_model, lm_eval_fn
from repro_torch.models import layers as TL

torch.set_num_threads(2)

# reduced llama3.2-1b with GQA (4 heads over 2 kv heads); the reduced
# config keeps the sliding window (64), which the 80-token batch crosses
SMALL = dict(n_kv_heads=2, d_ff=256, vocab_size=300)


def _models(tied, n_layers=2):
    kw = dict(SMALL, n_layers=n_layers, tie_embeddings=tied)
    jm = jax_build_model(dataclasses.replace(
        jax_get_arch("llama3.2-1b").reduced(), **kw))
    tm = build_model(dataclasses.replace(
        get_arch("llama3.2-1b").reduced(), **kw), device="cpu")
    return jm, tm


@pytest.mark.parametrize("tied", [True, False])
def test_forward_and_loss_match_reference(tied):
    jm, tm = _models(tied)
    params = tm.init(0)                      # carried to the reference
    jp = jax.tree.map(jnp.asarray, to_jax_params(params))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 300, (2, 80)).astype(np.int32)
    labels = rng.integers(0, 300, (2, 80)).astype(np.int32)
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    got = tm.forward(params, {"tokens": torch.from_numpy(tokens)}).numpy()
    assert got.shape == want.shape == (2, 80, 300) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    batch = {"tokens": tokens, "labels": labels}
    jloss = float(jm.loss_fn(jp, jax.tree.map(jnp.asarray, batch)))
    tloss = float(tm.loss_fn(params, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    np.testing.assert_allclose(float(lm_eval_fn(tm, batch)(params)),
                               float(jax_lm_eval_fn(jm, batch)(jp)),
                               rtol=1e-5)


def test_init_matches_reference_in_structure_and_distribution():
    jm, tm = _models(tied=False, n_layers=4)
    want = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    got = tm.init(0)
    ref = from_jax_params(want, "cpu")
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
        np.testing.assert_allclose(float(got[k].std()), float(ref[k].std()),
                                   rtol=0.1, err_msg=k)
    # a reference config reduces to the port's
    jr = jax_get_arch("llama3.2-1b").reduced()
    tr = get_arch("llama3.2-1b").reduced()
    for f in dataclasses.fields(tr):
        assert getattr(tr, f.name) == getattr(jr, f.name), f.name


@pytest.mark.parametrize("causal,window,q_offset,tq,tk,kv_block", [
    (True, 0, 0, 40, 40, 16), (True, 9, 0, 37, 37, 8),
    (False, 0, 0, 12, 45, 16), (True, 0, 5, 7, 12, 512)])
def test_chunked_attention_matches_reference(causal, window, q_offset, tq,
                                             tk, kv_block):
    rng = np.random.default_rng(tq + tk)
    q = rng.normal(size=(2, tq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, tk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, tk, 2, 16)).astype(np.float32)
    want = np.asarray(JL.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        q_offset=q_offset, kv_block=kv_block))
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, window=window, q_offset=q_offset,
                             kv_block=kv_block).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("b,tq,tk,h,kv,causal,window", [
    (1, 130, 130, 4, 1, True, 0),       # causal, GQA 4:1, ragged blocks
    (2, 200, 200, 2, 2, True, 48),      # sliding window
    (1, 64, 90, 4, 2, False, 0),        # ragged Tk, bidirectional
])
def test_kernel_plain_version_matches_pallas(b, tq, tk, h, kv, causal,
                                             window):
    rng = np.random.default_rng(tq * tk)
    q = rng.normal(size=(b, tq, h, 32)).astype(np.float32)
    k = rng.normal(size=(b, tk, kv, 32)).astype(np.float32)
    v = rng.normal(size=(b, tk, kv, 32)).astype(np.float32)
    want = np.asarray(flash_attention_pallas(
        *map(jnp.asarray, (q, k, v)), causal=causal, window=window,
        interpret=True))
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    bf = attention_ref(*(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
                       causal=causal, window=window)
    assert bf.dtype == torch.bfloat16 and bf.shape == (b, tq, h, 32)


def test_families_not_ported_raise():
    base = dict(name="x", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=100)
    # every family of the reference builds: the encoder-decoder (ported)
    # runs a forward over source embeddings
    encdec = build_model(ArchConfig(family="encdec", n_encoder_layers=1,
                                    **base), device="cpu")
    logits = encdec.forward(encdec.init(0), {
        "tokens": torch.zeros((1, 5), dtype=torch.int64),
        "src_embeds": torch.ones((1, 7, 64))})
    assert logits.shape == (1, 5, 100) and torch.isfinite(logits).all()
    assert set(encdec.init_cache(1, 5)) == {"k", "v", "cross_k", "cross_v"}
    families = set()
    for cfg in ARCHS.values():              # no registered family raises
        assert build_model(cfg.reduced(), device="cpu").cfg.family == \
            cfg.family
        families.add(cfg.family)
    assert families == {"cnn", "dense", "encdec", "hybrid", "moe", "ssm",
                        "vlm"}
    for family in ("vlm", "audio"):         # the dense backbone, ported
        m = build_model(ArchConfig(family=family, **base), device="cpu")
        assert m.init_cache(1, 5)["k"].shape == (2, 1, 5, 2, 16)
    moe = build_model(ArchConfig(family="moe", moe=MoEConfig(4, 2, 32),
                                 **base), device="cpu")   # ported: it builds
    logits = moe.forward(moe.init(0), {"tokens": torch.zeros(
        (1, 5), dtype=torch.int64)})
    assert logits.shape == (1, 5, 100) and torch.isfinite(logits).all()
    with pytest.raises(ValueError):
        build_model(ArchConfig(family="nonsense", **base), device="cpu")
    model = build_model(ArchConfig(family="dense", **base), device="cpu")
    params = model.init(0)                  # the dense serving path runs
    tokens = torch.zeros((1, 5), dtype=torch.int64)
    assert model.init_cache(1, 5)["k"].shape == (2, 1, 5, 2, 16)
    logits, cache = model.prefill(params, {"tokens": tokens})
    logits, _ = model.decode(params, tokens[:, :1], cache, 4)
    assert logits.shape == (1, 1, 100) and torch.isfinite(logits).all()
    if not torch.cuda.is_available():      # entry points default to CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(ArchConfig(family="dense", **base))
