"""Port parity for the encoder-decoder family (seamless-m4t): `ArchConfig.
n_encoder_layers` and its `reduced()` rule, `layers.cross_attn_init` and
`cross_attention`, `transformer.build_encdec` (encode, the decoder with
cross-attention, forward, loss, `init_cache`, prefill and decode with the
four-leaf cache), `launch.steps.make_step` and the step specs for it,
against the JAX reference on the CPU, with the reference's init carried
across by `convert.from_jax_params`. Also the attention's non-causal mode
with Tq ≠ Tk (both ways), which the encoder and the cross-attention take:
the kernel's plain version and the model's chunked CPU route against the
reference's Pallas kernel (interpret mode) and its jnp formulation, and
`FlashAttention` taking that mode on to the launchers (it still refuses
values narrower than the keys).

The config is seamless-m4t-medium `reduced()`: 2 encoder + 2 decoder
layers, d 256, 4/4 heads at head dim 64, d_ff 512, vocab 1,024, f32. The
source is longer than the target (T_src 45 > T 32) and shorter (19 <
32). Inputs are numpy-seeded.

Tolerances (f32), relative normwise unless said: the logits and the loss
1e-5 (a few f32 products and softmaxes in another order); the cache atol
5e-5 as `test_torch_mla.py`'s (k carries rope, whose sin and cos differ
between XLA and PyTorch by ulps of the angle); the round trip
prefill(T−1) + decode(1) against forward(T) 1e-5 (decode's plain softmax
against the chunked one); `cross_attention` and the attention routes
atol 2e-6 as `test_torch_transformer.py`'s; the init's stds within 10% of
the reference's and of 1/√fan_in. `make_step`'s steps run the model's own
functions: bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.kernels.flash_attention import flash_attention_pallas
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch.configs import INPUT_SHAPES, ArchConfig, ShapeConfig, get_arch
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import batch_specs_for, input_specs, make_step
from repro_torch.models import build_model
from repro_torch.models import layers as TL

torch.set_num_threads(2)

NAME = "seamless-m4t-medium"
REL = 1e-5
CACHE_TOL = dict(rtol=0, atol=5e-5)
ATTN_TOL = dict(rtol=0, atol=2e-6)
STD_RTOL = 0.1
T, NEW = 32, 4
T_SRC = (45, 19)               # source longer and shorter than the target
# seamless-m4t-medium's parameters (jax.eval_shape of the reference's
# init): 12 + 12 layers, d 1,024, vocab 256,206 untied
FULL_PARAMS = 977_757_184
CACHE_LEAVES = {"k", "v", "cross_k", "cross_v"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _grow_jax(cache, n):
    """k and v grown by n entries on axis 2; the cross leaves as they are."""
    return {k: jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
            if k in ("k", "v") else c for k, c in cache.items()}


def _grow_port(cache, n):
    return {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n))
            if k in ("k", "v") else c for k, c in cache.items()}


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_reference(reduced):
    """seamless-m4t-medium field for field, full and `reduced()` (2 + 2
    layers, d 256, 4/4 heads, vocab 1,024, f32); `reduced()` keeps a
    config without an encoder at 0 encoder layers."""
    jc, tc = jax_get_arch(NAME), get_arch(NAME)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    for f in dataclasses.fields(tc):
        assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    want = (2, 2, 256, 4, 4, 1024) if reduced else \
        (12, 12, 1024, 16, 16, 256206)
    assert (tc.n_layers, tc.n_encoder_layers, tc.d_model, tc.n_heads,
            tc.n_kv_heads, tc.vocab_size) == want
    assert tc.family == "encdec" and tc.resolved_head_dim == 64
    assert get_arch("llama3.2-1b").reduced().n_encoder_layers == 0


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """The reference model, its params (its own init, seed 0), the port's
    model and its copy of the params, tokens and labels (2, T), and the
    source embeddings (2, T_src, d) at each T_SRC."""
    jcfg, tcfg = jax_get_arch(NAME).reduced(), get_arch(NAME).reduced()
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(33)
    tokens = rng.integers(0, tcfg.vocab_size, (2, T)).astype(np.int32)
    labels = rng.integers(0, tcfg.vocab_size, (2, T)).astype(np.int32)
    srcs = {s: rng.normal(size=(2, s, tcfg.d_model)).astype(np.float32)
            for s in T_SRC}
    return dict(jm=jm, jp=jax.tree.map(jnp.asarray, jp), np_params=jp,
                tm=build_model(tcfg, device="cpu"),
                tp=from_jax_params(jp, "cpu"), tokens=tokens,
                labels=labels, srcs=srcs)


def _batches(m, t_src, t=T, labels=False):
    """The (reference, port) batches of the first t tokens over the
    source of length t_src."""
    b = {"tokens": m["tokens"][:, :t], "src_embeds": m["srcs"][t_src]}
    if labels:
        b["labels"] = m["labels"][:, :t]
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.from_numpy(v) for k, v in b.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_matches_reference(dtype):
    """Leaf names in the reference's order, shapes, dtypes and stds (within
    10% of the reference's and, for the matrices, of 1/√fan_in); norm
    scales 1."""
    jcfg, tcfg = (dataclasses.replace(c.reduced(), param_dtype=dtype)
                  for c in (jax_get_arch(NAME), get_arch(NAME)))
    want = from_jax_params(jax.tree.map(np.asarray, jax_build_model(
        jcfg).init(jax.random.PRNGKey(0))), "cpu")
    got = build_model(tcfg, device="cpu").init(0)
    assert list(got) == list(want)
    assert {k.split(".")[0] for k in got} == {
        "decoder", "embed", "encoder", "final_norm", "lm_head"}
    assert sorted({".".join(k.split(".")[1:-1]) for k in got
                   if k.startswith("decoder.")}) == [
        "cross_attn", "ffn", "ln1", "ln2", "ln_x", "self_attn"]
    d, ff = tcfg.d_model, tcfg.d_ff
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        if k.endswith("scale"):
            assert torch.equal(got[k], want[k]), k
            continue
        std = float(got[k].float().std())
        np.testing.assert_allclose(std, float(want[k].float().std()),
                                   rtol=STD_RTOL, err_msg=k)
        if k == "embed":
            continue
        fan_in = ff if k.endswith("w_down") else d
        np.testing.assert_allclose(std, fan_in ** -0.5, rtol=STD_RTOL,
                                   err_msg=k)
    assert got["encoder.attn.wq"].shape == (2, d, d)
    assert got["decoder.cross_attn.wk"].shape == (2, d, d)


def test_params_cross_by_plain_copy(models):
    """The reference's encdec pytree crosses by `from_jax_params` value for
    value, and back (`to_jax_params`) bitwise."""
    jp, tp = models["np_params"], models["tp"]
    for name, t in tp.items():
        node = jp
        for part in name.split("."):
            node = node[part]
        np.testing.assert_array_equal(t.numpy(), node, err_msg=name)
    back = to_jax_params(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t_q,t_src", [(24, 45), (24, 19)])
def test_cross_attention_matches_reference(models, t_q, t_src):
    """Layer 0's cross-attention: queries from x (2, t_q, d), keys and
    values projected from a source of t_src rows."""
    jcfg, tcfg = jax_get_arch(NAME).reduced(), models["tm"].cfg
    jp = jax.tree.map(lambda a: a[0], models["jp"]["decoder"]["cross_attn"])
    tp = {k[len("decoder.cross_attn."):]: v[0] for k, v in
          models["tp"].items() if k.startswith("decoder.cross_attn.")}
    rng = np.random.default_rng(t_q * t_src)
    x = rng.normal(size=(2, t_q, tcfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, t_src, tcfg.d_model)).astype(np.float32)
    kv, hd = tcfg.n_kv_heads, tcfg.resolved_head_dim
    jk = (JL._proj(jnp.asarray(enc), jp["wk"]).reshape(2, t_src, kv, hd),
          JL._proj(jnp.asarray(enc), jp["wv"]).reshape(2, t_src, kv, hd))
    want = np.asarray(JL.cross_attention(jp, jcfg, jnp.asarray(x), jk))
    got = TL.cross_attention(tp, tcfg, torch.from_numpy(x),
                             tuple(torch.from_numpy(np.array(a))
                                   for a in jk))
    assert tuple(got.shape) == want.shape == (2, t_q, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    assert TL.cross_attn_init(torch.Generator().manual_seed(0), tcfg,
                              torch.float32).keys() == tp.keys()


@pytest.mark.parametrize("t_src", T_SRC)
def test_forward_and_loss_match_reference(models, t_src):
    jm, jp, tm, tp = models["jm"], models["jp"], models["tm"], models["tp"]
    jb, tb = _batches(models, t_src, labels=True)
    want = np.asarray(jm.forward(jp, jb))
    got = tm.forward(tp, tb)
    assert got.shape == want.shape == (2, T, tm.cfg.vocab_size)
    assert got.dtype == torch.float32
    assert _rel(_np(got), want) <= REL
    np.testing.assert_allclose(float(tm.loss_fn(tp, tb)),
                               float(jm.loss_fn(jp, jb)), rtol=REL)


def _assert_step(want, got, src_len):
    (jl, jc), (tl, tc) = want, got
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert _rel(_np(tl), jl) <= REL
    assert set(tc) == set(jc) == CACHE_LEAVES
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), err_msg=k,
                                   **CACHE_TOL)
    assert tc["cross_k"].shape[2] == src_len


@pytest.mark.parametrize("t_src", T_SRC)
def test_prefill_and_decode_match_reference(models, t_src):
    """prefill of the first T − NEW tokens over the source (logits and the
    four leaves: k, v (L, B, T − NEW, KV, hd), cross_k, cross_v (L, B,
    T_src, KV, hd)), k/v grown by NEW, then NEW decode steps of the given
    tokens (logits and the whole cache after each; k and v grow, the
    cross leaves come back as they went in)."""
    jm, jp, tm, tp = models["jm"], models["jp"], models["tm"], models["tp"]
    t = T - NEW
    jb, tb = _batches(models, t_src, t)
    jl, jc = jax.jit(jm.prefill)(jp, jb)
    tl, tc = tm.prefill(tp, tb)
    _assert_step((jl, jc), (tl, tc), t_src)
    assert tuple(tc["k"].shape) == (2, 2, t, 4, 64)
    jc, tc = _grow_jax(jc, NEW), _grow_port(tc, NEW)
    decode = jax.jit(jm.decode)
    tokens = models["tokens"]
    for pos in range(t, T):
        tok = tokens[:, pos:pos + 1]
        given = tc
        before = {k: v.clone() for k, v in given.items()}
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(pos))
        tl, tc = tm.decode(tp, torch.from_numpy(tok), given, pos)
        _assert_step((jl, jc), (tl, tc), t_src)
        assert tc["cross_k"] is given["cross_k"] and \
            tc["cross_v"] is given["cross_v"]
        assert all(torch.equal(given[k], before[k]) for k in given)
        for k in ("k", "v"):
            assert torch.equal(tc[k][:, :, :pos], before[k][:, :, :pos])
            assert not torch.equal(tc[k][:, :, pos], before[k][:, :, pos])


@pytest.mark.parametrize("t_src", T_SRC)
def test_roundtrip_prefill_decode_matches_forward(models, t_src):
    """prefill(T − 1) + decode(1) at position T − 1 against forward(T) at
    the last position, and the reference's decode logits there."""
    jm, jp, tm, tp = models["jm"], models["jp"], models["tm"], models["tp"]
    _, tb = _batches(models, t_src)
    full = tm.forward(tp, tb)
    jb, tb1 = _batches(models, t_src, T - 1)
    _, cache = tm.prefill(tp, tb1)
    tok = models["tokens"][:, T - 1:T]
    logits, _ = tm.decode(tp, torch.from_numpy(tok), _grow_port(cache, 1),
                          T - 1)
    assert _rel(_np(logits[:, 0]), _np(full[:, -1])) <= REL
    _, jc = jm.prefill(jp, jb)
    jl, _ = jm.decode(jp, jnp.asarray(tok), _grow_jax(jc, 1),
                      jnp.int32(T - 1))
    assert _rel(_np(logits), jl) <= REL


def test_decode_past_the_cache_raises(models):
    """C8: decode at pos ≥ W (the self cache's entries) raises where the
    reference clamps the write; a negative pos raises; the cross leaves'
    length bounds nothing."""
    tm, tp = models["tm"], models["tp"]
    _, tb = _batches(models, 45, 10)
    _, cache = tm.prefill(tp, tb)
    tok = tb["tokens"][:, :1]
    for pos in (10, torch.tensor(12), 44, -1):
        with pytest.raises(ValueError, match="position"):
            tm.decode(tp, tok, cache, pos)
    logits, _ = tm.decode(tp, tok, _grow_port(cache, 1), torch.tensor(10))
    assert torch.isfinite(logits).all()


def test_init_cache_matches_reference(models):
    """Four zero leaves; the cross leaves at src_len (seq_len without it);
    the dtype given or the param dtype."""
    jm, tm = models["jm"], models["tm"]
    for args in ((3, 20), (3, 20, None, 7)):
        want = jm.init_cache(*args)
        got = tm.init_cache(*args)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
        assert all(v.dtype == torch.float32 and not v.any()
                   for v in got.values())
    assert tm.init_cache(1, 5, torch.bfloat16)["cross_v"].dtype == \
        torch.bfloat16


def test_make_step_serves_the_encdec_family(models):
    """make_step's prefill is the model's; its decode step is the eager
    `serve_step` (no captured decode for this family), bitwise the model's
    decode over NEW greedy tokens; the cross leaves pass through it."""
    tm, tp = models["tm"], models["tp"]
    t = T - NEW
    _, batch = _batches(models, 45, t)
    prefill = make_step(tm.cfg, ShapeConfig("p", t, 2, "prefill"),
                        device="cpu")
    serve = make_step(tm.cfg, ShapeConfig("d", T, 2, "decode"),
                      device="cpu")
    assert serve.__name__ == "serve_step"
    logits, cache = prefill(tp, batch)
    want_l, want_c = tm.prefill(tp, batch)
    assert torch.equal(logits, want_l)
    assert all(torch.equal(cache[k], want_c[k]) for k in want_c)
    cache = eager = _grow_port(cache, NEW)
    tok = logits[:, -1].argmax(-1)[:, None]
    for pos in range(t, T):
        want_l, eager = tm.decode(tp, tok, eager, pos)
        logits, cache = serve(tp, tok, cache, pos)
        assert torch.equal(logits, want_l)
        assert set(cache) == CACHE_LEAVES
        assert all(torch.equal(cache[k], eager[k]) for k in cache)
        tok = logits[:, -1].argmax(-1)[:, None]


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {".".join(_key(k) for k in path):
            (tuple(x.shape), str(np.dtype(x.dtype))) for path, x in leaves}


def _port_specs(tree, prefix=""):
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta", prefix
        return {prefix[:-1]: (tuple(tree.shape),
                              str(tree.dtype).replace("torch.", ""))}
    out = {}
    for k, v in tree.items():
        out.update(_port_specs(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_batch_specs_match_reference(shape):
    """The batch of each step kind, full config and reduced: train and
    prefill carry src_embeds (B, T, d_model) in the param dtype."""
    for jc, tc in ((jax_get_arch(NAME), get_arch(NAME)),
                   (jax_get_arch(NAME).reduced(), get_arch(NAME).reduced())):
        want = _jax_specs(jax_steps.batch_specs_for(jc, JAX_SHAPES[shape]))
        got = _port_specs(batch_specs_for(tc, INPUT_SHAPES[shape]))
        assert got == want
        assert ("src_embeds" in got) == (shape != "decode_32k")


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_input_specs_match_reference_at_full_size(shape):
    """Every argument of the full config's serving steps as meta tensors:
    the reference's names, shapes and dtypes (the decode cache the
    reference's `cache_specs_for`: four leaves of (12, 128, 32768, 16,
    64)); 977,757,184 parameters, nothing allocated."""
    want = _jax_specs(jax_steps.input_specs(jax_get_arch(NAME),
                                            JAX_SHAPES[shape]))
    specs = input_specs(get_arch(NAME), INPUT_SHAPES[shape])
    assert _port_specs(specs) == want
    assert sum(v.numel() for v in specs["params"].values()) == FULL_PARAMS
    n_params = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        jax_steps.param_specs_for(jax_get_arch(NAME))))
    assert n_params == FULL_PARAMS
    if shape == "decode_32k":
        cache = _jax_specs(jax_steps.cache_specs_for(jax_get_arch(NAME),
                                                     JAX_SHAPES[shape]))
        assert cache == {n: ((12, 128, 32768, 16, 64), "bfloat16")
                         for n in CACHE_LEAVES}
        assert _port_specs(specs["cache"]) == cache


# ---------------------------------------------------------------------------
# non-causal attention with Tq ≠ Tk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,tq,tk,h,kv,hd,kv_block", [
    (2, 16, 100, 4, 4, 64, 32),     # cross-attention: few queries, long
    (2, 100, 30, 4, 4, 64, 16),     # Tq > Tk
    (1, 77, 133, 8, 2, 32, 512),    # a group of 4, ragged against tiles
    (2, 45, 45, 4, 4, 64, 16)])     # the encoder's self-attention
def test_noncausal_attention_matches_pallas_and_jnp(b, tq, tk, h, kv, hd,
                                                    kv_block):
    """`ref.attention_ref` (the kernel's plain version) and the model's
    chunked CPU route at causal=False against the reference's Pallas
    kernel in interpret mode and its jnp `flash_attention`."""
    rng = np.random.default_rng(tq * tk + h)
    q = rng.normal(size=(b, tq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, tk, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, tk, kv, hd)).astype(np.float32)
    jq = tuple(map(jnp.asarray, (q, k, v)))
    pallas = np.asarray(flash_attention_pallas(*jq, causal=False,
                                               interpret=True))
    chunked_jnp = np.asarray(JL.flash_attention(*jq, causal=False,
                                                kv_block=kv_block))
    np.testing.assert_allclose(pallas, chunked_jnp, **ATTN_TOL)
    tq_ = tuple(map(torch.from_numpy, (q, k, v)))
    plain = attention_ref(*tq_, causal=False)
    chunked = TL.flash_attention(*tq_, causal=False, kv_block=kv_block)
    for got in (plain, chunked):
        assert tuple(got.shape) == (b, tq, h, hd)
        np.testing.assert_allclose(got.numpy(), pallas, **ATTN_TOL)
        np.testing.assert_allclose(got.numpy(), chunked_jnp, **ATTN_TOL)


@pytest.mark.parametrize("causal,tq,tk", [(False, 8, 8), (False, 8, 20),
                                          (True, 8, 20), (True, 20, 8)])
def test_flash_attention_function_refuses_noncausal_and_tq_ne_tk(causal, tq,
                                                                 tk):
    """`FlashAttention` (the route under grad) no longer refuses
    non-causal attention or Tq ≠ Tk (encoder-decoder training, ROADMAP
    8d-train): on CPU tensors it gets past its own checks and stops at
    the forward launcher's device check, as the launcher alone does, with
    no launch of either kernel."""
    q = torch.zeros(1, tq, 2, 64, requires_grad=True)
    k, v = torch.zeros(1, tk, 2, 64), torch.zeros(1, tk, 2, 64)
    launches = (FA.flash_attn_f32.launches, FA.flash_attn_bwd_f32.launches)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.FlashAttention.apply(q, k, v, causal, 0)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.flash_attn_f32(q.detach(), k, v, causal=causal)
    assert (FA.flash_attn_f32.launches,
            FA.flash_attn_bwd_f32.launches) == launches


@pytest.mark.parametrize("causal,tq,tk", [(False, 8, 20), (True, 8, 8)])
def test_flash_attention_function_still_refuses_narrow_values(causal, tq,
                                                              tk):
    """Narrow values with no backward instance ((192, 64)) are still
    refused in the Function before any launch; MLA's (192, 128), which
    the backward kernel now has (MLA training, ROADMAP 8b-train), gets
    past the Function's checks and stops at the forward launcher's
    device check, non-causal and with Tq ≠ Tk too."""
    q = torch.zeros(1, tq, 2, 192, requires_grad=True)
    k = torch.zeros(1, tk, 2, 192)
    launches = (FA.flash_attn_f32.launches, FA.flash_attn_bwd_f32.launches)
    with pytest.raises(ValueError, match="instances"):
        FA.FlashAttention.apply(q, k, torch.zeros(1, tk, 2, 64), causal, 0)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.FlashAttention.apply(q, k, torch.zeros(1, tk, 2, 128), causal, 0)
    assert (FA.flash_attn_f32.launches,
            FA.flash_attn_bwd_f32.launches) == launches


def test_encdec_trains_through_the_chunked_route_on_the_cpu(models):
    """On the CPU the encoder-decoder's loss differentiates through the
    chunked attention (no kernel, so no refusal): every leaf gets a finite
    gradient, the cross-attention's keys and values through the source."""
    tm, tp = models["tm"], models["tp"]
    _, tb = _batches(models, 19, labels=True)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tm.loss_fn(leaves, tb)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert all(torch.isfinite(g).all() for g in grads)
    named = dict(zip(leaves, grads))
    assert float(named["decoder.cross_attn.wk"].abs().sum()) > 0
    assert float(named["encoder.attn.wq"].abs().sum()) > 0


def test_encdec_entry_point_needs_a_device_without_a_gpu():
    """`device="cpu"` builds the family; without a GPU and without
    `device=`, build_model raises (the entry points run on the card
    unless the caller names the CPU)."""
    cfg = ArchConfig(name="x", family="encdec", n_layers=1,
                     n_encoder_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                     d_ff=64, vocab_size=50)
    assert build_model(cfg, device="cpu").device.type == "cpu"
    if not torch.cuda.is_available():      # entry points default to CUDA
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
