"""Port parity for Multi-head Latent Attention (MLA, DeepSeek-V2):
`configs.base.MLAConfig` and its `reduced()` rule, `layers.mla_init`,
`mla_latent` and `mla_attention`, the MLA family of `build_decoder_only`
(`models/transformer.py`: the latent cache ``{"c_kv", "k_rope"}``, prefill
and decode with `_mla_decode_attn`), `launch.steps.make_step`,
`CapturedDecode` and `input_specs` for it, against the JAX reference on
the CPU, with the reference's init carried across by
`convert.from_jax_params`. Also attention whose values are narrower than
its queries and keys (the kernel's (192, 128) instance; its plain
versions here), the attention wrapper's shape checks, and chameleon-34b
(family `vlm`, a dense backbone) reduced against the reference.

The config is deepseek-v2-lite-16b `reduced()`: 2 layers, d 256, 4/4
heads, MLA kv_lora 64 / rope 16 / nope 32 / v 32, 4 experts top-2 with
one shared expert, f32. Inputs are numpy-seeded.

Tolerances (f32), relative normwise unless said: the layer outputs and
the decoder's logits 1e-5 (a few f32 products and softmaxes in another
order); the latent cache atol 5e-5 as `test_torch_dense_decode.py`'s
(k_rope carries rope, whose sin and cos differ between XLA and PyTorch by
ulps of the angle); the round trip prefill(T−1) + decode(1) against
forward(T) 1e-5 at capacity_factor 8.0, where no token drops; the init's
stds within 10% of the reference's and of 1/√fan_in; attention with
narrow values atol 2e-6 against the reference's jnp `flash_attention`, as
`test_torch_transformer.py`'s chunked attention. `decode_into`,
`make_step`'s steps and `CapturedDecode` on the CPU run the model's own
functions: bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs.base import INPUT_SHAPES as JAX_SHAPES
from repro.configs.base import MLAConfig as JaxMLAConfig
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch.configs import (INPUT_SHAPES, MLAConfig, ShapeConfig,
                                 get_arch)
from repro_torch.convert import from_jax_params, to_jax_params
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import CapturedDecode, input_specs, make_step
from repro_torch.models import build_model
from repro_torch.models import layers as TL

torch.set_num_threads(2)

NAME = "deepseek-v2-lite-16b"
REL = 1e-5
CACHE_TOL = dict(rtol=0, atol=5e-5)
ATTN_TOL = dict(rtol=0, atol=2e-6)
STD_RTOL = 0.1
NEW = 4
# deepseek-v2-lite-16b's parameters (jax.eval_shape of the reference's
# init): all 27 layers, which the card serves whole
FULL_PARAMS = 16_210_324_992
MLA_LEAVES = ["kv_norm.scale", "w_dkv", "w_dq", "w_kr", "w_uk", "w_uv", "wo"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _cfgs(cf=None, name=NAME):
    """The reduced config on both packages, with another capacity factor
    when given."""
    out = []
    for c in (jax_get_arch(name).reduced(), get_arch(name).reduced()):
        if cf is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=cf))
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------

def test_mla_config_matches_reference():
    """MLAConfig's defaults; the full config and `reduced()` field for
    field (reduced: kv_lora 64, rope 16, nope 32, v 32 and no head_dim)."""
    assert dataclasses.asdict(MLAConfig()) == dataclasses.asdict(
        JaxMLAConfig())
    for tc, jc in ((get_arch(NAME), jax_get_arch(NAME)),
                   (get_arch(NAME).reduced(), jax_get_arch(NAME).reduced())):
        for f in dataclasses.fields(tc):
            want, got = getattr(jc, f.name), getattr(tc, f.name)
            if f.name in ("mla", "moe"):
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
    r = get_arch(NAME).reduced()
    assert r.head_dim is None and dataclasses.astuple(r.mla) == (64, 16, 32,
                                                                 32)
    assert get_arch("llama3.2-1b").reduced().mla is None


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_init_matches_reference(dtype):
    """The attention leaves of a 4-layer model: names in the reference's
    order, shapes, dtypes and stds (within 10% of the reference's and of
    1/√fan_in: d_model for w_dq, w_dkv, w_kr; kv_lora_rank for w_uk,
    w_uv; H·v for wo), the latent norm's scale 1."""
    jcfg, tcfg = (dataclasses.replace(c, n_layers=4, param_dtype=dtype)
                  for c in _cfgs())
    want = from_jax_params(jax.tree.map(np.asarray, jax_build_model(
        jcfg).init(jax.random.PRNGKey(0))), "cpu")
    got = build_model(tcfg, device="cpu").init(0)
    assert list(got) == list(want)
    attn = [k[len("layers.attn."):] for k in got
            if k.startswith("layers.attn.")]
    assert attn == MLA_LEAVES
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        if k.endswith("scale"):
            assert torch.equal(got[k], want[k]), k
            continue
        np.testing.assert_allclose(float(got[k].float().std()),
                                   float(want[k].float().std()),
                                   rtol=STD_RTOL, err_msg=k)
    m, d, h = tcfg.mla, tcfg.d_model, tcfg.n_heads
    fans = dict(w_dq=d, w_dkv=d, w_kr=d, w_uk=m.kv_lora_rank,
                w_uv=m.kv_lora_rank, wo=h * m.v_head_dim)
    for name, fan_in in fans.items():
        std = float(got[f"layers.attn.{name}"].float().std())
        np.testing.assert_allclose(std, fan_in ** -0.5, rtol=STD_RTOL,
                                   err_msg=name)
    assert got["layers.attn.w_dq"].shape == (4, d, h * 48)
    assert got["layers.attn.kv_norm.scale"].shape == (4, 64)


@pytest.fixture(scope="module")
def layer():
    """One layer's MLA leaves from the reference's init (both packages)
    and a numpy-seeded x (2, 24, d) with its positions."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, JL.mla_init(jax.random.PRNGKey(3), jcfg,
                                              jnp.float32))
    x = np.random.default_rng(4).normal(size=(2, 24, tcfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    return jcfg, tcfg, jp, from_jax_params(jp, "cpu"), x, pos


def test_mla_latent_matches_reference(layer):
    jcfg, tcfg, jp, tp, x, pos = layer
    jc, jr = JL.mla_latent(jax.tree.map(jnp.asarray, jp), jcfg,
                           jnp.asarray(x), jnp.asarray(pos))
    tc, tr = TL.mla_latent(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()))
    assert tuple(tc.shape) == jc.shape == (2, 24, 64)
    assert tuple(tr.shape) == jr.shape == (2, 24, 16)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **CACHE_TOL)
    np.testing.assert_allclose(_np(tr), np.asarray(jr), **CACHE_TOL)
    assert _rel(_np(tc), jc) <= REL


@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_matches_reference(layer, causal):
    """The attention over the reference's own latent (so the two compute
    from the same cacheables), causal and not."""
    jcfg, tcfg, jp, tp, x, pos = layer
    jpp = jax.tree.map(jnp.asarray, jp)
    jc, jr = JL.mla_latent(jpp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    want = JL.mla_attention(jpp, jcfg, jnp.asarray(x), jnp.asarray(pos), jc,
                            jr, causal=causal)
    got = TL.mla_attention(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(pos.copy()),
                           torch.from_numpy(np.array(jc)),
                           torch.from_numpy(np.array(jr)), causal=causal)
    assert tuple(got.shape) == want.shape == (2, 24, tcfg.d_model)
    assert _rel(_np(got), want) <= REL


# ---------------------------------------------------------------------------
# attention with values narrower than the queries and keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,hd,dv,causal,kv_block", [
    (2, 40, 4, 48, 32, True, 16), (2, 40, 4, 48, 32, False, 512),
    (1, 33, 3, 48, 32, True, 8), (1, 64, 4, 192, 128, True, 512),
    (1, 64, 4, 192, 128, True, 16)])
def test_attention_with_narrow_values_matches_reference(b, t, h, hd, dv,
                                                        causal, kv_block):
    """v's head dim below q's and k's (MLA's 192 / 128 at 1 × 64 tokens,
    and 48 / 32): `ref.attention_ref` (the kernel's plain version) and the
    model's chunked CPU route against the reference's jnp
    `flash_attention`, out (B, T, H, dv) at scale hd^-1/2."""
    rng = np.random.default_rng(hd * t + dv)
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, h, dv)).astype(np.float32)
    want = np.asarray(JL.flash_attention(*map(jnp.asarray, (q, k, v)),
                                         causal=causal, kv_block=kv_block))
    assert want.shape == (b, t, h, dv)
    plain = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=causal)
    chunked = TL.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, kv_block=kv_block)
    for got in (plain, chunked):
        assert tuple(got.shape) == (b, t, h, dv)
        np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


@pytest.mark.parametrize("b,t", [(4, 32), (2, 128)])
def test_plain_attention_at_the_cli_mla_dims_matches_jax_grad(b, t):
    """deepseek-v2-lite-16b's `reduced()` heads (q/k 48, v 32), causal, at
    the training CLI's shapes (its tests' 4 × 32 tokens and its default 2
    × 128): `ref.attention_ref` and `ref.attention_bwd_ref` (the (48, 32)
    instances' plain versions) against the reference's jnp
    `flash_attention` and `jax.grad` of ⟨out, dO⟩, at the (192, 128)
    cases' tolerances (`test_torch_moe_train.py`: rtol 1e-5, atol 1e-6 of
    the largest magnitude)."""
    from repro_torch.kernels.ref import attention_bwd_ref, attention_lse_ref
    rng = np.random.default_rng(48 * t + b)
    q = rng.normal(size=(b, t, 4, 48)).astype(np.float32)
    k = rng.normal(size=(b, t, 4, 48)).astype(np.float32)
    v = rng.normal(size=(b, t, 4, 32)).astype(np.float32)
    do = rng.normal(size=(b, t, 4, 32)).astype(np.float32)

    def inner(q, k, v):
        return jnp.sum(JL.flash_attention(q, k, v, causal=True) * do)
    want = jax.grad(inner, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    out = np.asarray(JL.flash_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=True))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    t_out = attention_ref(tq, tk, tv, causal=True)
    np.testing.assert_allclose(t_out.numpy(), out, rtol=1e-5,
                               atol=1e-6 * float(np.abs(out).max()))
    got = attention_bwd_ref(tq, tk, tv, t_out,
                            attention_lse_ref(tq, tk, causal=True), tdo,
                            causal=True)
    for g, w, x in zip(got, want, (q, k, v)):
        w = np.asarray(w)
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))


@pytest.mark.parametrize("hd,dv", [(192, 128), (48, 32)])
def test_attention_wrapper_checks_head_dims(hd, dv):
    """On CPU tensors (no launch): MLA's (192, 128) and its reduced (48,
    32) pass the forward's and the backward's shape checks and stop at the
    device check, in the launchers and in `FlashAttention` (MLA training,
    which the backward kernel's instances carry); a pair without an
    instance is refused by all three before any launch."""
    assert (hd, dv) in FA.DIM_PAIRS and (128, 128) in FA.DIM_PAIRS
    q, k = torch.zeros(1, 8, 2, hd), torch.zeros(1, 8, 2, hd)
    v = torch.zeros(1, 8, 2, dv)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.flash_attn_f32(q, k, v)
    for bad_hd, bad_dv in ((192, 64), (128, 64), (96, 96), (64, 128),
                           (48, 48), (48, 16), (32, 48)):
        with pytest.raises(ValueError, match="instances"):
            FA.flash_attn_f32(torch.zeros(1, 8, 2, bad_hd),
                              torch.zeros(1, 8, 2, bad_hd),
                              torch.zeros(1, 8, 2, bad_dv))
    with pytest.raises(ValueError, match="dv"):
        FA.flash_attn_f32(q, k, torch.zeros(1, 7, 2, dv))
    launches = (FA.flash_attn_f32.launches, FA.flash_attn_bwd_f32.launches)
    out, lse = torch.zeros(1, 8, 2, dv), torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.FlashAttention.apply(q.clone().requires_grad_(True), k, v, True,
                                0)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.flash_attn_bwd_f32(q, k, v, out, lse, out)
    with pytest.raises(ValueError, match="must be"):
        FA.flash_attn_bwd_f32(q, k, v, q, lse, q)    # out at q's width
    for bad_hd, bad_dv in ((128, 64), (192, 64), (48, 16)):
        qq, narrow = torch.zeros(1, 8, 2, bad_hd), torch.zeros(1, 8, 2,
                                                               bad_dv)
        with pytest.raises(ValueError, match="instances"):
            FA.flash_attn_bwd_f32(qq, qq, narrow, narrow, lse, narrow)
        with pytest.raises(ValueError, match="instances"):
            FA.FlashAttention.apply(qq.clone().requires_grad_(True), qq,
                                    narrow, True, 0)
    assert (FA.flash_attn_f32.launches,
            FA.flash_attn_bwd_f32.launches) == launches


# ---------------------------------------------------------------------------
# the decoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    """Per capacity factor (the config's, and 8.0): the reference model,
    its params (its own init, seed 0), the port's model and its copy of
    the params, and a (2, 64) token and label array."""
    out = {}
    for cf in (None, 8.0):
        jcfg, tcfg = _cfgs(cf)
        jm = jax_build_model(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(12)
        tokens = rng.integers(0, tcfg.vocab_size, (2, 64)).astype(np.int32)
        labels = rng.integers(0, tcfg.vocab_size, (2, 64)).astype(np.int32)
        out[cf] = (jm, jax.tree.map(jnp.asarray, jp),
                   build_model(tcfg, device="cpu"), from_jax_params(jp, "cpu"),
                   tokens, labels, jp)
    return out


def test_params_cross_by_plain_copy(models):
    """The reference's MLA leaves cross in its order, value for value, and
    back (`to_jax_params`) bitwise."""
    *_, tp, _, _, jp = models[None]
    attn = [k for k in tp if k.startswith("layers.attn.")]
    assert attn == [f"layers.attn.{n}" for n in MLA_LEAVES]
    for name in MLA_LEAVES:
        node = jp["layers"]["attn"]
        for part in name.split("."):
            node = node[part]
        np.testing.assert_array_equal(tp[f"layers.attn.{name}"].numpy(),
                                      node)
    back = to_jax_params(tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


def test_forward_and_loss_match_reference(models):
    jm, jp, tm, tp, tokens, labels, _ = models[None]
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    got = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape == (2, 64, tm.cfg.vocab_size)
    assert _rel(_np(got), want) <= REL
    batch = {"tokens": tokens, "labels": labels}
    jloss = float(jm.loss_fn(jp, jax.tree.map(jnp.asarray, batch)))
    tloss = float(tm.loss_fn(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}))
    np.testing.assert_allclose(tloss, jloss, rtol=REL)


def _grow_jax(cache, n):
    return {k: jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0)))
            for k, c in cache.items()}


def _grow_port(cache, n):
    return {k: torch.nn.functional.pad(c, (0, 0, 0, n))
            for k, c in cache.items()}


def _assert_step(want, got):
    (jl, jc), (tl, tc) = want, got
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert _rel(_np(tl), jl) <= REL
    assert set(tc) == set(jc) == {"c_kv", "k_rope"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), err_msg=k,
                                   **CACHE_TOL)


def test_prefill_and_decode_match_reference(models):
    """prefill of 56 tokens, the latent cache grown by NEW, and NEW decode
    steps of the given tokens: logits and the whole cache (c_kv (L, B, S,
    64), k_rope (L, B, S, 16)) after each; `decode_into` on a copy of the
    cache with a 0-d pos gives decode's logits and cache bitwise."""
    jm, jp, tm, tp, tokens, _, _ = models[None]
    t = 56
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens[:, :t])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :t])})
    _assert_step((jl, jc), (tl, tc))
    assert tuple(tc["c_kv"].shape) == (2, 2, t, 64)
    assert tuple(tc["k_rope"].shape) == (2, 2, t, 16)
    jc, tc = _grow_jax(jc, NEW), _grow_port(tc, NEW)
    decode = jax.jit(jm.decode)
    body = tm.decode.decode_into
    for pos in range(t, t + NEW):
        tok = tokens[:, pos:pos + 1]
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(pos))
        into = {k: v.clone() for k, v in tc.items()}
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, pos)
        _assert_step((jl, jc), (tl, tc))
        got = body(tp, torch.from_numpy(tok), into, torch.tensor(pos))
        assert torch.equal(got, tl)
        assert all(torch.equal(into[k], tc[k]) for k in tc)


def test_init_cache_is_the_latent(models):
    jm, _, tm, _, _, _, _ = models[None]
    want = jm.init_cache(3, 20)
    got = tm.init_cache(3, 20)
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: v.shape for k, v in want.items()}
    assert all(v.dtype == torch.float32 and not v.any()
               for v in got.values())
    assert tm.init_cache(1, 5, torch.bfloat16)["c_kv"].dtype == \
        torch.bfloat16


@pytest.mark.parametrize("t", [33, 63])
def test_roundtrip_at_wide_capacity(models, t):
    """The port's prefill(t) + decode at position t against its
    forward(t + 1) at the last position, at capacity_factor 8.0 (no
    token drops), and the reference's decode logits there."""
    jm, jp, tm, tp, tokens, _, _ = models[8.0]
    full = tm.forward(tp, {"tokens": torch.from_numpy(tokens[:, :t + 1])})
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :t])})
    tok = tokens[:, t:t + 1]
    logits, _ = tm.decode(tp, torch.from_numpy(tok), _grow_port(cache, 1), t)
    assert _rel(_np(logits[:, 0]), _np(full[:, t])) <= REL
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :t])})
    jl, _ = jm.decode(jp, jnp.asarray(tok), _grow_jax(jc, 1), jnp.int32(t))
    assert _rel(_np(logits), jl) <= REL


def test_decode_past_the_latent_cache_raises(models):
    """C8's check reads the latent cache's length."""
    _, _, tm, tp, tokens, _, _ = models[None]
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :10])})
    tok = torch.from_numpy(tokens[:, 10:11])
    step = CapturedDecode(tm, 2, 10)
    for pos in (10, torch.tensor(12), -1):
        with pytest.raises(ValueError, match="position"):
            tm.decode(tp, tok, cache, pos)
        with pytest.raises(ValueError, match="position"):
            step(tp, tok, cache, pos)


def test_make_step_serves_the_mla_family(models):
    """make_step's prefill is the model's; its decode step is a
    `CapturedDecode` on buffers named and shaped as `init_cache`'s (eager
    on the CPU), bitwise the eager decode over NEW greedy tokens."""
    _, _, tm, tp, tokens, _, _ = models[None]
    t = 40
    prompt = {"tokens": torch.from_numpy(tokens[:, :t])}
    prefill = make_step(tm.cfg, ShapeConfig("p", t, 2, "prefill"),
                        device="cpu")
    serve = make_step(tm.cfg, ShapeConfig("d", t + NEW, 2, "decode"),
                      device="cpu")
    assert isinstance(serve, CapturedDecode)
    assert serve.cache_shapes == {k: tuple(v.shape) for k, v in
                                  tm.init_cache(2, t + NEW).items()}
    logits, cache = prefill(tp, prompt)
    want_l, want_c = tm.prefill(tp, prompt)
    assert torch.equal(logits, want_l)
    assert all(torch.equal(cache[k], want_c[k]) for k in want_c)
    cache = eager = _grow_port(cache, NEW)
    tok = logits[:, -1].argmax(-1)[:, None]
    for i, pos in enumerate(range(t, t + NEW)):
        want_l, eager = tm.decode(tp, tok, eager, pos)
        arg = torch.tensor(pos) if i == 1 else pos
        logits, cache = serve(tp, tok, cache, arg)
        assert logits is serve.logits and cache is serve.cache
        assert torch.equal(logits, want_l)
        assert set(cache) == {"c_kv", "k_rope"}
        assert all(torch.equal(cache[k], eager[k]) for k in cache)
        tok = logits[:, -1].argmax(-1)[:, None]
    assert serve.cache_loads == 1
    assert serve.captures == serve.replays == 0      # no graph on the CPU
    with pytest.raises(ValueError, match="buffers"):
        serve(tp, tok, {"k": cache["c_kv"], "v": cache["k_rope"]}, t)


def test_captured_decode_keeps_the_dense_cache():
    """A dense model's step still holds {"k", "v"} of (L, B, W, KV, hd)."""
    cfg = dataclasses.replace(get_arch("llama3.2-1b").reduced(),
                              n_kv_heads=2)
    step = CapturedDecode(build_model(cfg, device="cpu"), 3, 70)
    assert step.cache_shapes == {"k": (2, 3, 64, 2, 64),
                                 "v": (2, 3, 64, 2, 64)}
    assert step.entries == 64


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


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_input_specs_match_reference_at_full_size(shape):
    """Every argument of the full 27-layer config's serving steps as meta
    tensors: the reference's names, shapes and dtypes (the decode cache
    the reference's `cache_specs_for`: c_kv (27, 128, 32768, 512), k_rope
    (27, 128, 32768, 64)); 16.21 B parameters, nothing allocated."""
    want = _jax_specs(jax_steps.input_specs(jax_get_arch(NAME),
                                            JAX_SHAPES[shape]))
    specs = input_specs(get_arch(NAME), INPUT_SHAPES[shape])
    assert _port_specs(specs) == want
    assert sum(v.numel() for v in specs["params"].values()) == FULL_PARAMS
    if shape == "decode_32k":
        cache = _jax_specs(jax_steps.cache_specs_for(jax_get_arch(NAME),
                                                     JAX_SHAPES[shape]))
        assert cache == {"c_kv": ((27, 128, 32768, 512), "bfloat16"),
                         "k_rope": ((27, 128, 32768, 64), "bfloat16")}
        assert _port_specs(specs["cache"]) == cache


# ---------------------------------------------------------------------------
# chameleon-34b: the vlm family's dense backbone
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chameleon():
    jcfg, tcfg = (jax_get_arch("chameleon-34b").reduced(),
                  get_arch("chameleon-34b").reduced())
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    tokens = np.random.default_rng(13).integers(
        0, tcfg.vocab_size, (2, 40)).astype(np.int32)
    return (jm, jax.tree.map(jnp.asarray, jp), build_model(tcfg, "cpu"),
            from_jax_params(jp, "cpu"), tokens)


@pytest.mark.parametrize("step", ["config", "forward", "prefill", "decode"])
def test_chameleon_reduced_matches_reference(chameleon, step):
    """chameleon-34b (family `vlm`) builds through `build_decoder_only`,
    as the reference's `build_model` routes it: its config field for
    field, then forward, prefill (logits, cache) and 3 decode steps of
    `reduced()` against the reference (logits 1e-5 normwise, cache atol
    5e-5)."""
    jm, jp, tm, tp, tokens = chameleon
    if step == "config":
        for full in (False, True):
            jc, tc = jax_get_arch("chameleon-34b"), get_arch("chameleon-34b")
            if not full:
                jc, tc = jc.reduced(), tc.reduced()
            for f in dataclasses.fields(tc):
                assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tm.cfg.family == "vlm" and tm.cfg.mla is None
        assert set(tm.init_cache(1, 4)) == {"k", "v"}
        return
    if step == "forward":
        want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
        got = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
        assert _rel(_np(got), want) <= REL
        return
    t = 36
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :t])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :t])})
    steps = [((jl, jc), (tl, tc))]
    if step == "decode":
        grow = t + 3
        jc = {k: jnp.pad(c, ((0, 0), (0, 0), (0, 3), (0, 0), (0, 0)))
              for k, c in jc.items()}
        serve = make_step(tm.cfg, ShapeConfig("d", grow, 2, "decode"),
                          device="cpu")
        tc = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 3))
              for k, c in tc.items()}
        steps = []
        for pos in range(t, t + 3):
            tok = tokens[:, pos:pos + 1]
            jl, jc = jm.decode(jp, jnp.asarray(tok), jc, jnp.int32(pos))
            tl, tc = serve(tp, torch.from_numpy(tok), tc, pos)
            # the step's own buffers: the next call overwrites them
            steps.append(((jl, jc), (tl.clone(), {k: v.clone() for k, v
                                                  in tc.items()})))
    for (jl, jc), (tl, tc) in steps:
        assert _rel(_np(tl), jl) <= REL
        assert set(tc) == set(jc) == {"k", "v"}
        for k in jc:
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), err_msg=k,
                                       **CACHE_TOL)
