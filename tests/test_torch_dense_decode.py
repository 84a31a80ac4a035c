"""Port parity for the dense family's serving path: `init_cache`,
`prefill` (with `_ring_pack`) and `decode` of `build_decoder_only`
(`models/transformer.py`), `layers.decode_attention(window=)`,
`launch.steps.make_step` and `CapturedDecode` on the CPU, against the JAX
reference on reduced configs with parameters from the reference's init
carried across by `convert.from_jax_params`.

The models: llama3.2-1b reduced (2 layers, d 256, window 64) and qwen2-7b
reduced (no window, QKV bias), each with 2 kv heads for 4 query heads
(GQA) and a vocabulary of 300; the reference's zero biases are replaced
by random ones on both sides, so the bias is exercised. The cache
layouts decode is right for: a prompt shorter than the window (or any
prompt without one) with the cache grown by the new tokens, and a prompt
longer than the window, ring-packed and not grown. ROADMAP C14's two
wrong layouts (a ring-packed cache grown; a short prompt's cache not
grown) are held to the reference too, and shown to miss the forward.

Tolerances (f32, logits O(1), keys and values up to ~5): prefill and
decode logits atol 2e-5 against the reference's (two layers of f32
products and softmaxes in another order: they read ≤ 3e-6); caches atol
5e-5, as the SSM models' (`test_torch_ssm_models.py`): the keys carry
rope, whose sin and cos of angles up to ~90 rad differ between XLA and
PyTorch by ulps of the angle (layer 0's keys read up to 1.6e-5 where its
values, without rope, read 1.2e-6); the port's prefill(T−1) + decode(1) against
its forward(T) at the last position atol 1e-4 (the decode's plain softmax
against the chunked one over two layers); C14's layouts miss the forward
by more than 1e-2 (they read 0.23 and 0.34; the correct layouts ≤ 2e-6). `make_step` and `CapturedDecode`
on the CPU run the model's own functions: bitwise."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch.configs import ShapeConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.launch import CapturedDecode, make_step
from repro_torch.models import build_model
from repro_torch.models import layers as TL

torch.set_num_threads(2)

LOGIT_TOL = dict(rtol=0, atol=2e-5)
CACHE_TOL = dict(rtol=0, atol=5e-5)
ROUNDTRIP_TOL = dict(rtol=0, atol=1e-4)
C14_MISS = 1e-2
SMALL = dict(n_kv_heads=2, vocab_size=300)
NAMES = ["llama3.2-1b", "qwen2-7b"]
NEW = 3


def _cfgs(name):
    return (dataclasses.replace(jax_get_arch(name).reduced(), **SMALL),
            dataclasses.replace(get_arch(name).reduced(), **SMALL))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def models():
    """Per config: the reference model, its params, the port's model and
    its copy of the params, and a (2, 90) token array."""
    out = {}
    for i, name in enumerate(NAMES):
        jcfg, tcfg = _cfgs(name)
        jm = jax_build_model(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(i)))
        if tcfg.qkv_bias:
            rng = np.random.default_rng(7)
            attn = jp["layers"]["attn"]
            for b in ("bq", "bk", "bv"):
                attn[b] = rng.normal(0, 0.5, attn[b].shape).astype(
                    np.float32)
        tm = build_model(tcfg, device="cpu")
        tokens = np.random.default_rng(11 + i).integers(
            0, tcfg.vocab_size, (2, 90)).astype(np.int32)
        out[name] = (jm, jax.tree.map(jnp.asarray, jp), tm,
                     from_jax_params(jp, "cpu"), tokens)
    return out


def _grow_jax(cache, n):
    return {k: jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
            for k, c in cache.items()}


def _grow_port(cache, n):
    return {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n))
            for k, c in cache.items()}


def _serve_both(models, name, t, grow, n_new):
    """Prefill of tokens[:, :t] and n_new decode steps (the given tokens,
    not greedy ones) on both packages, the cache grown by `grow` slots
    after prefill; returns [(reference logits, cache), (port's)] for the
    prefill and each decode step."""
    jm, jp, tm, tp, tokens = models[name]
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens[:, :t])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :t])})
    steps = [((jl, jc), (tl, tc))]
    if grow:
        jc, tc = _grow_jax(jc, grow), _grow_port(tc, grow)
    decode = jax.jit(jm.decode)
    for pos in range(t, t + n_new):
        tok = tokens[:, pos:pos + 1]
        jl, jc = decode(jp, jnp.asarray(tok), jc, jnp.int32(pos))
        tl, tc = tm.decode(tp, torch.from_numpy(tok), tc, pos)
        steps.append(((jl, jc), (tl, tc)))
    return steps


def _assert_step(want, got):
    (jl, jc), (tl, tc) = want, got
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(_np(tl), _np(jl), **LOGIT_TOL)
    assert set(tc) == set(jc) == {"k", "v"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), err_msg=k,
                                   **CACHE_TOL)


@pytest.mark.parametrize("name", NAMES + ["granite-8b", "qwen2-72b"])
def test_init_cache_matches_reference(name):
    """Shapes and dtypes of the reference's cache, below and above the
    window (the ring's length), in the param dtype and a named one."""
    jm = jax_build_model(jax_get_arch(name).reduced())
    tm = build_model(get_arch(name).reduced(), device="cpu")
    for batch, seq_len in ((2, 40), (1, 100)):
        for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
            want = jm.init_cache(batch, seq_len, jdt)
            got = tm.init_cache(batch, seq_len, tdt)
            assert set(got) == set(want) == {"k", "v"}
            for k in want:
                assert tuple(got[k].shape) == want[k].shape, (k, seq_len)
                assert str(got[k].dtype).split(".")[-1] == \
                    str(want[k].dtype), k
                assert got[k].device.type == "cpu" and \
                    not got[k].any()


@pytest.mark.parametrize("name,t", [("llama3.2-1b", 40), ("llama3.2-1b", 80),
                                    ("qwen2-7b", 40)])
def test_prefill_matches_reference(models, name, t):
    """Last-position logits and the cache; t = 80 passes the window, so
    both ring-pack the cache to 64 entries."""
    want, got = _serve_both(models, name, t, 0, 0)[0]
    _assert_step(want, got)
    w = 64 if name == "llama3.2-1b" and t > 64 else t
    assert got[1]["k"].shape[2] == w


@pytest.mark.parametrize("name,t,grow", [
    ("llama3.2-1b", 40, NEW),    # below the window, grown by the new tokens
    ("llama3.2-1b", 80, 0),      # ring-packed, not grown: the slot wraps
    ("qwen2-7b", 40, NEW),       # no window, grown
])
def test_decode_matches_reference(models, name, t, grow):
    """NEW consecutive decode steps in a correct layout: logits and the
    whole cache after each step."""
    for want, got in _serve_both(models, name, t, grow, NEW)[1:]:
        _assert_step(want, got)


def _roundtrip(models, name, t, grow):
    """The port's prefill(t) + decode at position t against its
    forward(t + 1) at the last position; returns the max abs error."""
    _, _, tm, tp, tokens = models[name]
    full = tm.forward(tp, {"tokens": torch.from_numpy(tokens[:, :t + 1])})
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :t])})
    if grow:
        cache = _grow_port(cache, grow)
    logits, _ = tm.decode(tp, torch.from_numpy(tokens[:, t:t + 1]), cache, t)
    return float((logits[:, 0] - full[:, t]).abs().max())


@pytest.mark.parametrize("name,t,grow", [
    ("llama3.2-1b", 40, 1), ("llama3.2-1b", 80, 0), ("qwen2-7b", 40, 1)])
def test_prefill_decode_matches_forward(models, name, t, grow):
    assert _roundtrip(models, name, t, grow) <= ROUNDTRIP_TOL["atol"]


@pytest.mark.parametrize("t,grow", [
    (80, 4),    # ring-packed to 64 and grown to 68: slots pos % 68
    (19, 0),    # 19 tokens, not grown: the ring wraps at 19, not 64
])
def test_c14_wrong_layouts_match_reference(models, t, grow):
    """ROADMAP C14: the reference's arithmetic gives wrong logits in these
    layouts; the port computes the same wrong logits."""
    want, got = _serve_both(models, "llama3.2-1b", t, grow, 1)[1]
    _assert_step(want, got)
    assert _roundtrip(models, "llama3.2-1b", t, grow) > C14_MISS


def test_c8_decode_past_the_cache_raises(models):
    """Without a window the reference clamps a write at pos >= the cache's
    length onto its last entry (ROADMAP C8); the port raises, for an int
    and a tensor pos, eagerly and through the captured step."""
    _, _, tm, tp, tokens = models["qwen2-7b"]
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :10])})
    tok = torch.from_numpy(tokens[:, 10:11])
    step = CapturedDecode(tm, 2, 10)
    for pos in (10, torch.tensor(12), -1):
        with pytest.raises(ValueError, match="position"):
            tm.decode(tp, tok, cache, pos)
        with pytest.raises(ValueError, match="position"):
            step(tp, tok, cache, pos)
    logits, _ = tm.decode(tp, tok, _grow_port(cache, 1), 10)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name,t,grow", [("llama3.2-1b", 40, NEW),
                                         ("llama3.2-1b", 80, 0),
                                         ("qwen2-7b", 40, NEW)])
def test_make_step_matches_model(models, name, t, grow):
    """make_step's prefill is the model's; its decode step (a
    `CapturedDecode`, eager on the CPU) equals eager decode bitwise over
    NEW greedy tokens with its returned cache fed back in: the cache is
    copied into the step's buffers once, and the same buffers come back
    each call. A 0-d tensor pos gives the same step."""
    _, _, tm, tp, tokens = models[name]
    cfg = tm.cfg
    prompt = {"tokens": torch.from_numpy(tokens[:, :t])}
    prefill = make_step(cfg, ShapeConfig("p", t, 2, "prefill"),
                        device="cpu")
    serve = make_step(cfg, ShapeConfig("d", t + grow, 2, "decode"),
                      device="cpu")
    assert isinstance(serve, CapturedDecode)
    logits, cache = prefill(tp, prompt)
    want_l, want_c = tm.prefill(tp, prompt)
    assert torch.equal(logits, want_l)
    assert all(torch.equal(cache[k], want_c[k]) for k in want_c)
    cache = _grow_port(cache, grow) if grow else cache
    eager_cache = cache
    tok = logits[:, -1].argmax(-1)[:, None]
    for i, pos in enumerate(range(t, t + NEW)):
        want_l, eager_cache = tm.decode(tp, tok, eager_cache, pos)
        arg = torch.tensor(pos) if i == 1 else pos
        logits, cache = serve(tp, tok, cache, arg)
        assert logits is serve.logits and cache is serve.cache
        assert torch.equal(logits, want_l)
        assert all(torch.equal(cache[k], eager_cache[k]) for k in cache)
        tok = logits[:, -1].argmax(-1)[:, None]
    assert serve.cache_loads == 1
    assert serve.captures == serve.replays == 0      # no graph on the CPU


def test_captured_decode_refuses_other_shapes(models):
    _, _, tm, tp, tokens = models["llama3.2-1b"]
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :40])})
    step = CapturedDecode(tm, 2, 43)
    with pytest.raises(ValueError, match="buffer"):
        step(tp, torch.from_numpy(tokens[:, 40:41]), cache, 40)
    with pytest.raises(ValueError, match="token"):
        step(tp, torch.from_numpy(tokens[:1, 40:41]),
             _grow_port(cache, 3), 40)
    ssm = build_model(get_arch("rwkv6-7b").reduced(), device="cpu")
    with pytest.raises(ValueError, match="in-place body"):
        CapturedDecode(ssm, 2, 43)


@pytest.mark.parametrize("window", [0, 5, 16])
def test_decode_attention_matches_reference(window):
    """Ring entries (positions wrapping, −1 for empty slots), GQA 4:2."""
    rng = np.random.default_rng(window)
    b, w, h, kv, hd = 2, 16, 4, 2, 32
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, w, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, w, kv, hd)).astype(np.float32)
    pos = np.array([20, 9], dtype=np.int32)
    idx = np.arange(w)
    cache_pos = np.stack([pos[0] - (pos[0] - idx) % w,
                          np.where(idx <= pos[1], idx, -1)]).astype(np.int32)
    want = np.asarray(JL.decode_attention(
        *map(jnp.asarray, (q, k, v, cache_pos, pos)), window=window))
    got = TL.decode_attention(*map(torch.from_numpy, (q, k, v, cache_pos,
                                                      pos)), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
