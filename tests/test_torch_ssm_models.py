"""Port parity for the SSM families at model level: `build_rwkv` and
`build_hybrid` (`models/transformer.py`), the port's `launch.steps` and
the two configs, against the JAX reference on `rwkv6-7b.reduced()` and
`zamba2-7b.reduced()` with parameters from the reference's init carried
across by `convert.from_jax_params`.

Each model serves as `examples/serve_batched.py` does: a (2, 40) prompt
(40 = one whole chunk of 32 and a ragged one) through prefill, the
hybrid's shared_k/shared_v grown by the new tokens, then greedy decode.

Tolerances (f32, logits and state entries O(1)–O(10)): rtol 1e-5 and
atol 5e-5 for logits, rtol 1e-4 and atol 5e-5 for every cache leaf (two
layers of f32 products and GLA sums in another order); the port's own
prefill(T−1) + decode(1) against its forward(T) at the last position
rtol = atol = 1e-4 (the recurrence against the chunked form)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.configs import INPUT_SHAPES, ArchConfig, ShapeConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.launch import make_step, shape_supported
from repro_torch.models import build_model

torch.set_num_threads(2)

LOGIT_TOL = dict(rtol=1e-5, atol=5e-5)
CACHE_TOL = dict(rtol=1e-4, atol=5e-5)
T, NEW = 40, 3
NAMES = ["rwkv6-7b", "zamba2-7b"]
# the dense configs the port holds (their serving: test_torch_dense_decode)
DENSE_NAMES = ["granite-8b", "llama3.2-1b", "qwen2-7b", "qwen2-72b"]


def _grow_jax(cfg, cache):
    def grow(c, k):
        if cfg.family == "hybrid" and k in ("shared_k", "shared_v"):
            return jnp.pad(c, ((0, 0), (0, 0), (0, NEW), (0, 0), (0, 0)))
        return c
    return {k: grow(v, k) for k, v in cache.items()}


def _grow_port(cfg, cache):
    def grow(c, k):
        if cfg.family == "hybrid" and k in ("shared_k", "shared_v"):
            return torch.nn.functional.pad(c, (0, 0, 0, 0, 0, NEW))
        return c
    return {k: grow(v, k) for k, v in cache.items()}


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def served():
    """Per model: both configs, the reference's params and the port's
    copy, a prompt, and the reference's forward, prefill and NEW greedy
    decode steps (logits and caches)."""
    out = {}
    for name in NAMES:
        jcfg, tcfg = jax_get_arch(name).reduced(), get_arch(name).reduced()
        jm = jax_build_model(jcfg)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = from_jax_params(jax.tree.map(np.asarray, jp), "cpu")
        tokens = np.random.default_rng(1).integers(
            0, jcfg.vocab_size, (2, T)).astype(np.int32)
        forward = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
        logits, cache = jax.jit(jm.prefill)(jp, {"tokens":
                                                 jnp.asarray(tokens)})
        steps = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
        cache = _grow_jax(jcfg, cache)
        decode = jax.jit(jm.decode)
        tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        toks = [np.asarray(tok)]
        for pos in range(T, T + NEW):
            logits, cache = decode(jp, tok, cache, jnp.int32(pos))
            steps.append((np.asarray(logits), jax.tree.map(np.asarray,
                                                           cache)))
            tok = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
            toks.append(np.asarray(tok))
        out[name] = dict(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, tokens=tokens,
                         forward=forward, steps=steps, toks=toks)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_forward_and_loss_match_reference(name, served):
    s = served[name]
    tm = build_model(s["tcfg"], device="cpu")
    got = tm.forward(s["tp"], {"tokens": torch.from_numpy(s["tokens"])})
    assert got.dtype == torch.float32 and got.shape == s["forward"].shape
    np.testing.assert_allclose(got.numpy(), s["forward"], **LOGIT_TOL)
    labels = np.roll(s["tokens"], -1, axis=1)
    batch = {"tokens": s["tokens"], "labels": labels}
    jloss = float(jax_build_model(s["jcfg"]).loss_fn(
        s["jp"], jax.tree.map(jnp.asarray, batch)))
    tloss = float(tm.loss_fn(s["tp"], {k: torch.from_numpy(v)
                                       for k, v in batch.items()}))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_grow_and_decode_match_reference(name, served):
    """Prefill logits and every cache leaf, then NEW greedy decode steps
    after the grow (fed the reference's tokens), logits and every cache
    leaf of each step."""
    s = served[name]
    tm = build_model(s["tcfg"], device="cpu")
    logits, cache = tm.prefill(s["tp"], {"tokens":
                                         torch.from_numpy(s["tokens"])})
    want_logits, want_cache = s["steps"][0]
    np.testing.assert_allclose(_np(logits), want_logits, **LOGIT_TOL)
    assert sorted(cache) == sorted(want_cache)
    for k, v in want_cache.items():
        assert cache[k].shape == v.shape, k
        np.testing.assert_allclose(_np(cache[k]), v, err_msg=k, **CACHE_TOL)
    cache = _grow_port(s["tcfg"], cache)
    for i, pos in enumerate(range(T, T + NEW)):
        tok = torch.tensor(s["toks"][i])
        logits, cache = tm.decode(s["tp"], tok, cache, pos)
        want_logits, want_cache = s["steps"][i + 1]
        np.testing.assert_allclose(_np(logits), want_logits,
                                   err_msg=f"step {i}", **LOGIT_TOL)
        for k, v in want_cache.items():
            np.testing.assert_allclose(_np(cache[k]), v,
                                       err_msg=f"step {i} {k}", **CACHE_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_make_step_matches_reference(name, served):
    """The port's `launch.steps.make_step` prefill and decode kinds
    against the reference's `make_step`: a prefill, the grow, one decode
    step."""
    s = served[name]
    pre_shape = ShapeConfig("prefill_40", T, 2, "prefill")
    dec_shape = ShapeConfig("decode_43", T + NEW, 2, "decode")
    jl, jc = jax_steps.make_step(s["jcfg"], pre_shape)(
        s["jp"], {"tokens": jnp.asarray(s["tokens"])})
    tok = jnp.asarray(s["toks"][0])
    jl2, _ = jax_steps.make_step(s["jcfg"], dec_shape)(
        s["jp"], tok, _grow_jax(s["jcfg"], jc), jnp.int32(T))
    prefill = make_step(s["tcfg"], pre_shape, device="cpu")
    serve = make_step(s["tcfg"], dec_shape, device="cpu")
    logits, cache = prefill(s["tp"], {"tokens":
                                      torch.from_numpy(s["tokens"])})
    np.testing.assert_allclose(_np(logits), np.asarray(jl), **LOGIT_TOL)
    logits, _ = serve(s["tp"], torch.tensor(s["toks"][0]),
                      _grow_port(s["tcfg"], cache), T)
    np.testing.assert_allclose(_np(logits), np.asarray(jl2), **LOGIT_TOL)
    # the train kind is ported: a step function (held against the
    # reference in test_torch_train_step.py)
    assert callable(make_step(s["tcfg"], INPUT_SHAPES["train_4k"],
                              device="cpu"))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_then_decode_matches_forward(name, served):
    """prefill(T−1) + decode(1) equals forward(T) at the last position
    (the reference's test_arch_smoke round trip, on the port alone)."""
    s = served[name]
    tm = build_model(s["tcfg"], device="cpu")
    tokens = torch.from_numpy(s["tokens"])
    logits, cache = tm.prefill(s["tp"], {"tokens": tokens[:, :T - 1]})
    np.testing.assert_allclose(_np(logits[:, 0]), s["forward"][:, T - 2],
                               rtol=1e-4, atol=1e-4)
    cache = _grow_port(s["tcfg"], cache)
    logits, _ = tm.decode(s["tp"], tokens[:, T - 1:], cache, T - 1)
    np.testing.assert_allclose(_np(logits[:, 0]), s["forward"][:, T - 1],
                               rtol=1e-4, atol=1e-4)


def test_hybrid_decode_raises_past_the_cache():
    """The reference clamps a write past the shared caches' end
    (dynamic_update_slice) and overwrites the last prompt key; the port
    refuses it."""
    cfg = get_arch("zamba2-7b").reduced()
    tm = build_model(cfg, device="cpu")
    params = tm.init(0)
    tokens = torch.zeros((1, 5), dtype=torch.int64)
    _, cache = tm.prefill(params, {"tokens": tokens})
    assert cache["shared_k"].shape[2] == 5
    with pytest.raises(ValueError, match="grow shared_k/shared_v"):
        tm.decode(params, tokens[:, :1], cache, 5)
    logits, _ = tm.decode(params, tokens[:, :1], _grow_port(cfg, cache), 5)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("name", NAMES + DENSE_NAMES)
def test_configs_match_reference(name):
    """The full configs and their reduced() variants equal the
    reference's field by field (the port keeps the fields it runs)."""
    for jc, tc in ((jax_get_arch(name), get_arch(name)),
                   (jax_get_arch(name).reduced(), get_arch(name).reduced())):
        for f in dataclasses.fields(tc):
            want, got = getattr(jc, f.name), getattr(tc, f.name)
            if f.name == "ssm" and want is not None:
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
            else:
                assert got == want, f.name
        assert tc.is_attention_free == jc.is_attention_free
        assert tc.supports_long_decode == jc.supports_long_decode
        for shape in INPUT_SHAPES:
            assert shape_supported(tc, INPUT_SHAPES[shape]) == \
                jax_steps.shape_supported(jc, JAX_SHAPES[shape])
    assert {k: dataclasses.asdict(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}


@pytest.mark.parametrize("name", NAMES)
def test_init_matches_reference_in_structure_and_distribution(name):
    """The port's init (drawn on the model's device) has the reference's
    leaves, shapes, dtypes (f32 scalars in a bf16 model) and leaf order,
    and matches it in distribution."""
    cfg = dataclasses.replace(get_arch(name).reduced(),
                              param_dtype="bfloat16", n_layers=4)
    jcfg = dataclasses.replace(jax_get_arch(name).reduced(),
                               param_dtype="bfloat16", n_layers=4)
    want = from_jax_params(jax.tree.map(np.asarray, jax_build_model(
        jcfg).init(jax.random.PRNGKey(0))), "cpu")
    got = build_model(cfg, device="cpu").init(0)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(float(got[k].float().std()),
                                   float(want[k].float().std()), rtol=0.1,
                                   atol=1e-6, err_msg=k)


def test_build_model_builds_the_ssm_families():
    base = dict(name="x", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                d_ff=128, vocab_size=100)
    for name in NAMES:
        cfg = get_arch(name).reduced()
        model = build_model(cfg, device="cpu")
        assert model.device == torch.device("cpu")
        assert model.init_cache(2, 8)          # a cache of the family
    # family "ssm" with a Mamba2 mixer: build_hybrid, no shared block
    mamba = dataclasses.replace(get_arch("zamba2-7b").reduced(),
                                family="ssm", shared_attn_every=0)
    model = build_model(mamba, device="cpu")
    assert sorted(model.init_cache(1, 4)) == ["conv", "ssm"]
    logits = model.forward(model.init(0),
                           {"tokens": torch.zeros((1, 4), dtype=torch.int64)})
    assert logits.shape == (1, 4, mamba.vocab_size)
    assert build_model(ArchConfig(family="dense", **base), device="cpu")
    if not torch.cuda.is_available():      # entry points default to CUDA
        for name in NAMES:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_model(get_arch(name))
