"""The encoder-decoder's FedELMY train step (`launch.steps.make_step(cfg,
train shape)` on seamless-m4t-medium) against the reference's
`repro.launch.steps.make_step`, and the attention backward's plain
version at non-causal attention with Tq ≠ Tk, which the encoder's
self-attention and every cross-attention take under grad.

The model is seamless-m4t-medium `reduced()` (2 encoder + 2 decoder
layers, d 256, 4/4 heads at head dim 64, vocab 1,024) with the
reference's init carried across, 32 target tokens a row, batch 4, the
source frames `src_embeds` as long as the target (T_src = T = 32, the
train shape's own layout), longer (45) and shorter (19). Tokens, labels
and frames are numpy-seeded. The pools are built as in
`test_torch_train_step.py`: m0 the init, m1 and m2 m0 plus numpy noise at
NOISE of each leaf's RMS; the moment pool m0, m1, m2; the exact pool
`ModelPool.create(m0, pool_size + 1)` with m1 and m2 appended. The model
in training starts away from the anchor (m3, a third such draw) or at it
(m0). FedConfig at its defaults.

Tolerances, those `test_torch_train_step.py`'s `_hold_f32` applies to
llama, set before the first run:
- f32: task within 1e-5 relative; the params and Adam's m and v within
  1e-5 normwise per leaf, over two chained steps from m3 and over the
  first step from m0 (f32 products, softmaxes and sums in another order).
- bf16: the port's and the reference's gradients (Adam's m over 1 − b1)
  each against the reference's f32 step on the same values widened, per
  leaf normwise: the port's error at most twice the reference's + 1e-3;
  task within 5e-3 relative. Also at seamless's full depth (12 + 12
  layers at `reduced()`'s width), where the reference's own bf16 step
  lies ~8% from its f32 twin (~2% at 2 + 2 layers).
- `ref.attention_bwd_ref` against `jax.vjp` of the reference's chunked
  attention: rtol 1e-5 and atol 1e-6 times the gradient's largest
  magnitude, as `test_torch_attention_bwd.py` holds it at causal Tq = Tk.

The reference runs this family's layers under remat (`cfg.remat`), which
changes no value; the port has none (ROADMAP 7d)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FedConfig as JaxFedConfig
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.pool import MomentPool as JaxMomentPool
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro.models import layers as JL
from repro_torch.configs import FedConfig, ShapeConfig, get_arch
from repro_torch.convert import from_jax_params, from_jax_pool
from repro_torch.kernels.ref import (attention_bwd_ref, attention_lse_ref,
                                     attention_ref)
from repro_torch.launch import make_step
from repro_torch.launch.steps import _row_blocks

torch.set_num_threads(2)

NAME = "seamless-m4t-medium"
T, BATCH, NOISE = 32, 4, 0.1
TRAIN = ("train_32", T, BATCH, "train")
F32_TOL = 1e-5
BF16_TASK_TOL = 5e-3
RTOL, ATOL = 1e-5, 1e-6
JIT_OPTIONS = {"xla_backend_optimization_level": 0}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    """A jax or torch array as f64 numpy (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _jax_cfg(dtype, depth=None):
    """`reduced()` in `dtype`; `depth` encoder and decoder layers each,
    or reduced()'s 2."""
    cfg = jax_get_arch(NAME).reduced()
    depth = depth or cfg.n_layers
    return dataclasses.replace(cfg, param_dtype=dtype, n_layers=depth,
                               n_encoder_layers=depth)


def _cfg(dtype, depth=None):
    cfg = get_arch(NAME).reduced()
    depth = depth or cfg.n_layers
    return dataclasses.replace(cfg, param_dtype=dtype, n_layers=depth,
                               n_encoder_layers=depth)


def _noisy(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(p):
        x = np.asarray(jnp.asarray(p, jnp.float32))
        rms = float(np.sqrt(np.mean(x * x))) or 1.0
        noise = rng.standard_normal(x.shape).astype(np.float32)
        return jnp.asarray(x + NOISE * rms * noise).astype(p.dtype)
    return jax.tree.map(leaf, params)


_SETUPS = {}


def _setup(dtype, t_src, depth=None):
    """The reference's init m0, the start m3, both pool forms and a batch
    over a source of t_src frames, with their port copies (cached)."""
    if (dtype, t_src, depth) in _SETUPS:
        return _SETUPS[dtype, t_src, depth]
    jm = jax_build_model(_jax_cfg(dtype, depth))
    m0 = jax.jit(jm.init, compiler_options=JIT_OPTIONS)(
        jax.random.PRNGKey(0))
    m1, m2 = _noisy(m0, 1), _noisy(m0, 2)
    fed = JaxFedConfig()
    jpools = {"moment": JaxMomentPool.create(m0).append(m1).append(m2),
              "exact": JaxModelPool.create(m0, fed.pool_size + 1)
              .append(m1).append(m2)}
    rng = np.random.default_rng(t_src)
    vocab, d = _cfg(dtype).vocab_size, _cfg(dtype).d_model
    tokens = rng.integers(0, vocab, (BATCH, T)).astype(np.int32)
    labels = rng.integers(0, vocab, (BATCH, T)).astype(np.int32)
    src = rng.normal(size=(BATCH, t_src, d)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
              "src_embeds": jnp.asarray(src).astype(dtype)}
    tbatch = {"tokens": torch.from_numpy(tokens),
              "labels": torch.from_numpy(labels),
              "src_embeds": torch.from_numpy(src).to(
                  getattr(torch, dtype))}
    out = {}
    for start, jp in (("anchor", m0), ("away", _noisy(m0, 3))):
        out[start] = dict(jp=jp, jpools=jpools, jbatch=jbatch,
                          tp=from_jax_params(jp, "cpu"),
                          tpools={k: from_jax_pool(v, "cpu")
                                  for k, v in jpools.items()},
                          tbatch=tbatch)
    _SETUPS[dtype, t_src, depth] = out
    return out


_JAX_STEPS = {}


def _jax_step(monkeypatch, dtype, micro, depth=None):
    """The reference's jitted train step (its jit specialises on the
    batch's shapes and the pool's form at the first call)."""
    if (dtype, micro, depth) not in _JAX_STEPS:
        monkeypatch.setenv("REPRO_MICROBATCH", str(micro))
        _JAX_STEPS[dtype, micro, depth] = jax.jit(jax_steps.make_step(
            _jax_cfg(dtype, depth), JaxShapeConfig(*TRAIN),
            JaxFedConfig()), compiler_options=JIT_OPTIONS)
    return _JAX_STEPS[dtype, micro, depth]


def _port_step(monkeypatch, dtype, micro, depth=None):
    monkeypatch.setenv("REPRO_MICROBATCH", str(micro))
    return make_step(_cfg(dtype, depth), ShapeConfig(*TRAIN), FedConfig(),
                     device="cpu")


def _run_jax(step, s, form, n_steps):
    p = s["jp"]
    opt = {"m": jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p),
           "v": jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), p)}
    out = []
    for i in range(n_steps):
        p, opt, task = step(p, opt, s["jbatch"], s["jpools"][form],
                            jnp.int32(i))
        out.append((from_jax_params(p, "cpu"),
                    {k: from_jax_params(v, "cpu") for k, v in opt.items()},
                    float(task)))
    return out


def _run_port(step, s, form, n_steps):
    p = s["tp"]
    opt = {k: {n: torch.zeros(v.shape) for n, v in p.items()}
           for k in ("m", "v")}
    out = []
    for i in range(n_steps):
        p, opt, task = step(p, opt, s["tbatch"], s["tpools"][form],
                            torch.tensor(i, dtype=torch.int32))
        out.append((p, opt, float(task)))
    return out


def _hold_f32(got, want):
    for i, ((gp, go, gt), (wp, wo, wt)) in enumerate(zip(got, want)):
        assert abs(gt - wt) <= F32_TOL * abs(wt), (i, gt, wt)
        for what, g, w in (("params", gp, wp), ("m", go["m"], wo["m"]),
                           ("v", go["v"], wo["v"])):
            for k in w:
                err = _rel(_np(g[k]), _np(w[k]))
                assert err <= F32_TOL, (i, what, k, err)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

# (T_src, pool form, REPRO_MICROBATCH, start, chained steps): T_src = T and
# T_src ≠ T both ways, each pool form and microbatch count with each
@pytest.mark.parametrize("t_src,form,micro,start,n_steps", [
    (T, "moment", 1, "away", 2),
    (T, "exact", 2, "away", 2),
    (45, "moment", 2, "away", 2),
    (45, "exact", 1, "away", 2),
    (19, "moment", 1, "anchor", 1)])
def test_train_step_f32_matches_reference(monkeypatch, t_src, form, micro,
                                          start, n_steps):
    s = _setup("float32", t_src)[start]
    want = _run_jax(_jax_step(monkeypatch, "float32", micro), s, form,
                    n_steps)
    got = _run_port(_port_step(monkeypatch, "float32", micro), s, form,
                    n_steps)
    _hold_f32(got, want)
    # the source reaches every encoder leaf and the cross-attention's k, v
    m = got[0][1]["m"]
    for k in ("encoder.attn.wq", "encoder.ffn.w_up",
              "decoder.cross_attn.wk", "decoder.cross_attn.wv"):
        assert float(m[k].abs().max()) > 0, k


def _bf16_errs(monkeypatch, t_src, form, micro, depth=None):
    """The port's and the reference's bf16 first steps against the
    reference's f32 step on the same values widened: Adam's m per leaf
    (the port's error, the reference's), both tasks and the f32 task."""
    s16 = _setup("bfloat16", t_src, depth)["away"]
    s32 = _setup("float32", t_src, depth)["away"]
    wide = dict(s32, jp=jax.tree.map(lambda x: x.astype(jnp.float32),
                                     s16["jp"]),
                jbatch=dict(s16["jbatch"], src_embeds=s16["jbatch"][
                    "src_embeds"].astype(jnp.float32)),
                jpools={form: jax.tree.map(
                    lambda x: x.astype(jnp.float32)
                    if x.dtype == jnp.bfloat16 else x, s16["jpools"][form])})
    oracle = _run_jax(_jax_step(monkeypatch, "float32", micro, depth), wide,
                      form, 1)[0]
    ref = _run_jax(_jax_step(monkeypatch, "bfloat16", micro, depth), s16,
                   form, 1)[0]
    got = _run_port(_port_step(monkeypatch, "bfloat16", micro, depth), s16,
                    form, 1)[0]
    errs = {k: (_rel(_np(got[1]["m"][k]), _np(want)),
                _rel(_np(ref[1]["m"][k]), _np(want)))
            for k, want in oracle[1]["m"].items()}
    assert all(v.dtype == torch.bfloat16 for v in got[0].values())
    return errs, (got[2], ref[2], oracle[2])


def _hold_bf16(errs, tasks):
    got, ref, oracle = tasks
    assert abs(got - oracle) <= BF16_TASK_TOL * abs(oracle)
    assert abs(ref - oracle) <= BF16_TASK_TOL * abs(oracle)
    for k, (port_err, ref_err) in errs.items():
        assert port_err <= 2 * ref_err + 1e-3, (k, port_err, ref_err)


@pytest.mark.parametrize("t_src,form,micro", [(45, "moment", 2),
                                              (T, "exact", 2)])
def test_train_step_bf16_against_f32_oracle(monkeypatch, t_src, form,
                                            micro):
    _hold_bf16(*_bf16_errs(monkeypatch, t_src, form, micro))


def test_train_step_bf16_at_full_depth_within_the_references_error(
        monkeypatch):
    """At seamless-m4t-medium's 12 + 12 layers (`reduced()`'s width) the
    bf16 step lies far further from its f32 twin than at 2 + 2 layers,
    and so does the reference's own: both read ~8–9% normwise over all
    leaves here, ~2% at 2 + 2 (the depth, not the port: chip_smoke.py
    phase 30 (c) holds the full-width model's bf16 step to 5e-2 of its
    twin at 2 + 2 layers for that reason and only prints the full-depth
    reading). Held as the 2 + 2 case is: per leaf, the port's error at
    most twice the reference's + 1e-3."""
    errs, tasks = _bf16_errs(monkeypatch, T, "moment", 2, depth=12)
    _hold_bf16(errs, tasks)
    ref_total = np.sqrt(sum(r * r for _, r in errs.values()) / len(errs))
    assert ref_total > 2e-2, ref_total


def test_row_blocks_slice_the_source_with_the_tokens():
    """`REPRO_MICROBATCH`'s row blocks cut `src_embeds` at the same rows
    as the tokens and labels, as views."""
    batch = {"tokens": torch.arange(4 * 3).reshape(4, 3),
             "labels": torch.arange(4 * 3).reshape(4, 3) + 100,
             "src_embeds": torch.arange(4 * 5 * 2.).reshape(4, 5, 2)}
    blocks = _row_blocks(batch, 2)
    for i, block in enumerate(blocks):
        for k, v in batch.items():
            assert torch.equal(block[k], v[2 * i:2 * i + 2]), (i, k)
            assert block[k].data_ptr() == v[2 * i].data_ptr(), (i, k)


# ---------------------------------------------------------------------------
# the attention backward's plain version at non-causal, Tq ≠ Tk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,tq,tk,h,kv,hd,kv_block", [
    (2, 16, 100, 4, 4, 64, 32),     # cross-attention: few queries, long
    (2, 100, 30, 4, 4, 64, 16),     # Tq > Tk
    (1, 77, 133, 8, 2, 32, 64),     # a group of 4, ragged against tiles
    (2, 45, 45, 4, 4, 64, 16)])     # the encoder's self-attention
def test_plain_backward_noncausal_matches_jax_vjp(b, tq, tk, h, kv, hd,
                                                  kv_block):
    """`ref.attention_bwd_ref` (the backward kernel's plain version) from
    `attention_ref`'s out and `attention_lse_ref` at causal=False against
    `jax.vjp` of the reference's chunked `flash_attention(causal=False)`,
    whose gradient the reference's encoder-decoder training takes."""
    rng = np.random.default_rng(tq * tk + h)
    q, do = (rng.normal(size=(b, tq, h, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(b, tk, kv, hd)).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(lambda q, k, v: JL.flash_attention(
        q, k, v, causal=False, kv_block=kv_block),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    t_out = attention_ref(tq_, tk_, tv_, causal=False)
    lse = attention_lse_ref(tq_, tk_, causal=False)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=RTOL,
                               atol=ATOL * float(np.abs(out).max()))
    got = attention_bwd_ref(tq_, tk_, tv_, t_out, lse, tdo, causal=False)
    for g, w, x in zip(got, want, (q, k, v)):
        w = np.asarray(w)
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * float(np.abs(w).max()))
