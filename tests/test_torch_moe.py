"""Port parity for the Mixture-of-Experts decoder: `models/moe.py`
(`moe_init`, `_capacity`, `moe_ffn`) and the MoE family of
`build_decoder_only` (`models/transformer.py`), `launch.steps.make_step`
and `input_specs` for it, against the JAX reference on the CPU, with the
reference's init carried across by `convert.from_jax_params`. Also the
attention at a group of 16 query heads a KV head (qwen3-moe-235b-a22b's
64 over 4), which no dense config reaches.

The config is qwen3-moe-235b-a22b `reduced()`: 2 layers, d 256, 4/4
heads, 4 experts top-2, d_ff_expert 128, f32; a variant adds one shared
expert. Inputs are numpy-seeded.

The routing is compared first: the top-k experts, their gates and the
kept mask. A token whose k-th and (k+1)-th router probabilities lie
closer than ROUTE_TIE of the k-th could pick other experts on the two
packages (their softmaxes differ in the last ulps, ~1e-7 of a value);
such a token would be compared on its gates only, with the count printed
(the fixtures have none: their smallest margins are printed too).

Tolerances (f32), each relative normwise unless said: the layer's y and
the decoder's logits 1e-5 (a few f32 products in another order: they
read ≤ 1.6e-6; the overflow case's rows ≤ 5.8e-6, since a row that
dropped its first expert keeps only the second, whose gate is ~e⁻¹⁰ of
the first and carries the logits' absolute error as a relative one);
gates 1e-6 (one softmax and a division); aux and the loss
rtol 1e-5; the cache atol 5e-5 as `test_torch_dense_decode.py`'s (rope's
angles); the round trip prefill(T−1) + decode(1) against forward(T) 1e-5
at capacity_factor 8.0, where nothing drops (the reference's own test
widens the capacity the same way: a token's drop depends on the routed
token count); the init's stds within 10% of the reference's and of
their fan-in's 1/√fan_in; the chunked attention atol 2e-6 as
`test_torch_transformer.py`'s. `decode_into`, `make_step`'s steps and
`CapturedDecode` on the CPU run the model's own functions: bitwise."""
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
from repro.models import moe as JM
from repro_torch.configs import INPUT_SHAPES, ShapeConfig, get_arch
from repro_torch.convert import from_jax_params
from repro_torch.kernels.ref import attention_ref
from repro_torch.launch import (CapturedDecode, input_specs, make_step,
                                param_specs_for)
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

torch.set_num_threads(2)

NAME = "qwen3-moe-235b-a22b"
REL = 1e-5
GATE_REL = 1e-6
CACHE_TOL = dict(rtol=0, atol=5e-5)
ROUTE_TIE = 1e-5
STD_RTOL = 0.1
NEW = 4
# qwen3-moe-235b-a22b's parameters (jax.eval_shape of the reference's
# init): all 94 layers, and the 8 the card runs
FULL_PARAMS = 235_093_610_496
CUT_PARAMS = 21_146_701_824


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, dtype=np.float32)


def _cfgs(shared=0, cf=None):
    """The reduced config on both packages, with `shared` shared experts
    and, when given, another capacity factor."""
    out = []
    for c in (jax_get_arch(NAME).reduced(), get_arch(NAME).reduced()):
        moe = dataclasses.replace(c.moe, n_shared_experts=shared)
        if cf is not None:
            moe = dataclasses.replace(moe, capacity_factor=cf)
        out.append(dataclasses.replace(c, moe=moe))
    return out


def _layer(shared, seed=0):
    """The reference's `moe_init` for one layer: its numpy leaves and the
    port's copy."""
    jcfg, tcfg = _cfgs(shared)
    jp = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(seed),
                                              jcfg, jnp.float32))
    return jcfg, tcfg, jp, from_jax_params(jp, "cpu")


def _x(n_tok, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, n_tok // 2, d)).astype(np.float32)


def _jax_routing(jp, jcfg, x):
    """The reference's routing, its lines spelled out (`moe_ffn` keeps them
    inside): probs, the top-k experts and gates, and the kept mask in
    (token, j) order."""
    m = jcfg.moe
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    logits = jnp.einsum("nd,de->ne", xf.astype(jnp.float32),
                        jnp.asarray(jp["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, m.top_k)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    flat = idx.reshape(-1)
    order = jnp.argsort(flat)
    se = flat[order]
    rank = jnp.arange(se.shape[0]) - jnp.searchsorted(
        se, jnp.arange(m.n_experts))[se]
    keep = np.empty(se.shape[0], bool)
    keep[np.asarray(order)] = np.asarray(rank < JM._capacity(xf.shape[0],
                                                             jcfg))
    return (np.asarray(probs), np.asarray(idx), np.asarray(gates),
            keep.reshape(idx.shape))


def _port_routing(tp, tcfg, x):
    xf = torch.from_numpy(x).reshape(-1, x.shape[-1])
    experts, gates, _ = TM.route(tp, tcfg, xf)
    order, keep, _ = TM.dispatch(experts, TM._capacity(xf.shape[0], tcfg),
                                    tcfg.moe.n_experts)
    kept = torch.empty_like(keep)
    kept[order] = keep
    return experts.numpy(), gates.numpy(), kept.reshape(experts.shape).numpy()


def _hold_routing(jp, tp, jcfg, tcfg, x):
    """Experts, gates and kept mask identical (gates within GATE_REL)
    except at near-ties; returns the number of drops."""
    probs, jidx, jgates, jkeep = _jax_routing(jp, jcfg, x)
    tidx, tgates, tkeep = _port_routing(tp, tcfg, x)
    k = tcfg.moe.top_k
    top = -np.sort(-probs, axis=-1)
    margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
    tie = margin < ROUTE_TIE
    print(f"smallest top-{k} margin {margin.min():.3e} of the k-th "
          f"probability; near-ties {int(tie.sum())} of {len(tie)}")
    # a near-tie may pick other experts: those tokens keep only the gates
    # check, whose sorted values do not depend on which expert won
    np.testing.assert_array_equal(tidx[~tie], jidx[~tie])
    np.testing.assert_array_equal(tkeep[~tie], jkeep[~tie])
    assert _rel(tgates, jgates) <= GATE_REL
    return int((~tkeep).sum())


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("n_tok", [2, 80])
def test_moe_ffn_matches_reference(shared, n_tok):
    """y and aux at the decode size (2 tokens, capacity 8) and a prefill
    size (80 tokens, capacity 56), with and without a shared expert."""
    jcfg, tcfg, jp, tp = _layer(shared)
    x = _x(n_tok, tcfg.d_model, 3 + n_tok)
    _hold_routing(jp, tp, jcfg, tcfg, x)
    jy, jaux = JM.moe_ffn(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    ty, taux = TM.moe_ffn(tp, tcfg, torch.from_numpy(x))
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    assert taux.shape == () and taux.dtype == torch.float32
    assert _rel(_np(ty), jy) <= REL
    np.testing.assert_allclose(float(taux), float(jaux), rtol=REL)
    assert float(taux) > 0


def test_moe_ffn_overflow_drops_match_reference():
    """A router whose column 0 dominates sends every token's top-1 to
    expert 0: of 80 tokens (capacity 56) the last 24 drop it, in token
    order, on both packages; y matches row for row."""
    jcfg, tcfg, jp, tp = _layer(0)
    jp["router"] = jp["router"].copy()
    jp["router"][:, 0] += 0.08      # + ~10 to column 0's logit for these x
    tp = from_jax_params(jp, "cpu")
    x = _x(80, tcfg.d_model, 5) + np.float32(0.5)
    n_drop = _hold_routing(jp, tp, jcfg, tcfg, x)
    tidx, _, tkeep = _port_routing(tp, tcfg, x)
    cap = TM._capacity(80, tcfg)
    assert cap == 56 and (tidx[:, 0] == 0).all()
    np.testing.assert_array_equal(tkeep[:, 0], np.arange(80) < cap)
    assert n_drop >= 80 - cap
    assert int(TM.drops(tp, tcfg, torch.from_numpy(x))) == n_drop
    jy, _ = JM.moe_ffn(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    ty, _ = TM.moe_ffn(tp, tcfg, torch.from_numpy(x))
    jy, ty = np.asarray(jy).reshape(80, -1), _np(ty).reshape(80, -1)
    for i in range(80):
        assert _rel(ty[i], jy[i]) <= REL, i


@pytest.mark.parametrize("n_experts,top_k,cf", [(4, 2, 1.25), (128, 8, 1.25),
                                                (128, 8, 8.0), (64, 6, 1.0),
                                                (8, 2, 0.5)])
def test_capacity_matches_reference(n_experts, top_k, cf):
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, n_experts=n_experts, top_k=top_k, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, n_experts=n_experts, top_k=top_k, capacity_factor=cf))
    for n in list(range(1, 300)) + [1024, 4095, 4096, 65536, 131072]:
        assert TM._capacity(n, tcfg) == JM._capacity(n, jcfg), n
    # phase 27's two shapes: prefill 2 x 512 and a decode step of batch 2
    if (n_experts, top_k, cf) == (128, 8, 1.25):
        assert TM._capacity(1024, tcfg) == 80
        assert TM._capacity(2, tcfg) == 8


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
        jcfg, tcfg = _cfgs(cf=cf)
        jm = jax_build_model(jcfg)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(11)
        tokens = rng.integers(0, tcfg.vocab_size, (2, 64)).astype(np.int32)
        labels = rng.integers(0, tcfg.vocab_size, (2, 64)).astype(np.int32)
        out[cf] = (jm, jax.tree.map(jnp.asarray, jp),
                   build_model(tcfg, device="cpu"), from_jax_params(jp, "cpu"),
                   tokens, labels)
    return out


def test_forward_and_loss_match_reference(models):
    """forward's logits; loss_fn with the layers' aux loss, which a loss
    without it would miss by far more than the tolerance."""
    jm, jp, tm, tp, tokens, labels = models[None]
    want = np.asarray(jm.forward(jp, {"tokens": jnp.asarray(tokens)}))
    got = tm.forward(tp, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == want.shape == (2, 64, tm.cfg.vocab_size)
    assert _rel(_np(got), want) <= REL
    batch = {"tokens": tokens, "labels": labels}
    jloss = float(jm.loss_fn(jp, jax.tree.map(jnp.asarray, batch)))
    tloss = float(tm.loss_fn(tp, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}))
    np.testing.assert_allclose(tloss, jloss, rtol=REL)
    tcfg = tm.cfg
    no_aux = build_model(dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, router_aux_weight=0.0)), device="cpu")
    xent = float(no_aux.loss_fn(tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}))
    assert tloss - xent > 10 * REL * abs(jloss)


def _grow_jax(cache, n):
    return {k: jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0)))
            for k, c in cache.items()}


def _grow_port(cache, n):
    return {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n))
            for k, c in cache.items()}


def _assert_step(want, got):
    (jl, jc), (tl, tc) = want, got
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    assert _rel(_np(tl), jl) <= REL
    assert set(tc) == set(jc) == {"k", "v"}
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), err_msg=k,
                                   **CACHE_TOL)


def test_prefill_and_decode_match_reference(models):
    """prefill of 56 tokens (capacity 56 for 112 routed tokens), the cache
    grown by NEW, and NEW decode steps of the given tokens (capacity 8):
    logits and the whole cache after each; `decode_into` on a copy of the
    cache with a 0-d pos gives decode's logits and cache bitwise."""
    jm, jp, tm, tp, tokens, _ = models[None]
    t = 56
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(tokens[:, :t])})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :t])})
    _assert_step((jl, jc), (tl, tc))
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


@pytest.mark.parametrize("t", [33, 63])
def test_roundtrip_at_wide_capacity(models, t):
    """The reference's round trip (tests/test_arch_smoke.py) at
    capacity_factor 8.0, where no token drops: the port's prefill(t) +
    decode at position t against its forward(t + 1) at the last position,
    and the reference's decode logits there."""
    jm, jp, tm, tp, tokens, _ = models[8.0]
    full = tm.forward(tp, {"tokens": torch.from_numpy(tokens[:, :t + 1])})
    _, cache = tm.prefill(tp, {"tokens": torch.from_numpy(tokens[:, :t])})
    tok = tokens[:, t:t + 1]
    logits, _ = tm.decode(tp, torch.from_numpy(tok), _grow_port(cache, 1), t)
    assert _rel(_np(logits[:, 0]), _np(full[:, t])) <= REL
    _, jc = jm.prefill(jp, {"tokens": jnp.asarray(tokens[:, :t])})
    jl, _ = jm.decode(jp, jnp.asarray(tok), _grow_jax(jc, 1), jnp.int32(t))
    assert _rel(_np(logits), jl) <= REL


def test_make_step_serves_the_moe_family(models):
    """make_step's prefill is the model's; its decode step is a
    `CapturedDecode` (eager on the CPU), bitwise the eager decode over NEW
    greedy tokens."""
    _, _, tm, tp, tokens, _ = models[None]
    t = 40
    prompt = {"tokens": torch.from_numpy(tokens[:, :t])}
    prefill = make_step(tm.cfg, ShapeConfig("p", t, 2, "prefill"),
                        device="cpu")
    serve = make_step(tm.cfg, ShapeConfig("d", t + NEW, 2, "decode"),
                      device="cpu")
    assert isinstance(serve, CapturedDecode)
    logits, cache = prefill(tp, prompt)
    want_l, want_c = tm.prefill(tp, prompt)
    assert torch.equal(logits, want_l)
    assert all(torch.equal(cache[k], want_c[k]) for k in want_c)
    cache = eager = _grow_port(cache, NEW)
    tok = logits[:, -1].argmax(-1)[:, None]
    for pos in range(t, t + NEW):
        want_l, eager = tm.decode(tp, tok, eager, pos)
        logits, cache = serve(tp, tok, cache, pos)
        assert torch.equal(logits, want_l)
        assert all(torch.equal(cache[k], eager[k]) for k in cache)
        tok = logits[:, -1].argmax(-1)[:, None]
    assert serve.cache_loads == 1


# ---------------------------------------------------------------------------
# init and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shared", [0, 1])
def test_init_matches_reference_in_structure_and_distribution(dtype, shared):
    """Names in the reference's order, shapes, dtypes (the router f32 on
    every dtype) and stds; w_gate and w_up at the reference's fan-in of
    n_experts (ROADMAP C20), w_down at d_ff_expert's, the router at
    d_model's. Four layers, so each expert stack holds 4·E draws."""
    jcfg, tcfg = _cfgs(shared)
    jcfg = dataclasses.replace(jcfg, n_layers=4, param_dtype=dtype)
    tcfg = dataclasses.replace(tcfg, n_layers=4, param_dtype=dtype)
    want = from_jax_params(jax.tree.map(np.asarray, jax_build_model(
        jcfg).init(jax.random.PRNGKey(0))), "cpu")
    got = build_model(tcfg, device="cpu").init(0)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and \
            got[k].dtype == want[k].dtype, k
        np.testing.assert_allclose(float(got[k].float().std()),
                                   float(want[k].float().std()),
                                   rtol=STD_RTOL, err_msg=k)
    assert got["layers.ffn.router"].dtype == torch.float32
    m, d = tcfg.moe, tcfg.d_model
    for name, fan_in in (("w_gate", m.n_experts), ("w_up", m.n_experts),
                         ("w_down", m.d_ff_expert), ("router", d)):
        std = float(got[f"layers.ffn.{name}"].float().std())
        np.testing.assert_allclose(std, fan_in ** -0.5, rtol=STD_RTOL,
                                   err_msg=name)
    assert ("layers.ffn.shared.w_gate" in got) == bool(shared)
    assert not any(torch.equal(got[f"layers.ffn.{n}"][0],
                               got[f"layers.ffn.{n}"][1])
                   for n in ("w_gate", "w_up", "w_down"))   # a draw a layer


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
    """Every argument of the full 94-layer config's serving steps as meta
    tensors: the reference's names, shapes and dtypes; 235 B parameters,
    nothing allocated."""
    want = _jax_specs(jax_steps.input_specs(jax_get_arch(NAME),
                                            JAX_SHAPES[shape]))
    specs = input_specs(get_arch(NAME), INPUT_SHAPES[shape])
    assert _port_specs(specs) == want
    assert sum(v.numel() for v in specs["params"].values()) == FULL_PARAMS


def test_param_specs_of_the_card_cut():
    """The 8 layers the card runs: 21,146,701,824 parameters, the expert
    stacks (8, 128, ·, ·) in bf16 and the router f32."""
    cfg = dataclasses.replace(get_arch(NAME), n_layers=8)
    specs = param_specs_for(cfg)
    assert sum(v.numel() for v in specs.values()) == CUT_PARAMS
    assert specs["layers.ffn.w_gate"].shape == (8, 128, 4096, 1536)
    assert specs["layers.ffn.w_down"].shape == (8, 128, 1536, 4096)
    assert specs["layers.ffn.w_gate"].dtype == torch.bfloat16
    assert specs["layers.ffn.router"].dtype == torch.float32


def test_reduced_config_matches_reference():
    jr, tr = jax_get_arch(NAME).reduced(), get_arch(NAME).reduced()
    for f in dataclasses.fields(tr):
        want, got = getattr(jr, f.name), getattr(tr, f.name)
        if f.name == "moe":
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        else:
            assert got == want, f.name
    full = dataclasses.asdict(get_arch(NAME).moe)
    assert full == dataclasses.asdict(jax_get_arch(NAME).moe)


# ---------------------------------------------------------------------------
# attention at a group of 16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,tq,tk,kv_block", [(True, 40, 40, 16),
                                                   (True, 33, 33, 512),
                                                   (False, 12, 45, 16)])
def test_chunked_attention_at_group_16(causal, tq, tk, kv_block):
    """32 query heads over 2 KV heads (qwen3-moe's group of 16): the
    chunked attention against the reference's, and the kernel's plain
    version against the Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(tq * tk)
    q = rng.normal(size=(2, tq, 32, 16)).astype(np.float32)
    k = rng.normal(size=(2, tk, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, tk, 2, 16)).astype(np.float32)
    want = np.asarray(JL.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, kv_block=kv_block))
    got = TL.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             causal=causal, kv_block=kv_block).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    if tq == tk:
        pallas = np.asarray(flash_attention_pallas(
            *map(jnp.asarray, (q, k, v)), causal=causal, interpret=True))
        plain = attention_ref(*map(torch.from_numpy, (q, k, v)),
                              causal=causal).numpy()
        np.testing.assert_allclose(plain, pallas, rtol=0, atol=2e-6)
