"""The MoE family's FedELMY train step (`launch.steps.make_step(cfg, train
shape)` on qwen3-moe-235b-a22b and deepseek-v2-lite-16b) against the
reference's `repro.launch.steps.make_step`; the expert products' f32
route under grad (`models/layers._MatmulF32Out` on stacks); the
dispatch's and the combine's backward, which must sum in one order on
every run and match the reference's gradients; the
router's gradient; and the attention backward's plain version at v
narrower than q and k (MLA's head dims), which deepseek's attention
takes under grad.

The models are `reduced()`: qwen3-moe-235b-a22b (2 layers, d 256, 4/4
heads at head dim 64, 4 experts top-2, d_ff_expert 128) and
deepseek-v2-lite-16b (the same MoE shape with one shared expert, on MLA
at its reduced head dims: q/k 48 = nope 32 + rope 16, v 32), f32 unless
said, the reference's init carried across by `convert.from_jax_params`,
32 tokens a row, batch 4. Tokens, labels and the pools are built as in
`test_torch_encdec_train.py`: numpy-seeded tokens, m1 and m2 the init
plus numpy noise at NOISE of each leaf's RMS, the moment pool m0, m1,
m2, the exact pool `ModelPool.create(m0, pool_size + 1)` with m1 and m2
appended, the model in training starting from m3 (a third such draw).
FedConfig at its defaults.

Routing. Every router call of the port's step is held against the
reference's top-k on the same input and router: the experts must be the
same except at a near-tie, a token whose k-th and (k+1)-th probabilities
lie closer than ROUTE_TIE of the k-th (the packages' f32 softmaxes
differ in the last ulps), which is counted and printed with the
smallest margin (the fixtures have none).

Tolerances, those of `test_torch_encdec_train.py`, set before the first
run:
- f32: task within 1e-5 relative; the params and Adam's m and v within
  1e-5 normwise per leaf, over two chained steps (f32 products, softmaxes
  and sums in another order).
- bf16: the port's and the reference's gradients (Adam's m) each against
  the reference's f32 step on the same values widened, per leaf
  normwise: the port's error at most twice the reference's + 1e-3; task
  within 5e-3 relative.
- The router's gradient, and x's and every leaf's, at the layer: rtol
  1e-5 and atol 1e-6 times its largest magnitude against `jax.grad` of
  the reference's `moe_ffn`.
- `_MatmulF32Out`'s backward on stacks against the f64 products of the same f32
  cotangent: each element within one bf16 rounding plus 2⁻¹⁶·|g|·|b|
  (chip_smoke.py phase 25 (a)'s bound for `_MatmulF32Out`).
- `ref.attention_bwd_ref` against `jax.vjp`: rtol 1e-5 and atol 1e-6
  times the gradient's largest magnitude, as `test_torch_attention_bwd.py`
  holds it.
- Determinism: bitwise."""
import dataclasses
from unittest import mock

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
from repro.models import moe as JM
from repro_torch.configs import FedConfig, ShapeConfig, get_arch
from repro_torch.convert import from_jax_params, from_jax_pool
from repro_torch.kernels.ref import (attention_bwd_ref, attention_lse_ref,
                                     attention_ref)
from repro_torch.launch import make_step
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM

torch.set_num_threads(2)

QWEN, DSV2 = "qwen3-moe-235b-a22b", "deepseek-v2-lite-16b"
T, BATCH, NOISE = 32, 4, 0.1
TRAIN = ("train_32", T, BATCH, "train")
F32_TOL = 1e-5
BF16_TASK_TOL = 5e-3
RTOL, ATOL = 1e-5, 1e-6
ROUTE_TIE = 1e-5
JIT_OPTIONS = {"xla_backend_optimization_level": 0}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    """A jax or torch array as f64 numpy (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32), np.float64)


def _with(cfg, dtype, aux):
    moe = cfg.moe if aux is None else dataclasses.replace(
        cfg.moe, router_aux_weight=aux)
    return dataclasses.replace(cfg, param_dtype=dtype, moe=moe)


def _jax_cfg(name, dtype, aux=None):
    return _with(jax_get_arch(name).reduced(), dtype, aux)


def _cfg(name, dtype, aux=None):
    return _with(get_arch(name).reduced(), dtype, aux)


def _noisy(params, seed):
    rng = np.random.default_rng(seed)

    def leaf(p):
        x = np.asarray(jnp.asarray(p, jnp.float32))
        rms = float(np.sqrt(np.mean(x * x))) or 1.0
        noise = rng.standard_normal(x.shape).astype(np.float32)
        return jnp.asarray(x + NOISE * rms * noise).astype(p.dtype)
    return jax.tree.map(leaf, params)


_SETUPS = {}


def _setup(name, dtype):
    """The reference's init m0, the start m3, both pool forms and a batch,
    with their port copies (cached)."""
    if (name, dtype) in _SETUPS:
        return _SETUPS[name, dtype]
    jm = jax_build_model(_jax_cfg(name, dtype))
    m0 = jax.jit(jm.init, compiler_options=JIT_OPTIONS)(
        jax.random.PRNGKey(0))
    m1, m2 = _noisy(m0, 1), _noisy(m0, 2)
    fed = JaxFedConfig()
    jpools = {"moment": JaxMomentPool.create(m0).append(m1).append(m2),
              "exact": JaxModelPool.create(m0, fed.pool_size + 1)
              .append(m1).append(m2)}
    rng = np.random.default_rng(35)
    vocab = _cfg(name, dtype).vocab_size
    tokens = rng.integers(0, vocab, (BATCH, T)).astype(np.int32)
    labels = rng.integers(0, vocab, (BATCH, T)).astype(np.int32)
    jp = _noisy(m0, 3)
    out = dict(jp=jp, jpools=jpools,
               jbatch={"tokens": jnp.asarray(tokens),
                       "labels": jnp.asarray(labels)},
               tp=from_jax_params(jp, "cpu"),
               tpools={k: from_jax_pool(v, "cpu") for k, v in jpools.items()},
               tbatch={"tokens": torch.from_numpy(tokens),
                       "labels": torch.from_numpy(labels)})
    _SETUPS[name, dtype] = out
    return out


_JAX_STEPS = {}


def _jax_step(monkeypatch, name, dtype, micro, aux=None):
    """The reference's jitted train step (its jit specialises on the
    batch's shapes and the pool's form at the first call)."""
    key = (name, dtype, micro, aux)
    if key not in _JAX_STEPS:
        monkeypatch.setenv("REPRO_MICROBATCH", str(micro))
        _JAX_STEPS[key] = jax.jit(jax_steps.make_step(
            _jax_cfg(name, dtype, aux), JaxShapeConfig(*TRAIN),
            JaxFedConfig()), compiler_options=JIT_OPTIONS)
    return _JAX_STEPS[key]


def _port_step(monkeypatch, name, dtype, micro, aux=None):
    monkeypatch.setenv("REPRO_MICROBATCH", str(micro))
    return make_step(_cfg(name, dtype, aux), ShapeConfig(*TRAIN), FedConfig(),
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


def _reference_top_k(router, xf, k):
    """The reference's router on the flat tokens xf: its softmax
    probabilities and top-k experts (numpy)."""
    logits = jnp.einsum("nd,de->ne", jnp.asarray(xf), jnp.asarray(router))
    probs = jax.nn.softmax(logits, axis=-1)
    return np.asarray(probs), np.asarray(jax.lax.top_k(probs, k)[1])


def _run_port_routed(step, s, form, n_steps, k):
    """`_run_port` with every router call of the steps held against the
    reference's top-k on the same input and router, outside near-ties:
    returns the runs, the near-ties and the smallest margin."""
    route = TM.route
    seen = dict(calls=0, ties=0, margin=float("inf"))

    def spy(p, c, xf):
        got = route(p, c, xf)
        probs, want = _reference_top_k(_np(p["router"]).astype(np.float32),
                                       _np(xf).astype(np.float32), k)
        top = -np.sort(-probs, axis=-1)
        margin = (top[:, k - 1] - top[:, k]) / top[:, k - 1]
        tie = margin < ROUTE_TIE
        np.testing.assert_array_equal(got[0].numpy()[~tie], want[~tie])
        seen.update(calls=seen["calls"] + 1,
                    ties=seen["ties"] + int(tie.sum()),
                    margin=min(seen["margin"], float(margin.min())))
        return got
    with mock.patch.object(TM, "route", spy):
        out = _run_port(step, s, form, n_steps)
    print(f"{seen['calls']} router calls, smallest top-{k} margin "
          f"{seen['margin']:.3e} of the k-th probability, near-ties "
          f"{seen['ties']}")
    assert seen["calls"] > 0
    return out, seen


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

# (model, pool form, REPRO_MICROBATCH): each model with each pool form
# and each microbatch count
@pytest.mark.parametrize("name,form,micro", [
    (QWEN, "moment", 1), (QWEN, "exact", 2),
    (DSV2, "moment", 2), (DSV2, "exact", 1)])
def test_train_step_f32_matches_reference(monkeypatch, name, form, micro):
    s = _setup(name, "float32")
    k = _cfg(name, "float32").moe.top_k
    want = _run_jax(_jax_step(monkeypatch, name, "float32", micro), s, form,
                    2)
    got, seen = _run_port_routed(_port_step(monkeypatch, name, "float32",
                                            micro), s, form, 2, k)
    # two layers × the row blocks × two steps
    assert seen["calls"] == 2 * micro * 2
    _hold_f32(got, want)
    # every expert stack and the router get a gradient
    m = got[0][1]["m"]
    for leaf in ("layers.ffn.router", "layers.ffn.w_gate",
                 "layers.ffn.w_up", "layers.ffn.w_down"):
        assert float(m[leaf].abs().max()) > 0, leaf


def _bf16_errs(monkeypatch, name, form, micro):
    """The port's and the reference's bf16 first steps against the
    reference's f32 step on the same values widened: Adam's m per leaf
    (the port's error, the reference's), both tasks and the f32 task."""
    s16 = _setup(name, "bfloat16")
    wide = dict(s16, jp=jax.tree.map(lambda x: x.astype(jnp.float32),
                                     s16["jp"]),
                jpools={form: jax.tree.map(
                    lambda x: x.astype(jnp.float32)
                    if x.dtype == jnp.bfloat16 else x, s16["jpools"][form])})
    oracle = _run_jax(_jax_step(monkeypatch, name, "float32", micro), wide,
                      form, 1)[0]
    ref = _run_jax(_jax_step(monkeypatch, name, "bfloat16", micro), s16,
                   form, 1)[0]
    got = _run_port(_port_step(monkeypatch, name, "bfloat16", micro), s16,
                    form, 1)[0]
    errs = {k: (_rel(_np(got[1]["m"][k]), _np(want)),
                _rel(_np(ref[1]["m"][k]), _np(want)))
            for k, want in oracle[1]["m"].items()}
    assert got[0]["layers.ffn.w_gate"].dtype == torch.bfloat16
    assert got[0]["layers.ffn.router"].dtype == torch.float32
    return errs, (got[2], ref[2], oracle[2])


@pytest.mark.parametrize("name,form,micro", [(QWEN, "moment", 2),
                                             (DSV2, "exact", 1)])
def test_train_step_bf16_against_f32_oracle(monkeypatch, name, form, micro):
    errs, (got, ref, oracle) = _bf16_errs(monkeypatch, name, form, micro)
    assert abs(got - oracle) <= BF16_TASK_TOL * abs(oracle)
    assert abs(ref - oracle) <= BF16_TASK_TOL * abs(oracle)
    for k, (port_err, ref_err) in errs.items():
        assert port_err <= 2 * ref_err + 1e-3, (k, port_err, ref_err)


def test_router_gradient_with_and_without_the_aux_loss(monkeypatch):
    """At router_aux_weight 0 the router's gradient comes through the
    gates alone, at 0.001 (the config's) through the aux loss as well:
    Adam's m of the router after one f32 step is non-zero at both, differs
    between them, and matches the reference's at each."""
    s = _setup(DSV2, "float32")
    m = {}
    for aux in (0.0, 0.001):
        want = _run_jax(_jax_step(monkeypatch, DSV2, "float32", 1, aux), s,
                        "moment", 1)
        got = _run_port(_port_step(monkeypatch, DSV2, "float32", 1, aux), s,
                        "moment", 1)
        _hold_f32(got, want)
        m[aux] = got[0][1]["m"]["layers.ffn.router"]
        assert float(m[aux].abs().max()) > 0, aux
    assert _rel(_np(m[0.001]), _np(m[0.0])) > 1e-6


@pytest.mark.parametrize("aux_weight", [0.0, 1.0])
def test_router_gradient_at_the_layer_matches_jax_grad(aux_weight):
    """`moe_ffn`'s router gradient for Σ y·gy + w·aux against `jax.grad`
    of the reference's: at w = 0 through the top-k gates and their
    renormalisation alone, at w = 1 with the aux loss's mean
    probabilities; nothing flows through the indices or the dispatch. The
    aux loss's own gradient is non-zero."""
    jcfg, tcfg = _jax_cfg(QWEN, "float32"), _cfg(QWEN, "float32")
    jp = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(4), jcfg,
                                              jnp.float32))
    tp = from_jax_params(jp, "cpu")
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 40, tcfg.d_model)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)

    def jloss(router):
        y, aux = JM.moe_ffn(dict(jax.tree.map(jnp.asarray, jp),
                                 router=router), jcfg, jnp.asarray(x))
        return jnp.sum(y * gy) + aux_weight * aux / \
            jcfg.moe.router_aux_weight
    want = np.asarray(jax.grad(jloss)(jnp.asarray(jp["router"])))
    leaf = tp["router"].clone().requires_grad_(True)
    y, aux = TM.moe_ffn(dict(tp, router=leaf), tcfg, torch.from_numpy(x))
    loss = (y * torch.from_numpy(gy)).sum() + \
        aux_weight * aux / tcfg.moe.router_aux_weight
    (got,) = torch.autograd.grad(loss, [leaf])
    assert float(got.abs().max()) > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))
    (g_aux,) = torch.autograd.grad(TM.moe_ffn(dict(tp, router=leaf), tcfg,
                                              torch.from_numpy(x))[1],
                                   [leaf])
    assert float(g_aux.abs().max()) > 0


# ---------------------------------------------------------------------------
# determinism of the dispatch's and the combine's backward
# ---------------------------------------------------------------------------

def test_two_cpu_steps_are_bitwise_equal(monkeypatch):
    """Two runs of the same f32 step on the CPU with 2 threads give the
    same bits in every parameter and Adam moment (ROADMAP C19's check
    applied to the MoE step). deepseek-v2-lite-16b `reduced()` routed as
    the full model routes, 6 of its experts a token (8 here), over 4 ×
    256 tokens in 2 row blocks, from the port's own init: a dispatch
    backward that adds a token's 6 rows with atomic adds in the threads'
    order (the backward of indexing) gives other bits on most runs."""
    from repro_torch.core.pool import MomentPool
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    cfg = _cfg(DSV2, "float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=6))
    params = build_model(cfg, "cpu").init(0)
    pool = MomentPool.create(params)
    rng = np.random.default_rng(36)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 256))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    fed = FedConfig()
    opt = make_optimizer(fed.optimizer, fed.learning_rate, fed.weight_decay)
    monkeypatch.setenv("REPRO_MICROBATCH", "2")
    step = make_step(cfg, ShapeConfig("train_256", 256, 4, "train"), fed,
                     device="cpu")
    runs = [step(params, opt.init(params), batch, pool, 0)
            for _ in range(2)]
    (p1, o1, t1), (p2, o2, t2) = runs
    assert torch.equal(t1, t2)
    for a, b in ((p1, p2), (o1["m"], o2["m"]), (o1["v"], o2["v"])):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_moe_backward_sums_in_one_order():
    """At 4 × 1,024 tokens, each routed to 6 of 8 experts (deepseek's
    top-6) with a shared expert, on 2 threads, the gradients of x and of
    every leaf through `moe_ffn` are bitwise the same over 20 repeats.
    The backward of indexing, which added each token's 6 rows with
    atomic adds in the threads' order, gave other bits here."""
    tcfg = _cfg(QWEN, "float32")
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, n_experts=8, top_k=6, n_shared_experts=1))
    params = TM.moe_init(torch.Generator().manual_seed(3), tcfg,
                         torch.float32)
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.normal(size=(4, 1024, tcfg.d_model))
                         .astype(np.float32))
    gy = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    seen = set()
    for _ in range(20):
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        xl = x.clone().requires_grad_(True)
        y, aux = TM.moe_ffn(leaves, tcfg, xl)
        grads = torch.autograd.grad((y * gy).sum() + aux,
                                    [xl] + list(leaves.values()))
        seen.add(b"".join(g.numpy().tobytes() for g in grads))
    assert len(seen) == 1


def test_dispatch_and_combine_gradients_match_jax_grad():
    """The gradients of x and of every leaf of `moe_ffn` for Σ y·gy + aux
    against `jax.grad` of the reference's, at capacity factor 0.5, where
    some assignments drop: the dispatch's backward (the gather of each
    assignment's row by `order`, the repeat's sum over a token's k rows)
    and the combine's (zero for a dropped assignment) carry the
    reference's gradient."""
    jcfg, tcfg = _jax_cfg(QWEN, "float32"), _cfg(QWEN, "float32")
    jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
        c.moe, capacity_factor=0.5, n_shared_experts=1))
        for c in (jcfg, tcfg))
    jp = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(5), jcfg,
                                              jnp.float32))
    tp = from_jax_params(jp, "cpu")
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 40, tcfg.d_model)).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    assert int(TM.drops(tp, tcfg, torch.from_numpy(x))) > 0

    def jloss(p, xx):
        y, aux = JM.moe_ffn(p, jcfg, xx)
        return jnp.sum(y * gy) + aux
    want = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                           jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xl = torch.from_numpy(x).requires_grad_(True)
    y, aux = TM.moe_ffn(leaves, tcfg, xl)
    got = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + aux,
                              [xl] + list(leaves.values()))
    wants = [want[1]] + [from_jax_params(want[0], "cpu")[k] for k in leaves]
    for name, g, w in zip(["x"] + list(leaves), got, wants):
        w = _np(w)
        assert float(np.abs(w).max()) > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * float(np.abs(w).max()),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the expert products under grad
# ---------------------------------------------------------------------------

def _bmm_widened(a, b, out_dtype=None, _bmm=torch.bmm):
    """cuBLAS's bf16 batched product with an f32 output, as the CPU can
    compute it: bf16·bf16 products are exact in f32, so only the order of
    the f32 sums differs."""
    if out_dtype is None:
        return _bmm(a, b)
    return _bmm(a.to(out_dtype), b.to(out_dtype))


def test_bmm_f32_routes_and_plain_backward():
    """`layers.matmul_f32` on stacks (E, C, K) @ (E, K, N) on the CPU: f32
    stacks multiply as they are, bf16 ones widened to f32 first (bitwise
    either way), and under grad autograd of the widened route gives da and
    db in bf16 within one rounding of the f64 products. The
    `_MatmulF32Out` route is taken only for CUDA tensors (never here: its
    output-dtype product has no CPU kernel)."""
    rng = np.random.default_rng(11)
    a32 = torch.from_numpy(rng.normal(size=(3, 16, 24)).astype(np.float32))
    b32 = torch.from_numpy(rng.normal(size=(3, 24, 8)).astype(np.float32))
    assert torch.equal(TL.matmul_f32(a32, b32), torch.bmm(a32, b32))
    a, b = a32.bfloat16(), b32.bfloat16()
    assert torch.equal(TL.matmul_f32(a, b), torch.bmm(a.float(), b.float()))
    with mock.patch.object(TL._MatmulF32Out, "apply",
                           side_effect=AssertionError("CUDA route")):
        al, bl = a.clone().requires_grad_(True), b.clone().requires_grad_(True)
        y = TL.matmul_f32(al, bl)
        assert y.dtype == torch.float32 and y.shape == (3, 16, 8)
        g = torch.from_numpy(rng.normal(size=y.shape).astype(np.float32))
        da, db = torch.autograd.grad(y, [al, bl], g)
    assert da.dtype == db.dtype == torch.bfloat16
    gd, ad, bd = g.double(), a.double(), b.double()
    for got, want in ((da, gd @ bd.transpose(1, 2)),
                      (db, ad.transpose(1, 2) @ gd)):
        assert float(((got.double() - want).abs() /
                      (2.0 ** -8 * want.abs() + 1e-30)).max()) <= 1.0


def test_bmm_f32_out_backward_holds_g_in_two_terms():
    """`_MatmulF32Out`'s backward on stacks (run here with cuBLAS's
    f32-output batched product stood in for by the widened product): da =
    g·bᵀ and db = aᵀ·g in bf16 from g split into two bf16 terms, each
    element within one bf16 rounding plus 2⁻¹⁶·|g|·|b| of the f64 products
    of the f32 g; rounding g once to bf16 first does not hold that
    bound."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(rng.normal(size=(4, 64, 96)).astype(
        np.float32)).bfloat16().requires_grad_(True)
    b = torch.from_numpy((rng.normal(size=(4, 96, 48)) / 10).astype(
        np.float32)).bfloat16().requires_grad_(True)
    # a cotangent with cancelling terms, where one bf16 rounding of g shows
    g = torch.from_numpy((rng.normal(size=(4, 64, 48)) *
                          np.exp(rng.normal(size=(4, 64, 48)) * 3)).astype(
        np.float32))
    with mock.patch.object(torch, "bmm", _bmm_widened):
        y = TL._MatmulF32Out.apply(a, b)
        da, db = torch.autograd.grad(y, [a, b], g)
    assert y.dtype == torch.float32 and da.dtype == db.dtype == torch.bfloat16
    assert torch.equal(y, torch.bmm(a.detach().float(), b.detach().float()))

    def share(got, x, w):
        want = x.double() @ w.double()
        bound = 2.0 ** -8 * want.abs() + 2.0 ** -16 * (
            x.double().abs() @ w.double().abs())
        return float(((got.double() - want).abs() / bound).max())
    ad, bd = a.detach(), b.detach()
    assert share(da, g, bd.transpose(1, 2)) <= 1.0
    assert share(db, ad.transpose(1, 2), g) <= 1.0
    gb = g.bfloat16().float()
    once = torch.bmm(gb, bd.float().transpose(1, 2)).bfloat16()
    assert share(once, g, bd.transpose(1, 2)) > 1.0


# ---------------------------------------------------------------------------
# the attention backward's plain version at dv ≠ hd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,h,kv,hd,dv,causal,kv_block", [
    (2, 40, 4, 4, 48, 32, True, 16),      # deepseek reduced()'s MLA
    (2, 40, 4, 4, 48, 32, False, 512),
    (1, 70, 4, 4, 192, 128, True, 32),    # deepseek-v2-lite-16b's
    (1, 70, 4, 2, 192, 128, False, 16)])  # and a group of 2
def test_plain_backward_at_narrow_values_matches_jax_vjp(b, t, h, kv, hd, dv,
                                                         causal, kv_block):
    """`ref.attention_bwd_ref` (the backward kernel's plain version) from
    `attention_ref`'s out and `attention_lse_ref` at v narrower than q and
    k against `jax.vjp` of the reference's chunked `flash_attention`,
    whose gradient the reference's MLA training takes: dq and dk at hd,
    dv at dv, scale hd^-1/2."""
    rng = np.random.default_rng(hd * t + dv + causal)
    q = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, dv)).astype(np.float32)
    do = rng.normal(size=(b, t, h, dv)).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: JL.flash_attention(
        q, k, v, causal=causal, kv_block=kv_block),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    t_out = attention_ref(tq_, tk_, tv_, causal=causal)
    lse = attention_lse_ref(tq_, tk_, causal=causal)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=RTOL,
                               atol=ATOL * float(np.abs(out).max()))
    got = attention_bwd_ref(tq_, tk_, tv_, t_out, lse, tdo, causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        w = np.asarray(w)
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * float(np.abs(w).max()))
