"""The FedELMY train step (`launch.steps.make_step(cfg, train shape)`) and
its input specs (`launch.steps.input_specs`) against the reference's
`repro.launch.steps`.

The model is `reduced()` llama3.2-1b (2 layers, d_model 256, 4 over 4
heads, hd 64, vocab 1,024, its sliding window 64) at 64-token sequences,
batch 4 (`make_lm_dataset`, one domain), with params from the reference's
`init` carried across. The pools are built the same way on both sides:
m0 the init, m1 and m2 m0 plus numpy noise at NOISE of each leaf's RMS;
the moment pool is `MomentPool.create(m0).append(m1).append(m2)`, the
exact pool `ModelPool.create(m0, pool_size + 1)` with m1 and m2 appended
(3 of 6 slots live). The model in training starts at the anchor m0 (a
pool model's first step) or away from it at m3, a third such draw.
FedConfig at its defaults (Adam, lr 5e-5, weight decay 1e-4, α 0.06,
β 1).

Tolerances, set before the first run:
- f32: task within 1e-5 relative; Adam's m and v and the params within
  1e-5 normwise per leaf (two layers of f32 products in another order;
  Adam's first step moves each param by ~lr, whatever its gradient's
  size): over two chained steps from m3, and over the first step from
  the anchor. Not over a second step from the anchor: there d2's
  gradient is (w − m0)/‖w − m0‖ with w − m0 ≈ lr, ~1,000× smaller than
  the params, so the first step's 3e-7 normwise param difference becomes
  ~4e-4 in Adam's m (measured), in any two f32 implementations. NOISE is
  0.1: the moment-form d1 is
  sqrt(‖w‖² − 2⟨w, μ⟩ + q), a difference of sums of ~P·RMS² each, and at
  members 1e-3·RMS apart it keeps ~1e-6 of their size, so two f32
  summation orders (XLA's and PyTorch's) already move it by ~10%
  (`test_moment_d1_conditioning` reads that; ROADMAP C6).
- bf16: the port's and the reference's gradients (Adam's m over 1 − b1)
  each against the reference's f32 step on the same values widened, per
  leaf normwise: the port's error at most twice the reference's + 1e-3;
  task within 5e-3 relative.
- C6: on a fresh moment pool (w = μ) the moment-form d1's gradient is
  exactly 0 in the port, so at β = 0 the step with α > 0 equals the
  task-only step bit for bit; the reference's jitted step computes a
  rounding residue there, so the comparison with it runs at α = 0."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import FedConfig as JaxFedConfig
from repro.configs import INPUT_SHAPES as JAX_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.core.pool import ModelPool as JaxModelPool
from repro.core.pool import MomentPool as JaxMomentPool
from repro.launch import steps as jax_steps
from repro.models import build_model as jax_build_model
from repro_torch.configs import INPUT_SHAPES, FedConfig, ShapeConfig, get_arch
from repro_torch.convert import from_jax_params, from_jax_pool
from repro_torch.core.pool import MomentPool
from repro_torch.data import make_lm_dataset
from repro_torch.launch import input_specs, make_step, param_specs_for
from repro_torch.models import build_model

torch.set_num_threads(2)

SEQ, BATCH, NOISE = 64, 4, 0.1
TRAIN = ("train_64", SEQ, BATCH, "train")
F32_TOL = 1e-5
BF16_TASK_TOL = 5e-3
B1 = 0.9
NAMES = ["llama3.2-1b", "rwkv6-7b", "zamba2-7b"]
# the reference's init and steps compile at XLA's lowest backend
# optimization level: the same functions in half the compile time, which
# is most of this module's
JIT_OPTIONS = {"xla_backend_optimization_level": 0}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _np(x):
    """A jax or torch array as f64 numpy (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        return x.detach().double().numpy()
    return np.asarray(jnp.asarray(x, jnp.float64) if x.dtype != jnp.bfloat16
                      else jnp.asarray(x, jnp.float32), np.float64)


def _jax_cfg(name, dtype="float32"):
    return dataclasses.replace(jax_get_arch(name).reduced(),
                               param_dtype=dtype)


def _cfg(name, dtype="float32"):
    return dataclasses.replace(get_arch(name).reduced(), param_dtype=dtype)


def _noisy(params, seed):
    """m0 plus numpy noise at NOISE of each leaf's RMS, in the leaf's
    dtype."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        x = np.asarray(jnp.asarray(p, jnp.float32))
        rms = float(np.sqrt(np.mean(x * x))) or 1.0
        noise = rng.standard_normal(x.shape).astype(np.float32)
        return jnp.asarray(x + NOISE * rms * noise).astype(p.dtype)
    return jax.tree.map(leaf, params)


def _setups(name, dtype="float32", forms=("moment", "exact")):
    """For each start, the model in training (the anchor m0, the
    reference's init, or m3 away from it), the pool kinds `forms` around
    m0, a batch, and their port copies: {"anchor": …, "away": …}."""
    jm = jax_build_model(_jax_cfg(name, dtype))
    m0 = jax.jit(jm.init, compiler_options=JIT_OPTIONS)(
        jax.random.PRNGKey(0))
    m1, m2 = _noisy(m0, 1), _noisy(m0, 2)
    fed = JaxFedConfig()
    make = {"moment": lambda a, b, c: JaxMomentPool.create(a).append(b)
            .append(c),
            "exact": lambda a, b, c: JaxModelPool.create(
                a, fed.pool_size + 1).append(b).append(c)}
    jpools = {form: jax.jit(make[form], compiler_options=JIT_OPTIONS)(
        m0, m1, m2) for form in forms}
    tpools = {k: from_jax_pool(v, "cpu") for k, v in jpools.items()}
    s = make_lm_dataset(n_seqs=BATCH, seq_len=SEQ, vocab=1024,
                        n_domains=1, seed=0)[0].tokens
    batch = {"tokens": s[:, :-1].astype(np.int32),
             "labels": s[:, 1:].astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for start, jp in (("anchor", m0), ("away", _noisy(m0, 3))):
        out[start] = dict(jp=jp, jpools=jpools, jbatch=jbatch,
                          tp=from_jax_params(jp, "cpu"), tpools=tpools,
                          tbatch=tbatch)
    return out


@pytest.fixture(scope="module")
def llama():
    return {(dt, start): s for dt in ("float32", "bfloat16")
            for start, s in _setups("llama3.2-1b", dt).items()}


@pytest.fixture(scope="module")
def jax_steps_cache():
    """The reference's jitted train steps, one per (arch, dtype, micro,
    regularizers, α, β), shared by the module's tests."""
    return {}


def _jax_step(cache, monkeypatch, name, dtype, micro, regularizers=True,
              **fed):
    key = (name, dtype, micro, regularizers, tuple(sorted(fed.items())))
    if key not in cache:
        monkeypatch.setenv("REPRO_MICROBATCH", str(micro))
        cache[key] = jax.jit(jax_steps.make_step(
            _jax_cfg(name, dtype), JaxShapeConfig(*TRAIN),
            JaxFedConfig(**fed), regularizers),
            compiler_options=JIT_OPTIONS)
    return cache[key]


def _port_step(monkeypatch, name, dtype, micro, regularizers=True, **fed):
    monkeypatch.setenv("REPRO_MICROBATCH", str(micro))
    return make_step(_cfg(name, dtype), ShapeConfig(*TRAIN), FedConfig(**fed),
                     regularizers, device="cpu")


def _run_jax(step, s, form, n_steps=2):
    """n_steps chained steps of the reference from its params and a fresh
    Adam state; [(params, opt_state, task)] after each."""
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


def _run_port(step, s, form, n_steps=2):
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
# (1) input specs
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
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = tree.items()
    out = {}
    for k, v in items:
        out.update(_port_specs(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("shape,form", [("train_4k", "moment"),
                                        ("train_4k", "exact"),
                                        ("prefill_32k", None),
                                        ("decode_32k", None)])
def test_input_specs_match_reference(monkeypatch, name, shape, form):
    """Names, shapes and dtypes of every argument at full size, the train
    kind under both REPRO_POOL_FORM values; every leaf a meta tensor."""
    if form:
        monkeypatch.setenv("REPRO_POOL_FORM", form)
    want = _jax_specs(jax_steps.input_specs(jax_get_arch(name),
                                            JAX_SHAPES[shape]))
    got = _port_specs(input_specs(get_arch(name), INPUT_SHAPES[shape]))
    assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_param_specs_match_real_init(name):
    """`param_specs_for` at reduced size: the port's real `init`, name by
    name, in shape and dtype, and the reference's init's shapes."""
    specs = param_specs_for(_cfg(name, "bfloat16"))
    real = build_model(_cfg(name, "bfloat16"), "cpu").init(0)
    ref = _jax_specs(jax.eval_shape(jax_build_model(
        _jax_cfg(name, "bfloat16")).init, jax.random.PRNGKey(0)))
    assert list(specs) == list(real) == list(ref)
    for k, v in specs.items():
        assert v.device.type == "meta"
        assert (v.shape, v.dtype) == (real[k].shape, real[k].dtype), k
    assert _port_specs(specs) == ref


# ---------------------------------------------------------------------------
# (2) f32 parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form,regularizers", [("moment", True),
                                               ("exact", True),
                                               ("moment", False)])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("start,n_steps", [("away", 2), ("anchor", 1)])
def test_train_step_f32_matches_reference(monkeypatch, llama,
                                          jax_steps_cache, form, micro,
                                          regularizers, start, n_steps):
    """Both pool forms with the regularizers, and the task alone (which
    reads no pool, so one form of it)."""
    s = llama["float32", start]
    want = _run_jax(_jax_step(jax_steps_cache, monkeypatch, "llama3.2-1b",
                              "float32", micro, regularizers), s, form,
                    n_steps)
    got = _run_port(_port_step(monkeypatch, "llama3.2-1b", "float32", micro,
                               regularizers), s, form, n_steps)
    _hold_f32(got, want)


def test_train_step_leaves_inputs_unchanged(monkeypatch, llama):
    """The step is functional: the caller's params, Adam state, pool and
    batch keep their values."""
    s = llama["float32", "away"]
    before = {k: v.clone() for k, v in s["tp"].items()}
    pool = s["tpools"]["exact"]
    members = {k: v.clone() for k, v in pool.members.items()}
    opt = {k: {n: torch.zeros(v.shape) for n, v in s["tp"].items()}
           for k in ("m", "v")}
    step = _port_step(monkeypatch, "llama3.2-1b", "float32", 2)
    p, o, _ = step(s["tp"], opt, s["tbatch"], pool, 0)
    assert all(torch.equal(before[k], v) for k, v in s["tp"].items())
    assert all(torch.equal(members[k], v) for k, v in pool.members.items())
    assert all(float(v.abs().max()) == 0 for d in opt.values()
               for v in d.values())
    assert all(not v.requires_grad for v in p.values())


def test_microbatch_must_divide_batch(monkeypatch, llama):
    s = llama["float32", "away"]
    step = _port_step(monkeypatch, "llama3.2-1b", "float32", 3)
    opt = {k: {n: torch.zeros(v.shape) for n, v in s["tp"].items()}
           for k in ("m", "v")}
    with pytest.raises(ValueError, match="REPRO_MICROBATCH=3"):
        step(s["tp"], opt, s["tbatch"], s["tpools"]["moment"], 0)


# ---------------------------------------------------------------------------
# (3) bf16 parity against the f32 oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form,micro", [("moment", 1), ("moment", 2),
                                        ("exact", 1)])
def test_train_step_bf16_against_f32_oracle(monkeypatch, llama,
                                            jax_steps_cache, form, micro):
    """Both pool forms, and the microbatched sum (which the pool form
    does not touch) on one of them."""
    s16, s32 = llama["bfloat16", "away"], llama["float32", "away"]
    wide = dict(s32, jp=jax.tree.map(lambda x: x.astype(jnp.float32),
                                     s16["jp"]),
                jpools={form: jax.tree.map(
                    lambda x: x.astype(jnp.float32)
                    if x.dtype == jnp.bfloat16 else x, s16["jpools"][form])})
    oracle = _run_jax(_jax_step(jax_steps_cache, monkeypatch, "llama3.2-1b",
                                "float32", micro), wide, form, 1)[0]
    ref = _run_jax(_jax_step(jax_steps_cache, monkeypatch, "llama3.2-1b",
                             "bfloat16", micro), s16, form, 1)[0]
    got = _run_port(_port_step(monkeypatch, "llama3.2-1b", "bfloat16",
                               micro), s16, form, 1)[0]
    assert abs(got[2] - oracle[2]) <= BF16_TASK_TOL * abs(oracle[2])
    assert abs(ref[2] - oracle[2]) <= BF16_TASK_TOL * abs(oracle[2])
    for k, want in oracle[1]["m"].items():
        port_err = _rel(_np(got[1]["m"][k]), _np(want))
        ref_err = _rel(_np(ref[1]["m"][k]), _np(want))
        assert port_err <= 2 * ref_err + 1e-3, (k, port_err, ref_err)
        assert got[0][k].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (4) C6: the moment-form d1 at w = μ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c6_fresh_moment_pool(monkeypatch, llama, jax_steps_cache, dtype):
    """On a fresh moment pool (w = μ, every residual 0) the port's d1
    gradient is exactly 0: at β = 0 the step with α > 0 gives the
    task-only step's bits, in f32 and bf16. (The reference's jitted f32
    step does not: its Adam m reads ~6e3 normwise off the task-only m
    there, ROADMAP C6.) Against the reference at α = 0 in f32."""
    s = dict(llama[dtype, "anchor"])
    s["tpools"] = {"fresh": MomentPool.create(s["tp"])}
    s["jpools"] = {"fresh": JaxMomentPool.create(s["jp"])}
    d1_only = _run_port(_port_step(monkeypatch, "llama3.2-1b", dtype, 1,
                                   beta=0.0), s, "fresh", 1)[0]
    task_only = _run_port(_port_step(monkeypatch, "llama3.2-1b", dtype, 1,
                                     regularizers=False), s, "fresh", 1)[0]
    assert d1_only[2] == task_only[2]
    for k in task_only[0]:
        assert torch.equal(d1_only[0][k], task_only[0][k]), k
        for moment in ("m", "v"):
            assert torch.equal(d1_only[1][moment][k],
                               task_only[1][moment][k]), (moment, k)
    if dtype == "float32":
        want = _run_jax(_jax_step(jax_steps_cache, monkeypatch,
                                  "llama3.2-1b", dtype, 1, alpha=0.0), s,
                        "fresh", 1)
        got = _run_port(_port_step(monkeypatch, "llama3.2-1b", dtype, 1,
                                   alpha=0.0), s, "fresh", 1)
        _hold_f32(got, want)


def test_c19_embedding_backward_in_a_fixed_order():
    """ROADMAP C19: the token embedding's gradient (`transformer.
    embed_tokens`, the gather every family's forward starts with) is
    bitwise on repeat on the CPU with several threads, at a batch where
    every row of the table is hit ~2,000 times. The backward of indexing
    (`embed[tokens]`, `index_put_` with accumulate) added those rows with
    atomic adds in the threads' order and gave a new result on most
    repeats here, which made C6's bitwise comparison fail under load."""
    from repro_torch.models.transformer import embed_tokens
    rng = np.random.default_rng(19)
    table = torch.from_numpy(rng.standard_normal((8, 256)).astype(
        np.float32))
    tokens = torch.from_numpy(rng.integers(0, 8, (4, 4096)).astype(
        np.int32))
    g = torch.from_numpy(rng.standard_normal((4, 4096, 256)).astype(
        np.float32))
    with torch.no_grad():
        want = torch.zeros_like(table).index_add_(
            0, tokens.reshape(-1).long(), g.reshape(-1, 256))
    seen = set()
    for _ in range(20):
        leaf = table.clone().requires_grad_(True)
        x = embed_tokens({"embed": leaf}, tokens)
        assert torch.equal(x.detach(), table[tokens.long()])
        (grad,) = torch.autograd.grad(x, [leaf], g)
        seen.add(grad.numpy().tobytes())
    assert len(seen) == 1
    torch.testing.assert_close(grad, want, rtol=1e-5, atol=1e-3)


def test_moment_d1_conditioning():
    """The moment-form d1 at members 1e-3·RMS apart: the reference's and
    the port's f32 values of ‖w‖² − 2⟨w, μ⟩ + q differ from the f64 value
    by far more than at NOISE (the reason the parity tests use NOISE)."""
    cfg = _jax_cfg("llama3.2-1b")
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(0))
    errs = {}
    for noise in (1e-3, NOISE):
        rng = np.random.default_rng(5)
        members = [jax.tree.map(lambda x: x + noise * float(
            jnp.sqrt(jnp.mean(x * x))) * jnp.asarray(rng.standard_normal(
                x.shape), jnp.float32), jp) for _ in range(2)]
        w = jax.tree.map(lambda x: x + noise * 0.5 * float(
            jnp.sqrt(jnp.mean(x * x))) * jnp.asarray(rng.standard_normal(
                x.shape), jnp.float32), jp)
        jpool = JaxMomentPool.create(members[0]).append(members[1])
        tpool = from_jax_pool(jpool, "cpu")
        exact = sum(
            0.5 * float(np.sum((np.asarray(a, np.float64) -
                                np.asarray(b, np.float64)) ** 2))
            for m in members
            for a, b in zip(jax.tree.leaves(w), jax.tree.leaves(m)))
        ref = float(jpool.mean_sq_distance(w))
        port = float(tpool.mean_sq_distance(from_jax_params(w, "cpu")))
        errs[noise] = max(abs(ref - exact), abs(port - exact)) / exact
    assert errs[1e-3] > 100 * errs[NOISE]
    assert errs[NOISE] < 1e-5


@pytest.mark.parametrize("noise", [1e-3, NOISE])
def test_moment_d1_bf16_gradient_rounded_once(noise):
    """The moment-form d1 of bf16 leaves: each leaf is widened once for
    both of mean_sq_distance's sums, so its gradient is the f32 leaves'
    gradient rounded once to bf16, bit for bit, also with w within
    1e-3·RMS of μ (there, rounded term by term, 2w·ḡ and 2μ·ḡ would
    cancel to bf16 noise)."""
    from repro_torch.core.distances import d1_moment
    rng = np.random.default_rng(11)
    m0 = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
          .bfloat16() for k, s in (("a", (64, 33)), ("b", (17,)))}

    def near(seed):
        r = np.random.default_rng(seed)
        return {k: (v.float() + noise * v.float().square().mean().sqrt() *
                    torch.from_numpy(r.standard_normal(v.shape).astype(
                        np.float32))).bfloat16() for k, v in m0.items()}
    pool = MomentPool.create(m0).append(near(1)).append(near(2))
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        leaves = {k: v.to(dtype).requires_grad_(True) for k, v in
                  near(3).items()}
        d1_moment(leaves, pool).backward()
        grads[dtype] = {k: v.grad for k, v in leaves.items()}
    for k, g in grads[torch.bfloat16].items():
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, grads[torch.float32][k].bfloat16()), k


def _product_bound(g, w):
    """One bf16 rounding of the f64 product g·w, 2⁻⁸·|g·w|, plus 2⁻¹⁶ of
    |g|·|w|: what splitting g into two bf16 terms (hi, lo; they hold g to
    2⁻¹⁸ of itself) and summing their products in f32 may add."""
    g, w = g.double(), w.double()
    return g @ w, 2.0 ** -8 * (g @ w).abs() + 2.0 ** -16 * (g.abs() @
                                                            w.abs())


def test_bf16_product_backward_on_the_card_route(monkeypatch):
    """`layers._MatmulF32Out`, the card's bf16 product with an f32 output
    under grad: its backward multiplies the f32 cotangent g as the
    reference does, g in two bf16 terms, hi = bf16(g) and lo = bf16(g −
    hi), dx = g·wᵀ and dw = xᵀ·g each the f32 sum of both terms' products
    rounded once to bf16. So each element lies within `_product_bound`
    of the f64 product of the f32 g, which rounding g once to bf16 (one
    term) would break by far. The CPU has no ``mm(out_dtype=)``; here it
    stands in as the product of the widened operands."""
    from repro_torch.models import layers
    real_mm = torch.mm

    def mm(a, b, out_dtype=None):
        return a.float() @ b.float() if out_dtype else real_mm(a, b)
    monkeypatch.setattr(torch, "mm", mm)
    rng = np.random.default_rng(4)
    x, w, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((64, 256), (256, 128), (64, 128)))
    x, w = x.bfloat16().requires_grad_(True), w.bfloat16().requires_grad_(
        True)
    y = layers._MatmulF32Out.apply(x, w)
    assert y.dtype == torch.float32
    assert torch.equal(y, x.detach().float() @ w.detach().float())
    dx, dw = torch.autograd.grad(y, (x, w), g)
    assert dx.dtype == dw.dtype == torch.bfloat16
    xf, wf = x.detach().float(), w.detach().float()
    hi = g.bfloat16().float()
    lo = (g - hi).bfloat16().float()
    assert torch.equal(dx, (hi @ wf.T + lo @ wf.T).bfloat16())
    assert torch.equal(dw, (xf.T @ hi + xf.T @ lo).bfloat16())
    for got, one_term, (a, b) in ((dx, hi @ wf.T, (g, wf.T)),
                                  (dw, xf.T @ hi, (xf.T, g))):
        want, bound = _product_bound(a, b)
        assert float(((got.double() - want).abs() / bound).max()) <= 1.0
        assert float(((one_term.bfloat16().double() - want).abs() /
                      bound).max()) > 4.0


# ---------------------------------------------------------------------------
# (5) SSM and hybrid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rwkv6-7b", "zamba2-7b"])
def test_train_step_ssm_matches_reference(monkeypatch, jax_steps_cache,
                                          name):
    """One f32 step of reduced rwkv6-7b and zamba2-7b with the moment
    pool (both take the CPU's plain GLA) against the reference."""
    s = _setups(name, forms=("moment",))["away"]
    want = _run_jax(_jax_step(jax_steps_cache, monkeypatch, name, "float32",
                              1), s, "moment", 1)
    got = _run_port(_port_step(monkeypatch, name, "float32", 1), s,
                    "moment", 1)
    _hold_f32(got, want)


def test_make_step_train_needs_a_device():
    """Without a GPU and without `device=`, make_step raises; with
    ``device="cpu"`` it returns the train step."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    shape = INPUT_SHAPES["train_4k"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_step(_cfg("llama3.2-1b"), shape)
    assert callable(make_step(_cfg("llama3.2-1b"), shape, device="cpu"))
