"""Port parity for the GLA core and the SSM blocks: `models/ssm.py` and
`kernels/ref.gla_recurrence_ref` against the JAX reference, on the same
numpy inputs and parameters carried across from the reference's init.

The plain chunked GLA (`gla_chunked_plain`, the CPU route of
`gla_chunked` and the GLA kernel's plain version) is held against three
references: the reference's jnp formulation (`models.ssm.gla_chunked`),
its Pallas kernel with the host scan (`kernels.ops.gla_chunked`, interpret
mode on the CPU) and the step-by-step recurrence. The kernel itself runs
only on the card (`chip_smoke.py` phase 13); here its wrapper must refuse
CPU tensors and bad shapes.

Tolerances (f32): 1e-5 against the JAX chunked formulations — rtol
1e-5 and atol 1e-5 times the largest |output| (the same sums of up to
L·K = 2048 terms in another order, the Pallas kernel adding the
per-channel scores in blocks of 16 channels; outputs reach |y| ≈ 10–40,
so an element that cancels keeps an absolute error of the output's
scale); rtol = atol = 1e-4 against the recurrence, the JAX test's own
(chunking reassociates every sum); the blocks rtol 1e-5, atol 2e-5 (one
block of f32 products of length ≤ 512 after the GLA, outputs O(1))."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import ssm as JSSM
from repro_torch.configs import get_arch
from repro_torch.convert import from_jax_params
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.chunk_scan import gla_chunk_f32
from repro_torch.models import ssm as TSSM

torch.set_num_threads(2)

JAX_TOL = "jax"          # rtol 1e-5, atol 1e-5 · max |want|
REC_TOL = dict(rtol=1e-4, atol=1e-4)
BLOCK_TOL = dict(rtol=1e-5, atol=2e-5)

# the reference test's shapes (tests/test_kernels.py): b, t, h, K, V, chunk
SHAPES = [(1, 32, 2, 8, 8, 8), (2, 64, 3, 16, 32, 16),
          (1, 128, 2, 64, 64, 32)]


def _gla_inputs(mode, b, t, h, kd, vd, seed, init=False):
    """q, k, v ~ N(0, 1); Mamba2: scalar log decay −softplus(N(0, 1)),
    no bonus; RWKV6: per-channel −exp(N(0, 1) − 1), bonus exp(0.1·N);
    optionally an N(0, 1) initial state."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = dict(q=rng.normal(size=(b, t, h, kd)).astype(f32),
             k=rng.normal(size=(b, t, h, kd)).astype(f32),
             v=rng.normal(size=(b, t, h, vd)).astype(f32))
    if mode == "mamba2":
        x["log_decay"] = (-np.logaddexp(0, rng.normal(size=(b, t, h)))
                          ).astype(f32)
        x["bonus"] = None
    else:
        x["log_decay"] = (-np.exp(rng.normal(size=(b, t, h, kd)) - 1.0)
                          ).astype(f32)
        x["bonus"] = np.exp(0.1 * rng.normal(size=(h, kd))).astype(f32)
    x["initial_state"] = (rng.normal(size=(b, h, kd, vd)).astype(f32)
                          if init else None)
    return x


def _as(kind, x):
    conv = jnp.asarray if kind == "jax" else torch.from_numpy
    return {k: None if v is None else conv(v) for k, v in x.items()}


def _port_plain(x, chunk):
    t = _as("torch", x)
    y, s = TSSM.gla_chunked_plain(t["q"], t["k"], t["v"], t["log_decay"],
                                  chunk=chunk, bonus=t["bonus"],
                                  initial_state=t["initial_state"])
    return y.numpy(), s.numpy()


def _recurrence(x):
    j = _as("jax", x)
    y, s = JREF.gla_recurrence_ref(j["q"], j["k"], j["v"], j["log_decay"],
                                   bonus=j["bonus"],
                                   initial_state=j["initial_state"])
    return np.asarray(y), np.asarray(s)


def _jnp_chunked(x, chunk):
    j = _as("jax", x)
    y, s = JSSM.gla_chunked(j["q"], j["k"], j["v"], j["log_decay"],
                            chunk=chunk, bonus=j["bonus"],
                            initial_state=j["initial_state"])
    return np.asarray(y), np.asarray(s)


def _assert_pair(got, want, tol):
    for g, w, name in zip(got, want, ("y", "state")):
        if tol == JAX_TOL:
            kw = dict(rtol=1e-5, atol=1e-5 * float(np.abs(w).max()))
        else:
            kw = tol
        np.testing.assert_allclose(g, w, err_msg=name, **kw)


@pytest.mark.parametrize("b,t,h,kd,vd,chunk", SHAPES)
@pytest.mark.parametrize("mode", ["mamba2", "rwkv6"])
def test_plain_gla_matches_jax_formulations_and_recurrence(b, t, h, kd, vd,
                                                           chunk, mode):
    x = _gla_inputs(mode, b, t, h, kd, vd, seed=t * h * kd)
    got = _port_plain(x, chunk)
    _assert_pair(got, _jnp_chunked(x, chunk), JAX_TOL)
    j = _as("jax", x)
    pallas = JOPS.gla_chunked(j["q"], j["k"], j["v"], j["log_decay"],
                              chunk=chunk, pre=mode == "rwkv6",
                              bonus=j["bonus"])
    _assert_pair(got, tuple(map(np.asarray, pallas)), JAX_TOL)
    _assert_pair(got, _recurrence(x), REC_TOL)


@pytest.mark.parametrize("t,chunk,init", [(50, 16, False), (50, 16, True),
                                          (64, 16, True), (7, 32, True)])
@pytest.mark.parametrize("mode", ["mamba2", "rwkv6"])
def test_plain_gla_ragged_and_initial_state(t, chunk, init, mode):
    """A ragged T pads inertly (the reference's zero padding; the Pallas
    host scan takes whole chunks only, so it joins where T % chunk = 0);
    a nonzero initial state carries into the first chunk."""
    x = _gla_inputs(mode, 2, t, 3, 16, 8, seed=t + 100 * init, init=init)
    got = _port_plain(x, chunk)
    _assert_pair(got, _jnp_chunked(x, chunk), JAX_TOL)
    _assert_pair(got, _recurrence(x), REC_TOL)
    if t % chunk == 0:
        j = _as("jax", x)
        pallas = JOPS.gla_chunked(j["q"], j["k"], j["v"], j["log_decay"],
                                  chunk=chunk, pre=mode == "rwkv6",
                                  bonus=j["bonus"],
                                  initial_state=j["initial_state"])
        _assert_pair(got, tuple(map(np.asarray, pallas)), JAX_TOL)


@pytest.mark.parametrize("mode", ["mamba2", "rwkv6"])
def test_recurrence_matches_reference(mode):
    x = _gla_inputs(mode, 2, 24, 3, 8, 16, seed=7, init=True)
    t = _as("torch", x)
    y, s = TREF.gla_recurrence_ref(t["q"], t["k"], t["v"], t["log_decay"],
                                   bonus=t["bonus"],
                                   initial_state=t["initial_state"])
    _assert_pair((y.numpy(), s.numpy()), _recurrence(x),
                 dict(rtol=1e-6, atol=1e-6))


def test_gla_chunked_routes_cpu_to_plain_and_kernel_refuses_cpu():
    x = _as("torch", _gla_inputs("rwkv6", 1, 40, 2, 8, 8, seed=3))
    args = (x["q"], x["k"], x["v"], x["log_decay"])
    y, s = TSSM.gla_chunked(*args, chunk=16, bonus=x["bonus"])
    yp, sp = TSSM.gla_chunked_plain(*args, chunk=16, bonus=x["bonus"])
    assert torch.equal(y, yp) and torch.equal(s, sp)
    launches = gla_chunk_f32.launches
    with pytest.raises(ValueError, match="not CUDA"):
        gla_chunk_f32(*args, chunk=16, bonus=x["bonus"])
    with pytest.raises(ValueError, match="log_decay"):
        gla_chunk_f32(*args[:3], x["log_decay"][..., :3], chunk=16)
    with pytest.raises(ValueError, match="bonus"):
        gla_chunk_f32(*args, chunk=16, bonus=x["bonus"][:1])
    with pytest.raises(ValueError, match=r"K = 80"):
        q = torch.zeros((1, 4, 2, 80))
        gla_chunk_f32(q, q, q, torch.zeros((1, 4, 2)), chunk=4)
    assert gla_chunk_f32.launches == launches


# ---------------------------------------------------------------------------
# blocks, on the reduced configs with parameters from the reference's init
# ---------------------------------------------------------------------------

def _block_params(name, init_fn, seed):
    """The reference's init of one mixer (f32, reduced config), its f32
    scalars perturbed so that every leaf matters, as numpy and as the
    port's tensors."""
    cfg = jax_get_arch(name).reduced()
    tree = jax.tree.map(np.asarray,
                        init_fn(jax.random.PRNGKey(seed), cfg, jnp.float32))
    rng = np.random.default_rng(seed)
    for leaf in ("A_log", "dt_bias", "bonus_u"):
        if leaf in tree:
            tree[leaf] = (0.3 * rng.normal(size=tree[leaf].shape)
                          ).astype(np.float32)
    if "D" in tree:
        tree["D"] = (1 + 0.3 * rng.normal(size=tree["D"].shape)
                     ).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree)
    return cfg, get_arch(name).reduced(), jp, from_jax_params(tree, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("mode", ["mamba2", "rwkv6"])
def test_gla_step_matches_reference(mode):
    x = _gla_inputs(mode, 2, 1, 3, 8, 16, seed=11, init=True)
    j, t = _as("jax", x), _as("torch", x)
    want = JSSM.gla_step(j["q"][:, 0], j["k"][:, 0], j["v"][:, 0],
                         j["log_decay"][:, 0], j["initial_state"],
                         bonus=j["bonus"])
    got = TSSM.gla_step(t["q"][:, 0], t["k"][:, 0], t["v"][:, 0],
                        t["log_decay"][:, 0], t["initial_state"],
                        bonus=t["bonus"])
    _assert_pair([g.numpy() for g in got], [np.asarray(w) for w in want],
                 dict(rtol=1e-6, atol=1e-6))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    x, w = _x((2, 9, 12), 1), _x((4, 12), 2)
    st = _x((2, 3, 12), 3) if with_state else None
    want = JSSM._causal_conv(jnp.asarray(x), jnp.asarray(w),
                             None if st is None else jnp.asarray(st))
    got = TSSM._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                            None if st is None else torch.from_numpy(st))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("t", [40, 64])
def test_mamba2_block_and_decode_match_reference(t):
    jcfg, tcfg, jp, tp = _block_params("zamba2-7b", JSSM.mamba2_init, 1)
    x = _x((2, t, jcfg.d_model), t)
    want = np.asarray(JSSM.mamba2_block(jp, jcfg, jnp.asarray(x)))
    got = TSSM.mamba2_block(tp, tcfg, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **BLOCK_TOL)
    dm = JSSM.mamba2_dims(jcfg)
    st = _x((2, dm.n_heads, dm.state, dm.head_dim), 5)
    cv = _x((2, dm.conv_width - 1, dm.d_inner + 2 * dm.state), 6)
    want = JSSM.mamba2_decode(jp, jcfg, jnp.asarray(x[:, :1]),
                              jnp.asarray(st), jnp.asarray(cv))
    got = TSSM.mamba2_decode(tp, tcfg, torch.from_numpy(x[:, :1]),
                             torch.from_numpy(st), torch.from_numpy(cv))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)


@pytest.mark.parametrize("t", [40, 64])
def test_rwkv6_block_and_decode_match_reference(t):
    jcfg, tcfg, jp, tp = _block_params("rwkv6-7b", JSSM.rwkv6_init, 2)
    x = _x((2, t, jcfg.d_model), t + 1)
    prev = _x((2, 1, jcfg.d_model), 9)
    want = np.asarray(JSSM.rwkv6_block(jp, jcfg, jnp.asarray(x),
                                       jnp.asarray(prev)))
    got = TSSM.rwkv6_block(tp, tcfg, torch.from_numpy(x),
                           torch.from_numpy(prev)).numpy()
    np.testing.assert_allclose(got, want, **BLOCK_TOL)
    h = jcfg.d_model // jcfg.ssm.head_dim
    st = _x((2, h, jcfg.ssm.head_dim, jcfg.ssm.head_dim), 7)
    want = JSSM.rwkv6_decode(jp, jcfg, jnp.asarray(x[:, :1]),
                             jnp.asarray(st), jnp.asarray(prev))
    got = TSSM.rwkv6_decode(tp, tcfg, torch.from_numpy(x[:, :1]),
                            torch.from_numpy(st), torch.from_numpy(prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **BLOCK_TOL)


def test_mixer_init_matches_reference_in_structure_and_distribution():
    for name, jinit, tinit in (("zamba2-7b", JSSM.mamba2_init,
                                TSSM.mamba2_init),
                               ("rwkv6-7b", JSSM.rwkv6_init,
                                TSSM.rwkv6_init)):
        cfg = dataclasses.replace(get_arch(name).reduced(),
                                  param_dtype="bfloat16")
        want = from_jax_params(jax.tree.map(np.asarray, jinit(
            jax.random.PRNGKey(0), cfg, jnp.bfloat16)), "cpu")
        got = tinit(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
        assert sorted(got) == sorted(want), name
        for k in want:
            assert got[k].shape == want[k].shape, (name, k)
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_allclose(float(got[k].float().std()),
                                       float(want[k].float().std()),
                                       rtol=0.15, atol=1e-6,
                                       err_msg=f"{name} {k}")
            np.testing.assert_allclose(float(got[k].float().mean()),
                                       float(want[k].float().mean()),
                                       atol=0.02, err_msg=f"{name} {k}")
