"""Port parity: the local-step layer of `repro_torch.kernels.local_step`
(im2col, the GEMM with its autograd backward, conv-as-GEMM, 2×2 max pool)
against `repro.kernels.local_step`, run both through the Pallas kernel in
interpret mode (as tests/test_local_step.py runs it) and through the jnp
route, on the same numpy inputs.

On CPU tensors the port's GEMM takes its plain version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.

Tolerances: im2col and max pool are data movement and are exact (max
pool's tie-split gradient to 1 ulp). A GEMM of reduction length K is held
elementwise to K·2⁻²³·(|A|·|B|) — the worst-case bound on the difference
of two f32 sums of K products taken in different orders — which scales
with K as the effect of summation order does. Convolutions, whose products
come in a chain of three, are held to rtol 1e-5 / atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:            # clean env: deterministic example sweep
    from _hypothesis_compat import given, settings, st

from repro.kernels import local_step as JL
from repro_torch.kernels import local_step as TL
from repro_torch.kernels import ref as TR

torch.set_num_threads(2)

# (M, K, N): ragged against the kernel's 64-wide tiles and the reference's
# 128-wide blocks; K = 27 is c1's reduction length (3·3·3)
GEMM_SHAPES = [(1, 1, 1), (65, 27, 64), (37, 50, 13), (130, 129, 70),
               (64, 72, 16)]
# the paper CNN's conv stack at width 8 on an 8×8 image, plus odd channels
CONV_LAYERS = [(3, 8), (8, 16), (16, 32), (5, 7)]


def _rand(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _assert_gemm_close(out, ref, a, b):
    """|out − ref| ≤ K·2⁻²³·(|A|·|B|) elementwise (+ a denormal floor)."""
    k = a.shape[1]
    bound = k * 2.0 ** -23 * (np.abs(a).astype(np.float64)
                              @ np.abs(b).astype(np.float64))
    err = np.abs(np.asarray(out, np.float64) - np.asarray(ref, np.float64))
    assert (err <= bound + 1e-30).all(), float((err - bound).max())


# ---------------------------------------------------------------------------
# im2col
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,k", [((2, 8, 8, 3), 3), ((1, 5, 7, 4), 3),
                                     ((2, 6, 6, 2), 5), ((1, 4, 4, 1), 1)])
def test_im2col_bitwise(shape, k):
    x = _rand(np.random.default_rng(0), *shape)
    ref = JL.im2col(jnp.asarray(x), k)
    out = TL.im2col(torch.from_numpy(x), k)
    assert tuple(out.shape) == ref.shape
    assert np.array_equal(out.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# GEMM: forward and both gradients
# ---------------------------------------------------------------------------

def _jax_gemm(use_pallas):
    return lambda a, b: JL.gemm(a, b, use_pallas=use_pallas, interpret=True)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("m,k,n", GEMM_SHAPES)
def test_gemm_forward_and_grads_match(m, k, n, use_pallas):
    rng = np.random.default_rng(m * 131 + k * 7 + n)
    a, b, g = _rand(rng, m, k), _rand(rng, k, n), _rand(rng, m, n)
    ref, vjp = jax.vjp(_jax_gemm(use_pallas), jnp.asarray(a), jnp.asarray(b))
    ref_da, ref_db = vjp(jnp.asarray(g))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    out = TL.gemm(ta, tb)
    da, db = torch.autograd.grad(out, (ta, tb), torch.from_numpy(g))
    _assert_gemm_close(out.detach().numpy(), np.asarray(ref), a, b)
    _assert_gemm_close(da.numpy(), np.asarray(ref_da), g, b.T)
    _assert_gemm_close(db.numpy(), np.asarray(ref_db), a.T, g)


@given(m=st.integers(1, 70), k=st.integers(1, 70), n=st.integers(1, 70))
@settings(max_examples=20, deadline=None)
def test_gemm_matches_jnp_over_shapes(m, k, n):
    """Property over (M, K, N): the port's GEMM equals the reference's jnp
    route within the K-scaled bound."""
    rng = np.random.default_rng(m * 10007 + k * 101 + n)
    a, b = _rand(rng, m, k), _rand(rng, k, n)
    ref = JL.gemm(jnp.asarray(a), jnp.asarray(b))
    out = TL.gemm(torch.from_numpy(a), torch.from_numpy(b))
    assert tuple(out.shape) == (m, n)
    _assert_gemm_close(out.numpy(), np.asarray(ref), a, b)


def test_gemm_backward_uses_transpose_flags_and_skips_unneeded(monkeypatch):
    """The backward runs the same product route with transpose flags (no
    transposed copies) and skips dA when A needs no gradient — c1's
    im2col of the input images."""
    calls = []
    real = TL._product

    def spy(a, b, trans_a=False, trans_b=False):
        calls.append((tuple(a.shape), tuple(b.shape), trans_a, trans_b))
        return real(a, b, trans_a, trans_b)

    monkeypatch.setattr(TL, "_product", spy)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(_rand(rng, 6, 5))
    b = torch.from_numpy(_rand(rng, 5, 3)).requires_grad_(True)
    TL.gemm(a, b).sum().backward()
    assert calls == [((6, 5), (5, 3), False, False),
                     ((6, 5), (6, 3), True, False)]
    calls.clear()
    a.requires_grad_(True)
    TL.gemm(a, b).sum().backward()
    assert calls[1:] == [((6, 3), (5, 3), False, True),
                         ((6, 5), (6, 3), True, False)]


def test_gemm_routes_by_device_and_counts_only_kernel_launches():
    before = TL.gemm_f32.launches
    a = torch.ones(3, 4)
    TL.gemm(a, torch.ones(4, 2))
    assert TL.gemm_f32.launches == before      # CPU: plain version
    with pytest.raises(ValueError, match="not CUDA"):
        TL.gemm_f32(a, torch.ones(4, 2))
    with pytest.raises(ValueError, match="no route"):
        TL.gemm(a.to("meta"), torch.ones(4, 2, device="meta"))
    assert TL.gemm_f32.launches == before


# ---------------------------------------------------------------------------
# Conv as GEMM, max pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("cin,cout", CONV_LAYERS)
def test_conv2d_gemm_forward_and_grads_match(cin, cout, use_pallas):
    rng = np.random.default_rng(cin * cout)
    x = _rand(rng, 2, 8, 8, cin)
    w = _rand(rng, 3, 3, cin, cout) / np.float32(np.sqrt(9 * cin))
    b = 0.1 * _rand(rng, cout)
    g = _rand(rng, 2, 8, 8, cout)

    def jax_conv(x, w, b):
        return JL.conv2d_gemm(x, w, b, use_pallas=use_pallas, interpret=True)

    ref, vjp = jax.vjp(jax_conv, *map(jnp.asarray, (x, w, b)))
    ref_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(v).requires_grad_(True) for v in (x, w, b)]
    out = TL.conv2d_gemm(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    for name, got, want in zip("xwb", grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # and the independent F.conv2d oracle
    np.testing.assert_allclose(
        out.detach().numpy(),
        TR.conv2d_ref(*map(torch.from_numpy, (x, w, b))).numpy(),
        rtol=1e-5, atol=1e-5)


def test_maxpool2x2_forward_and_tie_split_gradient_match():
    """Values on a coarse grid force ties inside pooling windows; the
    gradient splits evenly over them in both packages."""
    rng = np.random.default_rng(4)
    x = (np.round(rng.normal(size=(2, 8, 8, 3)) * 2) / 2).astype(np.float32)
    g = _rand(rng, 2, 4, 4, 3)
    ref, vjp = jax.vjp(JL.maxpool2x2, jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = TL.maxpool2x2(tx)
    (dx,) = torch.autograd.grad(out, tx, torch.from_numpy(g))
    assert np.array_equal(out.detach().numpy(), np.asarray(ref))
    assert np.array_equal(out.detach().numpy(),
                          TR.maxpool2x2_ref(torch.from_numpy(x)).numpy())
    n_tied = int((np.asarray(ref_dx) != 0).sum()) - g.size
    assert n_tied > 0                       # the input does hold ties
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=2e-7,
                               atol=0)
