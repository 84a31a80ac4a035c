"""The attention backward (`kernels/csrc/flash_attn_bwd_f32.cu`) on the
CPU: its plain versions `ref.attention_bwd_ref` and `ref.attention_lse_ref`
against `jax.grad` of the reference's chunked attention
(`repro.models.layers.flash_attention`, which the reference's LM training
differentiates) and its log-sum-exp, and against torch autograd of
`ref.attention_ref`; a torch emulation of the two CUDA kernels' tiling
(P recomputed from lse, dK/dV a key tile over the group's query rows, dQ
a row tile over the forward's key tiles, both with the kernels' skipping
rules) against the plain version (the f32 kernels); an emulation of
the bf16 kernels' arithmetic (bf16 operands, exact products in f32 sums,
key-major Sᵀ and dPᵀ tiles, P and dS in three bf16 terms, each tile's
product from 0 added into f32 running sums) held to chip_smoke.py phase
10's elementwise bf16 limit against the plain version in f64, with one
and two terms missing it; the CPU route of
`models/layers.flash_attention` under autograd; and the launchers' and
the autograd Function's refusals (the kernels run only on the card).

Tolerances: f32 rtol 1e-5 and atol 1e-6 times the gradient's largest
magnitude (one softmax over ≤ 200 keys and sums of ≤ 800 terms in another
order: each f32 route, this one, jax.grad's and autograd's, reads up to
3e-6 off an f64 computation of the same formulas at max |g| ≈ 9, so a
fixed atol of 1e-6 would hold the small elements of large gradients to
less than the f32 sums' own rounding); the tiling
emulation runs in f64 and must agree to 1e-12 relative (the same
formulas, summed in tiles), where leaving out one (row, key) pair moves a
gradient by ~1e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels.ref import (attention_bwd_ref, attention_lse_ref,
                                     attention_ref)
from repro_torch.models import layers as TL

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * float(np.abs(want).max()))


BQ = BK = 64          # the kernels' tiles (csrc/flash_attn_bwd_f32.cu)

# (b, tq, tk, h, kv, hd, causal, window): causal, windowed, ragged T (a
# partial tile), G = 1, 2 and 4, bidirectional
CASES = [
    (2, 37, 37, 4, 4, 32, True, 0),
    (1, 130, 130, 4, 2, 32, True, 0),
    (2, 96, 96, 8, 2, 64, True, 24),
    (1, 129, 129, 4, 1, 32, True, 48),
    (1, 70, 70, 2, 1, 32, False, 0),
]


def _inputs(b, tq, tk, h, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, tq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, tk, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, tk, kv, hd)).astype(np.float32)
    do = rng.normal(size=(b, tq, h, hd)).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window):
    def loss(q, k, v):
        out = JL.flash_attention(q, k, v, causal=causal, window=window)
        return jnp.sum(out * do)
    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


def _jax_lse(q, k, causal, window):
    """The log-sum-exp of the reference's scaled, masked scores."""
    g = q.shape[2] // k.shape[2]
    kr = jnp.repeat(jnp.asarray(k), g, axis=2)
    s = jnp.einsum("bthd,bshd->bhts", jnp.asarray(q) * q.shape[-1] ** -0.5,
                   kr)
    qp = jnp.arange(q.shape[1])[:, None]
    kp = jnp.arange(k.shape[1])[None, :]
    mask = jnp.ones(s.shape[-2:], bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= qp - kp < window
    return np.asarray(jax.nn.logsumexp(jnp.where(mask, s, JL.NEG_INF), -1))


def _plain(q, k, v, do, causal, window):
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out = attention_ref(*t[:3], causal=causal, window=window)
    lse = attention_lse_ref(t[0], t[1], causal=causal, window=window)
    return out, lse, attention_bwd_ref(*t[:3], out, lse, t[3],
                                       causal=causal, window=window)


def _autograd(q, k, v, do, causal, window, fn=attention_ref):
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, causal=causal, window=window)
    return torch.autograd.grad(out, leaves, torch.from_numpy(do))


@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_jax_grad_and_autograd(case):
    b, tq, tk, h, kv, hd, causal, window = case
    q, k, v, do = _inputs(b, tq, tk, h, kv, hd, seed=tq * h + kv)
    _, lse, got = _plain(q, k, v, do, causal, window)
    _close(lse.numpy(), _jax_lse(q, k, causal, window))
    for g, jg, ag in zip(got, _jax_grads(q, k, v, do, causal, window),
                         _autograd(q, k, v, do, causal, window)):
        assert g.dtype == torch.float32 and g.shape == ag.shape
        _close(g.numpy(), jg)
        _close(g.numpy(), ag.numpy())


def test_fully_masked_rows_give_zeros():
    """Bidirectional with a window and Tq > Tk: queries at 7 and beyond
    see no key (ROADMAP C7). Their lse is +inf, their dq 0, and they add
    nothing to dk and dv: the other rows' gradients are autograd's (and
    jax.grad's) with those rows' dO set to 0."""
    b, tq, tk, h, kv, hd, causal, window = 1, 12, 5, 4, 2, 32, False, 3
    q, k, v, do = _inputs(b, tq, tk, h, kv, hd, seed=7)
    _, lse, (dq, dk, dv) = _plain(q, k, v, do, causal, window)
    dead = slice(7, None)
    assert torch.isinf(lse[:, :, dead]).all() and \
        torch.isfinite(lse[:, :, :7]).all()
    assert (dq[:, dead] == 0).all()
    do_live = do.copy()
    do_live[:, dead] = 0
    want = _autograd(q, k, v, do_live, causal, window)
    jwant = _jax_grads(q, k, v, do_live, causal, window)
    for g, ag, jg in zip((dq[:, :7], dk, dv),
                         (want[0][:, :7], want[1], want[2]),
                         (jwant[0][:, :7], jwant[1], jwant[2])):
        _close(g.numpy(), ag.numpy())
        _close(g.numpy(), jg)


def test_f64_plain_version_and_bf16_inputs():
    """f64 in, f64 out (the card's f32 oracle); bf16 in, f32 out (its bf16
    oracle), equal to the f32 plain version of the bf16 values."""
    q, k, v, do = _inputs(1, 40, 40, 4, 2, 32, seed=3)
    t64 = [torch.from_numpy(x).double() for x in (q, k, v, do)]
    out = attention_ref(*t64[:3])
    lse = attention_lse_ref(t64[0], t64[1])
    assert lse.dtype == torch.float64
    got = attention_bwd_ref(*t64[:3], out, lse, t64[3])
    assert all(g.dtype == torch.float64 for g in got)
    _, _, want = _plain(q, k, v, do, True, 0)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())
    tb = [torch.from_numpy(x).bfloat16() for x in (q, k, v, do)]
    out_b = attention_ref(*tb[:3])
    lse_b = attention_lse_ref(tb[0], tb[1])
    got_b = attention_bwd_ref(*tb[:3], out_b, lse_b, tb[3])
    want_b = attention_bwd_ref(*(x.float() for x in tb[:3]), out_b.float(),
                               lse_b, tb[3].float())
    for g, w in zip(got_b, want_b):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the CUDA kernels' tiling, emulated
# ---------------------------------------------------------------------------

def _valid(qp, kp, tk, causal, window):
    ok = (qp[:, None] >= 0) & (kp[None, :] < tk)
    if causal:
        ok &= qp[:, None] >= kp[None, :]
    if window > 0:
        ok &= qp[:, None] - kp[None, :] < window
    return ok


def _tile(rows, r0, k0, ctx):
    """One (row tile, key tile) step of both kernels: P and dS of the
    tile's BQ rows × BK keys, and the rows' scaled Q and dO."""
    q, k, v, do, lse, delta, b, kvh, g, causal, window = ctx
    tq, h, hd = q.shape[1], q.shape[2], q.shape[3]
    tk = k.shape[1]
    r = torch.arange(r0, r0 + BQ)
    live = r < rows
    rr = torch.where(live, r, 0)
    pos, head = rr // g, kvh * g + rr % g
    qs = torch.where(live[:, None], q[b, pos, head] * hd ** -0.5, 0.0)
    dos = torch.where(live[:, None], do[b, pos, head], 0.0)
    kp = torch.arange(k0, k0 + BK)
    kk = torch.where((kp < tk)[:, None], k[b, kp.clamp(max=tk - 1), kvh], 0.)
    vv = torch.where((kp < tk)[:, None], v[b, kp.clamp(max=tk - 1), kvh], 0.)
    s = qs @ kk.T
    valid = _valid(torch.where(live, pos, -1), kp, tk, causal, window)
    p = torch.where(valid, torch.exp(s - lse[b, head, pos][:, None]), 0.0)
    ds = p * (dos @ vv.T - delta[b, head, pos][:, None])
    return p, ds, qs, dos, kk, live, pos, head


def _emulated_backward(q, k, v, out, do, lse, causal, window):
    """dq, dk, dv as the kernels compute them (f64 here): Δ, then the dK/dV
    blocks over their query-row range and the dQ blocks over the forward's
    key-tile range, each tile's sum added to the running one."""
    bsz, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    rows = tq * g
    delta = (do * out).sum(-1).transpose(1, 2)              # (B, H, Tq)
    dq, dk, dv = (torch.zeros_like(t) for t in (q, k, v))
    n_kt = -(-tk // BK)
    for b in range(bsz):
        for kvh in range(kv):
            ctx = (q, k, v, do, lse, delta, b, kvh, g, causal, window)
            for kt in range(n_kt):                           # dK/dV blocks
                k0 = kt * BK
                k_last = min(k0 + BK, tk) - 1
                q_lo = k0 if causal else 0
                q_hi = (min(tq - 1, k_last + window - 1) if window > 0
                        else tq - 1)
                acc_k = torch.zeros(BK, hd, dtype=q.dtype)
                acc_v = torch.zeros(BK, hd, dtype=q.dtype)
                for r0 in range(q_lo * g, min(rows, (q_hi + 1) * g), BQ):
                    p, ds, qs, dos, *_ = _tile(rows, r0, k0, ctx)
                    acc_v += p.T @ dos
                    acc_k += ds.T @ qs
                n = min(BK, tk - k0)
                dk[b, k0:k0 + n, kvh] = acc_k[:n]
                dv[b, k0:k0 + n, kvh] = acc_v[:n]
            for r0 in range(0, rows, BQ):                    # dQ blocks
                q_first = r0 // g
                q_last = (min(r0 + BQ, rows) - 1) // g
                kt_end = min(n_kt, q_last // BK + 1) if causal else n_kt
                kt_begin = (max(0, q_first - window + 1) // BK
                            if window > 0 else 0)
                acc = torch.zeros(BQ, hd, dtype=q.dtype)
                for kt in range(kt_begin, kt_end):
                    _, ds, _, _, kk, live, pos, head = _tile(rows, r0,
                                                             kt * BK, ctx)
                    acc += ds @ kk
                dq[b, pos[live], head[live]] = hd ** -0.5 * acc[live]
    return dq, dk, dv


@pytest.mark.parametrize("case", CASES + [(1, 12, 5, 4, 2, 32, False, 3),
                                          (1, 200, 200, 8, 2, 32, True, 48)])
def test_kernel_tiling_emulation_matches_plain(case):
    b, tq, tk, h, kv, hd, causal, window = case
    q, k, v, do = (torch.from_numpy(x).double()
                   for x in _inputs(b, tq, tk, h, kv, hd, seed=11))
    out = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    want = attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                             window=window)
    got = _emulated_backward(q, k, v, out, do, lse, causal, window)
    for g, w in zip(got, want):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-12 * scale


# ---------------------------------------------------------------------------
# the model's route and the kernels' refusals on the CPU
# ---------------------------------------------------------------------------

def test_cpu_route_under_autograd_matches_plain_backward():
    """`layers.flash_attention` on CPU tensors that require grad runs the
    chunked formulation under autograd (kv blocks of 32 here, so the
    online softmax spans several); its gradient is the plain version's."""
    b, tq, tk, h, kv, hd, causal, window = 1, 100, 100, 4, 2, 32, True, 40
    q, k, v, do = _inputs(b, tq, tk, h, kv, hd, seed=5)
    _, _, want = _plain(q, k, v, do, causal, window)

    def chunked(q, k, v, causal, window):
        return TL.flash_attention(q, k, v, causal=causal, window=window,
                                  kv_block=32)
    got = _autograd(q, k, v, do, causal, window, fn=chunked)
    for g, w in zip(got, want):
        _close(g.numpy(), w.numpy())


def test_launchers_and_function_refuse_what_the_kernels_cannot_take():
    q = torch.zeros(1, 8, 2, 32)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.flash_attn_bwd_f32(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="not CUDA"):
        FA.flash_attn_f32(q, q, q, return_lse=True)
    with pytest.raises(ValueError, match="lse must be f32"):
        FA.flash_attn_bwd_f32(q, q, q, q, lse[..., :4], q)
    with pytest.raises(NotImplementedError, match="FlashAttention.apply"):
        FA.flash_attn_f32(q.clone().requires_grad_(True), q, q)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch.func.vmap(lambda x: FA.FlashAttention.apply(
            x, x, x, True, 0)[0])(q[None].expand(2, -1, -1, -1, -1))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch.func.vmap(lambda x: FA.flash_attn_bwd_f32(
            x, x, x, x, lse, x))(q[None].expand(2, -1, -1, -1, -1))
    assert FA.flash_attn_bwd_f32.launches == 0


# ---------------------------------------------------------------------------
# the bf16 route's arithmetic, emulated
# ---------------------------------------------------------------------------

def _bf16_limit_share(got, q, k, v, out, lse, do, causal, window):
    """chip_smoke.py phase 10's bf16 limit, elementwise and unchanged:
    |got − want64| ≤ 2⁻⁸·max(|want64|, |want32|) + 1e-6 + |want32 −
    want64|, with want64 the plain version on the bf16 inputs in f64 and
    want32 the same in f32. Returns each gradient's worst share of it."""
    mask = dict(causal=causal, window=window)
    want64 = attention_bwd_ref(q.double(), k.double(), v.double(),
                               out.double(), lse.double(), do.double(),
                               **mask)
    want32 = attention_bwd_ref(q, k, v, out, lse, do, **mask)
    shares = []
    for g, w64, w32 in zip(got, want64, want32):
        w32 = w32.double()
        limit = 2.0 ** -8 * torch.maximum(w64.abs(), w32.abs()) + 1e-6 \
            + (w32 - w64).abs()
        shares.append(float(((g.double() - w64).abs() / limit).max()))
    return shares


def _terms(x, n):
    """x (f32) as n bf16 terms, each the bf16 rounding of what the earlier
    ones leave (the kernel's split3 for n = 3), widened to f32."""
    out, rest = [], x
    for _ in range(n):
        term = rest.bfloat16().float()
        out.append(term)
        rest = rest - term
    return out


def _tile_product(x, b, n_terms):
    """A tile's product from 0: x in `n_terms` bf16 terms times the bf16
    B (exact products, f32 sums)."""
    t = torch.zeros(x.shape[:-1] + b.shape[-1:])
    for term in _terms(x, n_terms):
        t = t + term @ b
    return t


def _chunked_scores(a, b):
    """a·bᵀ over the head dim as the bf16 kernels sum S and dP: each
    16-wide chunk's products (exact) summed from 0, the chunks added in
    f32 in order."""
    s = a[..., :16] @ b[..., :16].transpose(-1, -2)
    for c in range(16, a.shape[-1], 16):
        s = s + a[..., c:c + 16] @ b[..., c:c + 16].transpose(-1, -2)
    return s


def _grouped(x, kv):
    """(B, T, H, ·) → (B, KV, T·G, ·): row r of kv head j is position
    r // G of query head j·G + r % G, the kernels' position-major rows."""
    b, t, h = x.shape[:3]
    g = h // kv
    return x.reshape(b, t, kv, g, -1).permute(0, 2, 1, 3, 4).reshape(
        b, kv, t * g, -1)


def _emulated_bf16_backward(q, k, v, out, do, lse, causal, window,
                            n_terms=3):
    """dq, dk, dv as the bf16 kernels compute them: bf16 operands (exact
    products in f32 sums; S and dP by 16-wide chunks of the head dim),
    scores scaled after the product, key-major Sᵀ
    and dPᵀ tiles in the dK/dV pass (64 keys × 64 rows; 32 rows past hd
    64) and row-major S, dP tiles in the dQ pass (64 rows × 64 keys), P
    and dS in `n_terms` bf16 terms, each tile's product from 0 added into
    f32 running sums, dK and dQ scaled once at the end, every gradient
    rounded to bf16 once."""
    bsz, tq, h, hd = q.shape
    tk, kv = k.shape[1], k.shape[2]
    g = h // kv
    rows = tq * g
    scale = float(np.float32(hd ** -0.5))
    rt = 64 if hd <= 64 else 32
    delta = (do.float() * out.float()).sum(-1)               # (B, Tq, H)
    qg, dog = _grouped(q.float(), kv), _grouped(do.float(), kv)
    lg = _grouped(lse.transpose(1, 2)[..., None], kv)[..., 0]
    dg = _grouped(delta[..., None], kv)[..., 0]
    kf, vf = (x.float().transpose(1, 2) for x in (k, v))    # (B, KV, Tk, hd)
    pos = torch.arange(rows) // g

    def tile(r0, nr, k0):
        """P and dS (nr rows × 64 keys) of one tile, masked; rows past the
        last and keys past Tk read 0."""
        r = torch.arange(r0, r0 + nr)
        kp = torch.arange(k0, k0 + BK)
        qt, dot = (torch.zeros(bsz, kv, nr, hd) for _ in range(2))
        lt, dt = torch.zeros(bsz, kv, nr), torch.zeros(bsz, kv, nr)
        live = r < rows
        qt[:, :, live], dot[:, :, live] = qg[:, :, r[live]], dog[:, :, r[live]]
        lt[:, :, live], dt[:, :, live] = lg[:, :, r[live]], dg[:, :, r[live]]
        kt, vt = (torch.zeros(bsz, kv, BK, hd) for _ in range(2))
        kl = kp < tk
        kt[:, :, kl], vt[:, :, kl] = kf[:, :, kp[kl]], vf[:, :, kp[kl]]
        valid = _valid(torch.where(live, pos[r.clamp(max=rows - 1)], -1),
                       kp, tk, causal, window)
        return qt, dot, lt, dt, kt, vt, valid

    def p_ds(s, dp, lt, dt, valid):
        p = torch.where(valid, torch.exp(s * scale - lt[..., None]), 0.0)
        return p, p * (dp - dt[..., None])

    dk = torch.zeros(bsz, kv, tk, hd)
    dv = torch.zeros(bsz, kv, tk, hd)
    for k0 in range(0, tk, BK):                              # dK/dV blocks
        k_last = min(k0 + BK, tk) - 1
        q_lo = k0 if causal else 0
        q_hi = min(tq - 1, k_last + window - 1) if window > 0 else tq - 1
        acc_k, acc_v = torch.zeros(bsz, kv, BK, hd), torch.zeros(bsz, kv,
                                                                 BK, hd)
        for r0 in range(q_lo * g, min(rows, (q_hi + 1) * g), rt):
            qt, dot, lt, dt, kt, vt, valid = tile(r0, rt, k0)
            st, dpt = _chunked_scores(kt, qt), _chunked_scores(vt, dot)
            p, ds = p_ds(st.transpose(-1, -2), dpt.transpose(-1, -2), lt,
                         dt, valid)
            acc_v = acc_v + _tile_product(p.transpose(-1, -2), dot, n_terms)
            acc_k = acc_k + _tile_product(ds.transpose(-1, -2), qt, n_terms)
        n = min(BK, tk - k0)
        dk[:, :, k0:k0 + n] = scale * acc_k[:, :, :n]
        dv[:, :, k0:k0 + n] = acc_v[:, :, :n]
    dq = torch.zeros(bsz, kv, rows, hd)
    n_kt = -(-tk // BK)
    for r0 in range(0, rows, BQ):                            # dQ blocks
        q_first, q_last = r0 // g, (min(r0 + BQ, rows) - 1) // g
        kt_end = min(n_kt, q_last // BK + 1) if causal else n_kt
        kt_begin = max(0, q_first - window + 1) // BK if window > 0 else 0
        acc = torch.zeros(bsz, kv, BQ, hd)
        for kt_ in range(kt_begin, kt_end):
            qt, dot, lt, dt, kt, vt, valid = tile(r0, BQ, kt_ * BK)
            _, ds = p_ds(_chunked_scores(qt, kt), _chunked_scores(dot, vt),
                         lt, dt, valid)
            acc = acc + _tile_product(ds, kt, n_terms)
        n = min(BQ, rows - r0)
        dq[:, :, r0:r0 + n] = scale * acc[:, :, :n]
    dq = dq.reshape(bsz, kv, tq, g, hd).permute(0, 2, 1, 3, 4).reshape(
        bsz, tq, h, hd)
    return (dq.bfloat16(), dk.transpose(1, 2).bfloat16(),
            dv.transpose(1, 2).bfloat16())


# (b, tq, tk, h, kv, hd, causal, window): groups 1, 4 and 8; T ragged on
# both sides of a 64-key tile (and of the 64-row tiles: 63·4, 65·4, 129·8
# rows); a window; bidirectional; rows with no valid key (Tq > Tk with a
# window: lse = +inf)
BF16_CASES = {
    "g1_t63": (2, 63, 63, 4, 4, 32, True, 0),
    "g4_t65": (1, 65, 65, 8, 2, 64, True, 0),
    "g4_t127": (1, 127, 127, 8, 2, 64, True, 0),
    "g8_t129_window": (1, 129, 129, 16, 2, 32, True, 40),
    "g4_bidirectional": (1, 70, 70, 8, 2, 64, False, 0),
    "g2_dead_rows": (1, 12, 5, 4, 2, 32, False, 3),
}


def _bf16_inputs(case, seed):
    b, tq, tk, h, kv, hd, causal, window = case
    q, k, v, do = (torch.from_numpy(x).bfloat16()
                   for x in _inputs(b, tq, tk, h, kv, hd, seed))
    if tq != tk:
        rng = np.random.default_rng(seed + 1)
        k, v = (torch.from_numpy(rng.normal(size=(b, tk, kv, hd)).astype(
            np.float32)).bfloat16() for _ in range(2))
    out = attention_ref(q, k, v, causal=causal, window=window)
    lse = attention_lse_ref(q, k, causal=causal, window=window)
    return q, k, v, out, lse, do


@pytest.mark.parametrize("name", list(BF16_CASES))
def test_bf16_route_emulation_within_phase10_limit(name):
    """The bf16 kernels' arithmetic (P and dS in three bf16 terms) meets
    phase 10's bf16 limit at every element of dq, dk and dv."""
    case = BF16_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, out, lse, do = _bf16_inputs(case, seed=len(name))
    assert out.dtype == torch.bfloat16
    got = _emulated_bf16_backward(q, k, v, out, do, lse, causal, window)
    for g, t in zip(got, (q, k, v)):
        assert g.shape == t.shape and g.dtype == torch.bfloat16
        assert torch.isfinite(g.float()).all()
    shares = _bf16_limit_share(got, q, k, v, out, lse, do, causal, window)
    assert max(shares) <= 1.0, shares


@pytest.mark.parametrize("name", ["g4_t127", "g8_t129_window"])
def test_p_and_ds_in_fewer_terms_miss_phase10_limit(name):
    """FlashAttention-2's rounding of P and dS to bf16 before the products
    misses the limit by far, and a two-term split misses it too: three
    terms are the fewest that carry P and dS as an f32 would."""
    case = BF16_CASES[name]
    causal, window = case[6], case[7]
    q, k, v, out, lse, do = _bf16_inputs(case, seed=len(name))
    worst = {n: max(_bf16_limit_share(
        _emulated_bf16_backward(q, k, v, out, do, lse, causal, window,
                                n_terms=n), q, k, v, out, lse, do, causal,
        window)) for n in (1, 2, 3)}
    assert worst[1] > 100 and worst[2] > 1.0 >= worst[3], worst
