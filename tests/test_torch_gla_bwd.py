"""The GLA backward (`models/ssm.gla_chunked_bwd_plain`, the plain version
of csrc/gla_chunk_bwd_f32.cu) and its autograd Function
(`kernels/chunk_scan.GLAChunked`) against the JAX reference: the same
numpy inputs through `jax.grad` of the reference's `models.ssm.
gla_chunked`, through autograd of the port's `gla_chunked_plain`, and
through emulations of the kernel's two routes: the FFMA route's pass
order and tiles, and the tensor-core route's arithmetic (bf16 inputs,
three-term splits, k16 steps summed from zeroed accumulators).

The kernel runs only on the card (`chip_smoke.py` phase 13 (b)); here its
launcher must refuse what it cannot take, and the Function is driven on
the CPU with its two launchers replaced by their plain versions.

Tolerances, normwise (chip_smoke.py phase 13 (b)'s f32 limits; L the
chunk, K the key width, B·T the tokens): dq, dk and dv L·K·2⁻²³ (sums of
up to L·K f32 terms taken in another order), and d log_decay the same
(its reverse sum runs over one chunk's tokens, later chunks entering as
one ⟨dS, S⟩); d bonus (L·K + B·T)·2⁻²³ (a sum over B·T tokens). d log_decay is held normwise
only: under a zero initial state its first token's exact 0 is a rounding
residue in every route. With bf16 inputs (the tensor-core route) dq, dk
and dv add one bf16 rounding (2⁻⁸); d log_decay keeps L·K·2⁻²³."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JSSM
from repro_torch.kernels import chunk_scan
from repro_torch.models import ssm as TSSM
# the forward's emulation of the tensor cores: three-term bf16 splits and
# their products summed in f32
from test_torch_gla_chunked_form import tc_mm

torch.set_num_threads(2)

GRADS = ("dq", "dk", "dv", "dlog_decay", "dbonus")
TILE = 32        # the FFMA route's row tiles (csrc QR)

# (name, B, T, H, K, V, chunk, per-channel, pre, initial state, strong,
#  q and k shared over the heads)
CASES = [
    ("rwkv6-like", 2, 64, 2, 16, 16, 16, True, True, False, False, False),
    ("rwkv6-ragged-s0", 1, 50, 2, 8, 12, 16, True, True, True, False,
     False),
    ("rwkv6-strong", 1, 64, 2, 16, 16, 32, True, True, True, True, False),
    ("mamba2-like", 2, 96, 3, 16, 16, 32, False, False, False, False,
     True),
    ("mamba2-ragged-s0", 1, 70, 2, 8, 16, 64, False, False, True, False,
     True),
    ("mamba2-strong", 1, 64, 2, 16, 16, 64, False, False, True, True,
     True),
    ("scalar-pre", 1, 40, 2, 8, 8, 16, False, True, True, False, False),
    ("per-channel-post", 1, 40, 2, 8, 8, 16, True, False, False, False,
     False),
]
IDS = [c[0] for c in CASES]


def _inputs(seed, b, t, h, kd, vd, per_channel, pre, init, strong,
            shared_qk):
    """numpy inputs as the models make them (chip_smoke phase 13): q, k,
    v, dy ~ N(0, 1); per-channel log decay −exp(N − 1), scalar
    −softplus(N); strong decay −exp(min(1.5·N + 1.5, 3)) per channel and
    −exp(min(N + 2, 3)) per head; `shared_qk` draws q and k once for all
    heads, (B, T, 1, K)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    qh = 1 if shared_qk else h
    x = dict(q=rng.normal(size=(b, t, qh, kd)).astype(f32),
             k=rng.normal(size=(b, t, qh, kd)).astype(f32),
             v=rng.normal(size=(b, t, h, vd)).astype(f32))
    z = rng.normal(size=(b, t, h, kd) if per_channel else (b, t, h))
    if strong:
        z = np.minimum(1.5 * z + 1.5 if per_channel else z + 2.0, 3.0)
        x["log_decay"] = (-np.exp(z)).astype(f32)
    elif per_channel:
        x["log_decay"] = (-np.exp(z - 1.0)).astype(f32)
    else:
        x["log_decay"] = (-np.logaddexp(0, z)).astype(f32)
    x["bonus"] = (np.exp(0.1 * rng.normal(size=(h, kd))).astype(f32)
                  if pre else None)
    x["initial_state"] = (rng.normal(size=(b, h, kd, vd)).astype(f32)
                          if init else None)
    x["dy"] = rng.normal(size=(b, t, h, vd)).astype(f32)
    return x


def _case_inputs(case):
    (name, b, t, h, kd, vd, chunk, per_channel, pre, init, strong,
     shared) = case
    x = _inputs(sum(map(ord, name)), b, t, h, kd, vd, per_channel, pre,
                init, strong, shared)
    return x, chunk, h


def _torch(x, h, dtype=torch.float32):
    """The port's tensors: q and k broadcast over the h heads where drawn
    once (stride 0, as `_mamba2_qkvd` makes them)."""
    out = {}
    for name, val in x.items():
        if val is None:
            out[name] = None
            continue
        t = torch.from_numpy(val).to(dtype)
        if name in ("q", "k") and t.shape[2] == 1:
            t = t.expand(t.shape[0], t.shape[1], h, t.shape[3])
        out[name] = t
    return out


def _head_sum(g, x):
    """A (B, T, H, K) gradient summed back over the heads where the
    input was drawn once (autograd's sum for the broadcast)."""
    return g.sum(2, keepdim=True) if x.shape[2] == 1 else g


def _tols(x, chunk):
    b, t, _, kd = x["q"].shape
    chunk = min(chunk, t)
    qkv = chunk * kd * 2.0 ** -23
    return dict(dq=qkv, dk=qkv, dv=qkv, dlog_decay=qkv,
                dbonus=(chunk * kd + b * t) * 2.0 ** -23)


def _normwise(a, b):
    a = torch.as_tensor(np.array(a)).double()
    b = torch.as_tensor(np.array(b)).double()
    return float((a - b).norm() / b.norm())


def _jax_grads(x, chunk, h):
    """jax.grad of Σ dy ⊙ y of the reference's jnp `gla_chunked` (q and k
    broadcast over the heads inside the function where drawn once)."""
    pre = x["bonus"] is not None
    s0 = None if x["initial_state"] is None else \
        jnp.asarray(x["initial_state"])
    dy = jnp.asarray(x["dy"])

    def loss(q, k, v, ld, bonus):
        if q.shape[2] == 1:
            q = jnp.broadcast_to(q, q.shape[:2] + (h,) + q.shape[3:])
            k = jnp.broadcast_to(k, k.shape[:2] + (h,) + k.shape[3:])
        y, _ = JSSM.gla_chunked(q, k, v, ld, chunk=chunk,
                                bonus=bonus if pre else None,
                                initial_state=s0)
        return jnp.sum(y * dy)
    args = [jnp.asarray(x[n]) for n in ("q", "k", "v", "log_decay")]
    args.append(jnp.asarray(x["bonus"]) if pre else jnp.zeros(()))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*args)
    return [np.asarray(g) for g in grads[:4]] + \
        [np.asarray(grads[4]) if pre else None]


def _plain_bwd(x, chunk, h, dtype=torch.float32):
    """`gla_chunked_bwd_plain` on the port's tensors, dq and dk summed back
    over broadcast heads."""
    t = _torch(x, h, dtype)
    got = TSSM.gla_chunked_bwd_plain(
        t["q"], t["k"], t["v"], t["log_decay"], t["dy"], chunk=chunk,
        bonus=t["bonus"], initial_state=t["initial_state"])
    return [_head_sum(got[0], x["q"]), _head_sum(got[1], x["k"]),
            *got[2:]]


def _hold(got, want, tols, label):
    for g, a, w in zip(GRADS, got, want):
        if w is None:
            assert a is None, f"{label}: {g} should be None"
            continue
        err = _normwise(a, w)
        assert err <= tols[g], f"{label}: {g} {err:.3e} > {tols[g]:.3e}"


# ---------------------------------------------------------------------------
# the plain backward against the references
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_bwd_matches_jax_grad(case):
    """Both conventions, scalar and per-channel decay, the bonus, ragged T,
    a nonzero initial state, strong decay, q and k broadcast over heads:
    the plain backward against jax.grad of the reference's chunked GLA."""
    x, chunk, h = _case_inputs(case)
    _hold(_plain_bwd(x, chunk, h), _jax_grads(x, chunk, h),
          _tols(x, chunk), case[0])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_bwd_matches_torch_autograd(case):
    """The plain backward against torch.autograd of `gla_chunked_plain` (the
    CPU route's gradient), on the same tensors."""
    x, chunk, h = _case_inputs(case)
    t = {k: None if v is None else torch.from_numpy(v).requires_grad_(
        k not in ("dy", "initial_state")) for k, v in x.items()}
    q, k = (t[n].expand(t[n].shape[0], t[n].shape[1], h, t[n].shape[3])
            for n in ("q", "k"))
    y, _ = TSSM.gla_chunked_plain(q, k, t["v"], t["log_decay"], chunk=chunk,
                                  bonus=t["bonus"],
                                  initial_state=t["initial_state"])
    leaves = [t[n] for n in ("q", "k", "v", "log_decay", "bonus")
              if t[n] is not None]
    want = list(torch.autograd.grad((y * t["dy"]).sum(), leaves))
    if t["bonus"] is None:
        want.append(None)
    _hold(_plain_bwd(x, chunk, h), want, _tols(x, chunk), case[0])


def test_plain_bwd_f64_is_the_oracle():
    """Given f64 inputs the plain backward computes in f64 (the card's
    oracle for the kernel's f32 route): f64 outputs, and the f32 route
    within its limits of them."""
    case = CASES[0]
    x, chunk, h = _case_inputs(case)
    f64 = _plain_bwd(x, chunk, h, torch.float64)
    assert all(g.dtype == torch.float64 for g in f64)
    _hold(_plain_bwd(x, chunk, h), f64, _tols(x, chunk), "f32 vs f64")


def test_states_plain_are_the_forwards_entering_states():
    """`gla_chunk_states_plain` (the layout the forward kernel's workspace
    hands to the backward, (B·H, chunks, K, V)) holds the state each chunk
    enters with: chunk c's is the plain forward's final state after c
    chunks, and passing it as `states` changes no gradient."""
    x, chunk, h = _case_inputs(CASES[1])
    t = _torch(x, h)
    b, tl = x["q"].shape[:2]
    states = TSSM.gla_chunk_states_plain(t["k"], t["v"], t["log_decay"],
                                         chunk=chunk,
                                         initial_state=t["initial_state"])
    n = -(-tl // chunk)
    assert states.shape == (b * h, n, x["q"].shape[3], x["v"].shape[3])
    for c in range(n):
        if c == 0:
            want = t["initial_state"]
        else:
            _, want = TSSM.gla_chunked_plain(
                t["q"][:, :c * chunk], t["k"][:, :c * chunk],
                t["v"][:, :c * chunk], t["log_decay"][:, :c * chunk],
                chunk=chunk, bonus=t["bonus"],
                initial_state=t["initial_state"])
        torch.testing.assert_close(
            states[:, c].reshape(want.shape), want, rtol=1e-6, atol=1e-6)
    a = TSSM.gla_chunked_bwd_plain(
        t["q"], t["k"], t["v"], t["log_decay"], t["dy"], chunk=chunk,
        bonus=t["bonus"], initial_state=t["initial_state"])
    bb = TSSM.gla_chunked_bwd_plain(
        t["q"], t["k"], t["v"], t["log_decay"], t["dy"], chunk=chunk,
        bonus=t["bonus"], states=states)
    assert all(torch.equal(u, w) for u, w in zip(a, bb))


def test_first_token_decay_gradient_is_a_residue():
    """Under "post" from a zero state the first token's decay multiplies an
    empty state: its exact gradient is 0, and every route leaves only a
    rounding residue there, far below the gradient's scale."""
    x, chunk, h = _case_inputs(CASES[3])
    dld = _plain_bwd(x, chunk, h)[3]
    scale = float(dld.abs().max())
    assert float(dld[:, 0].abs().max()) <= 1e-4 * scale
    f64 = _plain_bwd(x, chunk, h, torch.float64)[3]
    assert float(f64[:, 0].abs().max()) <= 1e-12 * scale


def test_bonus_terms_stay_out_of_the_decay_gradient():
    """Under "pre" the bonus diagonal does not depend on the decay: scaling
    the bonus changes dq, dk, dv and d bonus but leaves d log_decay as it
    was (up to rounding)."""
    x, chunk, h = _case_inputs(CASES[0])
    base = _plain_bwd(x, chunk, h, torch.float64)
    x2 = dict(x, bonus=(3.0 * x["bonus"]).astype(np.float32))
    moved = _plain_bwd(x2, chunk, h, torch.float64)
    assert _normwise(moved[3], base[3]) <= 1e-12
    assert _normwise(moved[0], base[0]) > 1e-3


def _running_sum_control(dld):
    """d log_decay as a running sum over all T tokens in f32 would give
    it: ∂/∂G_t = d log_decay_t − d log_decay_{t+1} from `dld`, rounded to
    f32 and summed back from the end (numpy's sequential accumulate;
    torch's CPU cumsum accumulates in f64). Phase 13 (b) of chip_smoke.py
    holds the kernel's decay sum against the same control."""
    dg = dld - torch.cat([dld[:, 1:], torch.zeros_like(dld[:, :1])], 1)
    return torch.from_numpy(np.flip(np.cumsum(
        np.flip(dg.float().numpy(), 1), 1, dtype=np.float32), 1).copy())


def test_decay_gradient_summed_over_the_sequence():
    """Mamba2's A_log gradient sums the decay gradient over every token
    (d A_log ∝ Σ_t dt_t · d log_decay_t). The plain backward (and the
    kernel) take the part of d log_decay_t from later chunks as
    ⟨dS_{c+1}, S_{c+1}⟩: that sum stays within (L + V + T/L)·2⁻²³ of f64
    at a full-length 4,096-token call, and within half the error of a
    running sum of ∂/∂G over all T tokens in f32 (the card's check),
    which misses the first bound."""
    b, t, h, kd, vd, chunk = 2, 4096, 4, 16, 32, 32
    rng = np.random.default_rng(29)
    f32 = np.float32
    q = torch.from_numpy(rng.normal(size=(b, t, 1, kd)).astype(f32))
    k = torch.from_numpy(rng.normal(size=(b, t, 1, kd)).astype(f32))
    q, k = q.expand(b, t, h, kd), k.expand(b, t, h, kd)
    v = torch.from_numpy(rng.normal(size=(b, t, h, vd)).astype(f32))
    dt = torch.from_numpy(np.logaddexp(0, rng.normal(size=(b, t, h)))
                          .astype(f32))
    dy = torch.from_numpy(rng.normal(size=(b, t, h, vd)).astype(f32))
    want = TSSM.gla_chunked_bwd_plain(
        *(x.double() for x in (q, k, v, -dt, dy)), chunk=chunk)[3]
    got = TSSM.gla_chunked_bwd_plain(q, k, v, -dt, dy, chunk=chunk)[3]
    serial = _running_sum_control(want)

    def summed(g):
        return (g.double() * dt.double()).sum((0, 1))
    bound = (chunk + vd + t // chunk) * 2.0 ** -23
    err, control = (_normwise(summed(g), summed(want))
                    for g in (got, serial))
    assert err <= bound
    assert control > bound
    assert err <= 0.5 * control


@pytest.mark.parametrize("case", [
    ("rwkv6-train", 2, 32, True, True),
    ("zamba2-train", 16, 128, False, False)], ids=lambda c: c[0])
def test_decay_sum_within_half_a_running_sum_at_the_training_calls(case):
    """Phase 13 (b)'s check of the decay's sum over the sequence, at its
    two training layer calls (2 × 4,096 tokens, K = V = 64; rwkv6 L 32 per
    channel with the bonus, zamba2 L 128 scalar with q and k shared) cut
    to 2 and 16 heads (zamba2's scalar decay gives one sum a head: 16
    keep its norm from resting on a few): Σ_t d log_decay for each (b, h)
    and channel of the plain backward, which sums in the kernel's order,
    is within half the normwise error of the running-sum control made
    from its own ∂/∂G."""
    name, h, chunk, per_channel, pre = case
    x = _inputs(sum(map(ord, name)), 2, 4096, h, 64, 64, per_channel, pre,
                False, False, not per_channel)

    def dld(dtype):
        t = _torch(x, h, dtype)
        return TSSM.gla_chunked_bwd_plain(
            t["q"], t["k"], t["v"], t["log_decay"], t["dy"], chunk=chunk,
            bonus=t["bonus"])[3]
    got, want = dld(torch.float32), dld(torch.float64)
    total = want.sum(1)
    err = _normwise(got.double().sum(1), total)
    control = _normwise(_running_sum_control(got).double().sum(1), total)
    assert err <= 0.5 * control, (err, control)


# ---------------------------------------------------------------------------
# emulations of the kernel's passes
# ---------------------------------------------------------------------------

BLOCK = 16       # the tensor-core route's row blocks and k16 steps
DEC_THREADS = 256  # the decay pass's threads (the scalar carry's partials)


def _fmaf(a, b, c):
    """fmaf on f32 tensors: the exact product (f64 holds it), one sum,
    rounded to f32."""
    return (a.double() * b.double() + c.double()).float()


def scan_serial(qc, dc):
    """The dS scan as one block a (b, h) ran it: each thread a 4 × 4 piece
    of K × V, the chunks in its outer loop from the last; g ← fmaf(e^{lc_L},
    g, Q_c). qc (BH, chunks, K, V), dc (BH, chunks, K) f32 → the dS each
    chunk leaves with, (BH, chunks, K, V)."""
    bh, nc, kd, vd = qc.shape
    out = torch.empty_like(qc)
    for x in range(bh):
        for k0 in range(0, kd, 4):
            for v0 in range(0, vd, 4):
                g = torch.zeros(min(4, kd - k0), min(4, vd - v0))
                for c in reversed(range(nc)):
                    q = qc[x, c, k0:k0 + 4, v0:v0 + 4]
                    out[x, c, k0:k0 + 4, v0:v0 + 4] = g
                    g = _fmaf(dc[x, c, k0:k0 + 4, None], g, q)
    return out


def scan_elementwise(qc, dc):
    """The element-parallel dS scan: a thread an element (k, v), the next
    chunk's Q_c and decay loaded before this chunk's fmaf (all elements at
    once here, each its own chain)."""
    bh, nc, kd, vd = qc.shape
    out = torch.empty_like(qc)
    g = torch.zeros(bh, kd, vd)
    q, d = qc[:, nc - 1], dc[:, nc - 1, :, None].expand(bh, kd, vd)
    for c in reversed(range(nc)):
        qn, dn = (qc[:, c - 1], dc[:, c - 1, :, None].expand(bh, kd, vd)) \
            if c > 0 else (None, None)
        out[:, c] = g
        g = _fmaf(d, g, q)
        q, d = qn, dn
    return out


def tree_carry(ds, s_next, per_channel):
    """The decay pass's carry ⟨dS_{c+1}, S_{c+1}⟩ in its fixed order:
    per channel four partials (a quarter of V each, fmaf in order)
    combined (p0 + p1) + (p2 + p3); a scalar decay 256 partials (every
    256th of the K·V elements) combined by halving in a tree. (..., K, V)
    f32 → (..., K) or (..., 1)."""
    if per_channel:
        p, vd = [], ds.shape[-1]
        vq = -(-vd // 4)
        for qq in range(4):
            acc = torch.zeros(ds.shape[:-1])
            for c in range(qq * vq, min(vd, (qq + 1) * vq)):
                acc = _fmaf(ds[..., c], s_next[..., c], acc)
            p.append(acc)
        return (p[0] + p[1]) + (p[2] + p[3])
    g = ds.reshape(*ds.shape[:-2], -1)
    s = s_next.reshape(*s_next.shape[:-2], -1)
    red = torch.zeros(*g.shape[:-1], DEC_THREADS)
    for e0 in range(0, g.shape[-1], DEC_THREADS):
        n = min(DEC_THREADS, g.shape[-1] - e0)
        red[..., :n] = _fmaf(g[..., e0:e0 + n], s[..., e0:e0 + n],
                             red[..., :n])
    width = DEC_THREADS // 2
    while width:
        red[..., :width] = red[..., :width] + red[..., width:2 * width]
        width //= 2
    return red[..., :1]


def decay_pass(slot, ds, S, valid_of):
    """The decay's sums a chunk: the tree-ordered carry, then the chunk's
    slots summed from its last token back, each plus the carry. slot
    (B, chunks, L, H, K'), ds and S (B, H, chunks, K, V)."""
    b, nc, chunk, h, w = slot.shape
    out = torch.zeros_like(slot)
    for c in range(nc):
        carry = torch.zeros(b, h, w)
        if c + 1 < nc:
            carry = tree_carry(ds[:, :, c], S[:, :, c + 1], w > 1)
        r = torch.zeros(b, h, w)
        for i in reversed(range(valid_of(c))):
            r = r + slot[:, c, i]
            out[:, c, i] = r + carry
    return out


def _chunks(q, k, v, ld, dy, chunk):
    """f32 tensors padded to whole chunks (B, chunks, L, H, ·) and each
    chunk's running log decay lz (row 0 zeros, row r + 1 token r)."""
    b, t, h, kd = q.shape
    nc = -(-t // chunk)
    pad = nc * chunk - t
    lf = ld.float() if ld.dim() == 4 else ld.float()[..., None]
    xs = [torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad))
          .reshape(b, nc, chunk, h, -1) for x in (q, k, v, dy, lf)]
    lc = torch.cumsum(xs[4], 2)
    lz = torch.cat([torch.zeros_like(lc[:, :, :1]), lc], 2)
    return xs[:4], lz, nc


def _qc_ffma(qx, yx, lq):
    return torch.einsum("blhk,blhv->bhkv", qx * torch.exp(lq), yx)


def emulate_kernel_bwd(q, k, v, ld, dy, chunk, bonus, states):
    """The backward kernel's FFMA route on f32 CPU tensors, in its pass
    order: (1) Q_c and e^{lc_L} a chunk; (2) the element-parallel dS scan;
    (3) the fused pair pass a chunk: dq = e^{lq} ⊙ (dy·S_cᵀ), then key
    tiles J of TILE rows from their state terms, query tiles I ≥ J inside,
    each tile pair's dP and exponentials formed once and used for s, dq's
    and dk's intra terms (a scalar decay's as the matrices dP̃ and s̃),
    then q ⊙ dq − k ⊙ dk into the decay slot once (q one row on under
    "pre"); (4) the decay pass with the tree-ordered carry; (5) d bonus
    over b, then the chunks in order. Shapes as the launcher's."""
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    per_channel = ld.dim() == 4
    pre = bonus is not None
    chunk = min(chunk, t)
    (qf, kf, vf, yf), lz, nc = _chunks(q, k, v, ld, dy, chunk)
    S = states.reshape(b, h, nc, kd, vd)
    lq_all = lz[:, :, :chunk] if pre else lz[:, :, 1:]      # (B, C, L, H, K')
    # (1), (2)
    qc = torch.stack([_qc_ffma(qf[:, c], yf[:, c], lq_all[:, c])
                      for c in range(nc)], 2)                  # (B,H,C,K,V)
    dc = torch.exp(lz[:, :, chunk]).permute(0, 2, 1, 3).expand(b, h, nc, kd)
    ds = scan_elementwise(qc.reshape(b * h, nc, kd, vd),
                          dc.reshape(b * h, nc, kd)).reshape(b, h, nc, kd, vd)
    # (3)
    dq = torch.zeros(b, nc, chunk, h, kd)
    dk, dv = torch.zeros_like(dq), torch.zeros(b, nc, chunk, h, vd)
    slot = torch.zeros(b, nc, chunk, h, lz.shape[-1])
    part = torch.zeros(b, h, nc, kd)
    idx = torch.arange(chunk)
    for c in range(nc):
        qx, kx, vx, yx = qf[:, c], kf[:, c], vf[:, c], yf[:, c]
        lq, lc, lL = lq_all[:, c], lz[:, c, 1:], lz[:, c, chunk:]
        dqc = torch.exp(lq) * torch.einsum("blhv,bhkv->blhk", yx, S[:, :, c])
        dkc, dvc = torch.zeros_like(dqc), torch.zeros(b, chunk, h, vd)
        for j0 in range(0, chunk, TILE):
            J = slice(j0, j0 + TILE)
            kdec = torch.exp(lL - lc[:, J])
            dkc[:, J] = kdec * torch.einsum("bhkv,bjhv->bjhk", ds[:, :, c],
                                            vx[:, J])
            dvc[:, J] = torch.einsum("bjhk,bhkv->bjhv", kx[:, J] * kdec,
                                     ds[:, :, c])
            for i0 in range(j0, chunk, TILE):
                I = slice(i0, i0 + TILE)
                ii, jj = idx[I][:, None], idx[J][None, :]
                mask = (jj < ii) if pre else (jj <= ii)        # (I, J)
                dp = torch.einsum("bihv,bjhv->bijh", yx[:, I], vx[:, J])
                if per_channel:
                    diff = lq[:, I, None] - lc[:, None, J]     # (B,I,J,H,K)
                    ex = torch.exp(torch.where(mask[None, :, :, None, None],
                                               diff, -torch.inf))
                    t_ = dp[..., None] * ex
                    dqc[:, I] += torch.einsum("bijhk,bjhk->bihk", t_,
                                              kx[:, J])
                    dkc[:, J] += torch.einsum("bijhk,bihk->bjhk", t_,
                                              qx[:, I])
                    s = torch.einsum("bihk,bjhk,bijhk->bijh", qx[:, I],
                                     kx[:, J], ex)
                else:
                    diff = lq[:, I, None, :, 0] - lc[:, None, J, :, 0]
                    ex = torch.exp(torch.where(mask[None, :, :, None], diff,
                                               -torch.inf))
                    pt = dp * ex
                    s = torch.einsum("bihk,bjhk->bijh", qx[:, I],
                                     kx[:, J]) * ex
                    dqc[:, I] += torch.einsum("bijh,bjhk->bihk", pt,
                                              kx[:, J])
                    dkc[:, J] += torch.einsum("bijh,bihk->bjhk", pt,
                                              qx[:, I])
                dvc[:, J] += torch.einsum("bijh,bihv->bjhv", s, yx[:, I])
        a, bk = qx * dqc, kx * dkc
        if not per_channel:
            a, bk = a.sum(-1, keepdim=True), bk.sum(-1, keepdim=True)
        if pre:
            a = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], 1)
        slot[:, c] = a - bk
        if pre:
            dg = (yx * vx).sum(-1, keepdim=True)
            part[:, :, c] = (qx * kx * dg).sum(1)
            dqc = dqc + bonus * kx * dg
            dkc = dkc + bonus * qx * dg
            dvc = dvc + (qx * bonus * kx).sum(-1, keepdim=True) * yx
        dq[:, c], dk[:, c], dv[:, c] = dqc, dkc, dvc
    # (4)
    dld = decay_pass(slot, ds, S, lambda c: min(chunk, t - c * chunk))
    dld = dld.reshape(b, nc * chunk, h, -1)[:, :t]
    if not per_channel:
        dld = dld[..., 0]
    # (5)
    dbonus = None
    if pre:
        dbonus = torch.zeros(h, kd)
        for bb in range(b):
            for c in range(nc):
                dbonus = dbonus + part[bb, :, c]

    def whole(x, like):
        return x.reshape(b, nc * chunk, h, -1)[:, :t].to(like.dtype)
    return whole(dq, q), whole(dk, k), whole(dv, v), dld, dbonus


# the tensor-core route's operands in three bf16 terms (a name in
# `single` takes one term: the rejected single rounding)
TC_SPLIT = ("S_c", "dS", "dP", "s", "ey")


def _tc(a, b, split_a=None, split_b=None, single=()):
    """a @ b as a tensor-core step: `tc_mm` with an operand named in
    TC_SPLIT in three terms (one where `single` names it), an unnamed one
    exact; each call a zeroed accumulator."""
    one_a, one_b = split_a in single, split_b in single
    return tc_mm(a, b, split_a is None, split_b is None,
                 1 if one_a else 3, 1 if one_b else 3)


def _tc_steps(a, b, width, **kw):
    """Σ over k16 steps of the contraction (width `width`), each step from
    a zeroed accumulator, added in f32."""
    out = None
    for s0 in range(0, width, BLOCK):
        x = _tc(a[..., s0:s0 + BLOCK], b[..., s0:s0 + BLOCK, :], **kw)
        out = x if out is None else out + x
    return out


def emulate_tc_bwd(q, k, v, ld, dy, chunk, states, single=()):
    """The tensor-core route (bf16 inputs, scalar decay, "post") on CPU
    tensors holding bf16 values: q, k, v, dy enter as one exact term;
    S_c, dS_{c+1}, dP̃, s̃ and e^{lc}·dy as their three-term bf16 splits
    (`split3` of the forward's emulation), products kept where the term
    orders sum to ≤ 2. Every product takes each k16 step (dP and s over V
    or K, the state terms, Q_c's 16 tokens) or each 16-row block (the
    intra sums) from a zeroed accumulator and adds it in f32; dq, dk, dv
    are rounded to bf16 once;
    q ⊙ dq − k ⊙ dk from f32 dq and dk; the element-parallel scan and the
    tree-ordered carry as in `emulate_kernel_bwd`."""
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    chunk = min(chunk, t)
    (qf, kf, vf, yf), lz, nc = _chunks(q, k, v, ld, dy, chunk)
    L = -(-chunk // BLOCK) * BLOCK
    padl = L - chunk

    def rows(x):    # (B, L, H, ·) → (B, H, L16, ·)
        return torch.nn.functional.pad(x.permute(0, 2, 1, 3),
                                       (0, 0, 0, padl))
    S = states.reshape(b, h, nc, kd, vd)
    idx = torch.arange(L)
    mask = idx[None, :] <= idx[:, None]                    # (i, j): j ≤ i
    qc, lzs = [], []
    for c in range(nc):
        lzc = torch.nn.functional.pad(lz[:, c, :, :, 0].permute(0, 2, 1),
                                      (0, padl), mode="replicate")
        lzs.append(lzc)                                    # (B, H, L16 + 1)
        ey = torch.exp(lzc[..., 1:, None]) * rows(yf[:, c])
        qc.append(_tc_steps(rows(qf[:, c]).transpose(-1, -2), ey, L,
                            split_b="ey", single=single))
    qc = torch.stack(qc, 2)
    dc = torch.exp(lz[:, :, chunk, :, 0]).permute(0, 2, 1)[..., None] \
        .expand(b, h, nc, kd)
    ds = scan_elementwise(qc.reshape(b * h, nc, kd, vd),
                          dc.reshape(b * h, nc, kd)).reshape(b, h, nc, kd, vd)
    dq = torch.zeros(b, h, nc, L, kd)
    dk, dv = torch.zeros_like(dq), torch.zeros(b, h, nc, L, vd)
    slot = torch.zeros(b, nc, chunk, h, 1)
    for c in range(nc):
        qx, kx, vx, yx = (rows(x[:, c]) for x in (qf, kf, vf, yf))
        lc = lzs[c][..., 1:]                               # (B, H, L16)
        lL = lzs[c][..., chunk:chunk + 1]
        ex = torch.exp(torch.where(mask, lc[..., :, None] - lc[..., None, :],
                                   -torch.inf))            # (B, H, i, j)
        dp = _tc_steps(yx, vx.transpose(-1, -2), vd)       # (B, H, i, j)
        sc = _tc_steps(qx, kx.transpose(-1, -2), kd)
        dpt, st = dp * ex, sc * ex
        dqc = torch.exp(lc)[..., None] * _tc_steps(
            yx, S[:, :, c].transpose(-1, -2), vd, split_b="S_c",
            single=single)
        kdec = torch.exp(lL - lc)[..., None]
        dkc = kdec * _tc_steps(vx, ds[:, :, c].transpose(-1, -2), vd,
                               split_b="dS", single=single)
        dvc = kdec * _tc_steps(kx, ds[:, :, c], kd, split_b="dS",
                               single=single)
        for j0 in range(0, L, BLOCK):                      # key blocks
            J = slice(j0, j0 + BLOCK)
            dqc = dqc + _tc(dpt[..., J], kx[..., J, :], split_a="dP",
                            single=single)
        for i0 in range(0, L, BLOCK):                      # query blocks
            I = slice(i0, i0 + BLOCK)
            dkc = dkc + _tc(dpt[..., I, :].transpose(-1, -2), qx[..., I, :],
                            split_a="dP", single=single)
            dvc = dvc + _tc(st[..., I, :].transpose(-1, -2), yx[..., I, :],
                            split_a="s", single=single)
        a = (qx * dqc).sum(-1) - (kx * dkc).sum(-1)        # (B, H, L16)
        slot[:, c] = a[..., :chunk].permute(0, 2, 1)[..., None]
        dq[:, :, c], dk[:, :, c], dv[:, :, c] = dqc, dkc, dvc
    dld = decay_pass(slot, ds, S, lambda c: min(chunk, t - c * chunk))
    dld = dld.reshape(b, nc * chunk, h)[:, :t]

    def whole(x):
        return x[:, :, :, :chunk].permute(0, 2, 3, 1, 4).reshape(
            b, nc * chunk, h, -1)[:, :t].to(torch.bfloat16)
    return whole(dq), whole(dk), whole(dv), dld, None


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_kernel_pass_order_matches_references(case):
    """The emulated kernel (its pass order and tiling) against jax.grad of
    the reference and the f64 plain backward, within phase 13 (b)'s f32
    limits; the entering states from the forward's recurrence."""
    x, chunk, h = _case_inputs(case)
    t = _torch(x, h)
    states = TSSM.gla_chunk_states_plain(t["k"], t["v"], t["log_decay"],
                                         chunk=chunk,
                                         initial_state=t["initial_state"])
    got = emulate_kernel_bwd(t["q"], t["k"], t["v"], t["log_decay"],
                             t["dy"], chunk, t["bonus"], states)
    got = [_head_sum(got[0], x["q"]), _head_sum(got[1], x["k"]), *got[2:]]
    tols = _tols(x, chunk)
    _hold(got, _jax_grads(x, chunk, h), tols, f"{case[0]} vs jax.grad")
    _hold(got, _plain_bwd(x, chunk, h, torch.float64), tols,
          f"{case[0]} vs f64")


def test_kernel_tiles_of_a_long_chunk():
    """Mamba2's chunk of 128 splits into four key tiles of 32 rows, each
    with the query tiles at or after it (ten tile pairs); the emulation at
    that chunk, ragged, matches the f64 plain backward."""
    case = ("mamba2-128", 1, 150, 2, 8, 8, 128, False, False, True, False,
            True)
    x, chunk, h = _case_inputs(case)
    t = _torch(x, h)
    states = TSSM.gla_chunk_states_plain(t["k"], t["v"], t["log_decay"],
                                         chunk=chunk,
                                         initial_state=t["initial_state"])
    got = emulate_kernel_bwd(t["q"], t["k"], t["v"], t["log_decay"],
                             t["dy"], chunk, None, states)
    got = [_head_sum(got[0], x["q"]), _head_sum(got[1], x["k"]), *got[2:]]
    _hold(got, _plain_bwd(x, chunk, h, torch.float64), _tols(x, chunk),
          case[0])


def test_backward_workspace_floats():
    """The launcher's workspace: Q_c then dS, the chunks' decays and one
    bonus partial a chunk and channel, per (b, h)."""
    b, t, h, kd, vd = 2, 300, 3, 16, 8
    for chunk in (32, 128, 100, 500):
        n = b * h * -(-t // min(chunk, t))
        assert chunk_scan.bwd_workspace_floats(b, t, h, kd, vd, chunk) == \
            n * kd * vd + 2 * n * kd


@pytest.mark.parametrize("dtype,per_channel,pre,kd,vd,route", [
    (torch.bfloat16, False, False, 64, 64, "tensor cores"),
    (torch.bfloat16, False, False, 48, 40, "tensor cores"),
    (torch.bfloat16, False, False, 12, 64, "ffma"),
    (torch.bfloat16, False, True, 64, 64, "ffma"),
    (torch.bfloat16, True, True, 64, 64, "ffma"),
    (torch.float32, False, False, 64, 64, "ffma")])
def test_backward_route(dtype, per_channel, pre, kd, vd, route):
    """`chunk_scan.bwd_route` names the kernel's route: the tensor cores
    for bf16 inputs with a scalar decay under "post" and K, V multiples of
    8 (Mamba2), FFMA for everything else."""
    b, t, h = 1, 8, 2
    q = torch.zeros(b, t, h, kd, dtype=dtype)
    v = torch.zeros(b, t, h, vd, dtype=dtype)
    ld = torch.zeros((b, t, h, kd) if per_channel else (b, t, h))
    bonus = torch.ones(h, kd) if pre else None
    assert chunk_scan.bwd_route(q, v, ld, bonus) == route


def test_dS_scan_element_parallel_is_the_serial_order():
    """The element-parallel scan (a thread an element, the next chunk's
    Q_c and decay loaded ahead) is bitwise the serial scan it replaced (a
    block a (b, h), 4 × 4 pieces a thread): each element keeps its order,
    g ← fmaf(e^{lc_L}, g, Q_c) from the last chunk down."""
    rng = np.random.default_rng(30)
    bh, nc, kd, vd = 3, 21, 10, 6
    qc = torch.from_numpy(rng.normal(size=(bh, nc, kd, vd))
                          .astype(np.float32))
    dc = torch.from_numpy(np.exp(-rng.exponential(size=(bh, nc, kd)))
                          .astype(np.float32))
    assert torch.equal(scan_elementwise(qc, dc), scan_serial(qc, dc))


# (name, B, T, H, K, V, chunk, strong, q and k shared over the heads)
TC_CASES = [
    ("mamba2-bf16", 2, 96, 3, 16, 16, 32, False, True),
    ("ragged-s0", 1, 150, 2, 16, 32, 64, False, True),
    ("strong", 1, 128, 2, 16, 16, 64, True, True),
    ("k48-v40", 1, 160, 2, 48, 40, 128, False, False),
]


def _tc_inputs(case):
    """bf16-valued inputs of a tensor-core case (q, k, v, dy rounded to
    bf16; the log decay and the states f32) and its normwise limits:
    phase 13 (b)'s bf16 ones (dq, dk, dv L·K·2⁻²³ + 2⁻⁸; d log_decay
    L·K·2⁻²³)."""
    name, b, t, h, kd, vd, chunk, strong, shared = case
    x = _inputs(sum(map(ord, name)), b, t, h, kd, vd, False, False, True,
                strong, shared)
    for n in ("q", "k", "v", "dy"):
        x[n] = torch.from_numpy(x[n]).bfloat16().float().numpy()
    tx = _torch(x, h)
    states = TSSM.gla_chunk_states_plain(tx["k"], tx["v"], tx["log_decay"],
                                         chunk=chunk,
                                         initial_state=tx["initial_state"])
    f32 = min(chunk, t) * kd * 2.0 ** -23
    return x, tx, states, chunk, h, dict(dq=f32 + 2.0 ** -8,
                                         dk=f32 + 2.0 ** -8,
                                         dv=f32 + 2.0 ** -8, dlog_decay=f32)


@pytest.mark.parametrize("case", TC_CASES, ids=[c[0] for c in TC_CASES])
def test_tc_route_matches_the_f64_plain_backward(case):
    """The tensor-core route's arithmetic (emulated: exact bf16 inputs,
    three-term splits, k16 steps and 16-row blocks from zeroed
    accumulators added in f32, one bf16 rounding of each gradient) within
    phase 13 (b)'s bf16 limits of `gla_chunked_bwd_plain` in f64 on the
    same inputs: ragged T from an initial state, the strong decay, K 48 /
    V 40, q and k broadcast over the heads; at most a share 2⁻¹⁰ of dv's
    bf16 values differ from the f64 gradient rounded to bf16."""
    x, tx, states, chunk, h, tols = _tc_inputs(case)
    got = emulate_tc_bwd(tx["q"], tx["k"], tx["v"], tx["log_decay"],
                         tx["dy"], chunk, states)
    want = _plain_bwd(x, chunk, h, torch.float64)
    got = [_head_sum(got[0], x["q"]), _head_sum(got[1], x["k"]), *got[2:4]]
    for g, a, w in zip(GRADS, got, want):
        assert torch.isfinite(a.float()).all(), g
        err = _normwise(a.float(), w)
        assert err <= tols[g], f"{case[0]}: {g} {err:.3e} > {tols[g]:.3e}"
    assert _bf16_mismatch(got[2], want[2]) <= 2.0 ** -10


def _bf16_mismatch(a, want):
    """The share of a's bf16 values that differ from `want` rounded to
    bf16."""
    return float((a.bfloat16() != want.bfloat16()).double().mean())


# chip_smoke.py's GLA_BWD_TC_SHARE: on the tensor-core route d log_decay's
# normwise error and dv's bf16 mismatch share are each at most this many
# times the same of the plain backward in f32 on the same inputs
TC_SHARE = 3.0
# zamba2's training layer call (L 128, K = V = 64, q and k shared over the
# heads) cut to two heads and 256 tokens: the normwise limits there are
# 16 times looser in d log_decay than at TC_CASES[0]'s L 32, K 16
TC_L128 = ("zamba2-l128", 1, 256, 2, 64, 64, 128, False, True)


def _tc_control_errs(got, want, control):
    """(d log_decay's normwise error, dv's bf16 mismatch share) of `got`
    and of `control`, against f64 `want`: phase 13 (b)'s tensor-core
    checks (chip_smoke.py's `_tc_route_errs`)."""
    return ((_normwise(got[3], want[3]), _normwise(control[3], want[3])),
            (_bf16_mismatch(got[2], want[2]),
             _bf16_mismatch(control[2], want[2])))


def _within_tc_share(errs, n_dv):
    (e, c), (m, mc) = errs
    return e <= TC_SHARE * c, m <= TC_SHARE * max(mc, 1.0 / n_dv)


@pytest.mark.parametrize("case", TC_CASES + [TC_L128],
                         ids=[c[0] for c in TC_CASES + [TC_L128]])
def test_tc_route_within_the_plain_f32_share(case):
    """Phase 13 (b)'s tensor-core checks on the emulated route: d
    log_decay's normwise error and dv's bf16 mismatch share each within
    TC_SHARE times the plain backward's in f32 on the same inputs, at
    TC_CASES and at zamba2's L 128 (where the f32 plain backward's own dv
    share reaches 2⁻¹⁰)."""
    x, tx, states, chunk, h, _ = _tc_inputs(case)
    got = emulate_tc_bwd(tx["q"], tx["k"], tx["v"], tx["log_decay"],
                         tx["dy"], chunk, states)
    want = _plain_bwd(x, chunk, h, torch.float64)
    errs = _tc_control_errs(got, want, _plain_bwd(x, chunk, h))
    assert all(_within_tc_share(errs, got[2].numel())), (case[0], errs)


@pytest.mark.parametrize("case", [TC_CASES[0], TC_L128],
                         ids=[TC_CASES[0][0], TC_L128[0]])
@pytest.mark.parametrize("operand", TC_SPLIT)
def test_single_rounding_of_a_tc_operand_fails(operand, case):
    """The rejected variants of the tensor-core route: one f32 operand
    rounded once to bf16 (one term, not three), each missing a limit that
    phase 13 (b) applies on the card. S_c (dq's state term), dS (dk's and
    dv's), dP̃ (dq's and dk's intra sums) and e^{lc}·dy (Q_c, hence dS)
    each put d log_decay beyond TC_SHARE times the plain f32 backward's
    error, and at TC_CASES[0] beyond its normwise limit L·K·2⁻²³ too (at
    zamba2's L 128 that limit is 16 times looser and S_c, dS and e^{lc}·dy
    stay within it); s̃ reaches only dv, and changes more than TC_SHARE
    times the plain f32 backward's share of its bf16 values, and more than
    2⁻¹⁰ of them."""
    x, tx, states, chunk, h, tols = _tc_inputs(case)
    got = emulate_tc_bwd(tx["q"], tx["k"], tx["v"], tx["log_decay"],
                         tx["dy"], chunk, states, single=(operand,))
    want = _plain_bwd(x, chunk, h, torch.float64)
    errs = _tc_control_errs(got, want, _plain_bwd(x, chunk, h))
    dld_ok, dv_ok = _within_tc_share(errs, got[2].numel())
    if operand == "s":
        assert _normwise(got[3], want[3]) <= tols["dlog_decay"]
        assert dld_ok and not dv_ok, errs
        assert _bf16_mismatch(got[2], want[2]) > 2.0 ** -10
    else:
        assert not dld_ok, errs
        if case is TC_CASES[0]:
            assert _normwise(got[3], want[3]) > tols["dlog_decay"]


@pytest.mark.parametrize("case", [
    ("rwkv6-train", 2, 32, True, True, "ffma"),
    ("zamba2-train", 16, 128, False, False, "ffma"),
    ("zamba2-train", 16, 128, False, False, "tc")],
    ids=lambda c: f"{c[0]}-{c[5]}")
def test_tree_carry_keeps_the_decay_sum_within_half(case):
    """The kernel's decay pass (the carry ⟨dS_{c+1}, S_{c+1}⟩ summed in its
    fixed tree, then each chunk's tokens) keeps Σ_t d log_decay within
    half the error of the running-sum control at phase 13 (b)'s two
    training layer calls cut to 2 and 16 heads (as
    `test_decay_sum_within_half_a_running_sum_at_the_training_calls`):
    the FFMA route's emulation in f32, and zamba2's tensor-core route's
    on bf16 inputs."""
    name, h, chunk, per_channel, pre, route = case
    x = _inputs(sum(map(ord, name)), 2, 4096, h, 64, 64, per_channel, pre,
                False, False, not per_channel)
    if route == "tc":
        for n in ("q", "k", "v", "dy"):
            x[n] = torch.from_numpy(x[n]).bfloat16().float().numpy()
    t = _torch(x, h)
    states = TSSM.gla_chunk_states_plain(t["k"], t["v"], t["log_decay"],
                                         chunk=chunk)
    if route == "tc":
        got = emulate_tc_bwd(t["q"], t["k"], t["v"], t["log_decay"],
                             t["dy"], chunk, states)[3]
    else:
        got = emulate_kernel_bwd(t["q"], t["k"], t["v"], t["log_decay"],
                                 t["dy"], chunk, t["bonus"], states)[3]
    want = _plain_bwd(x, chunk, h, torch.float64)[3]
    total = want.sum(1)
    err = _normwise(got.double().sum(1), total)
    control = _normwise(_running_sum_control(got).double().sum(1), total)
    assert err <= 0.5 * control, (err, control)


# ---------------------------------------------------------------------------
# the autograd Function and the launchers
# ---------------------------------------------------------------------------

def _plain_forward(q, k, v, log_decay, *, chunk, bonus=None,
                   initial_state=None, return_states=False):
    y, s = TSSM.gla_chunked_plain(q, k, v, log_decay, chunk=chunk,
                                  bonus=bonus, initial_state=initial_state)
    if not return_states:
        return y, s
    return y, s, TSSM.gla_chunk_states_plain(
        k, v, log_decay, chunk=chunk, initial_state=initial_state)


def _plain_backward(q, k, v, log_decay, dy, states, *, chunk, bonus=None):
    return TSSM.gla_chunked_bwd_plain(q, k, v, log_decay, dy, chunk=chunk,
                                      bonus=bonus, states=states)


@pytest.fixture
def plain_launchers(monkeypatch):
    """`GLAChunked` with its launchers replaced by their plain versions, so
    that the Function runs on CPU tensors."""
    monkeypatch.setattr(chunk_scan, "gla_chunk_f32", _plain_forward)
    monkeypatch.setattr(chunk_scan, "gla_chunk_bwd_f32", _plain_backward)


def _leaves(case):
    x, chunk, h = _case_inputs(case)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in x.items()}
    for n in ("q", "k", "v", "log_decay", "bonus"):
        if t[n] is not None:
            t[n].requires_grad_(True)
    return t, chunk, h


@pytest.mark.parametrize("case", [CASES[1], CASES[4]], ids=[CASES[1][0],
                                                             CASES[4][0]])
def test_function_gradients_match_plain_autograd(plain_launchers, case):
    """Through `GLAChunked` (plain launchers) the gradients of every input,
    broadcast q and k included, equal the plain backward's and lie within
    the limits of autograd of `gla_chunked_plain`; y and the state are the
    forward's."""
    t, chunk, h = _leaves(case)
    q, k = (t[n].expand(t[n].shape[0], t[n].shape[1], h, t[n].shape[3])
            for n in ("q", "k"))
    y, state, _ = chunk_scan.GLAChunked.apply(
        q, k, t["v"], t["log_decay"], t["bonus"], t["initial_state"], chunk)
    yp, sp = TSSM.gla_chunked_plain(q, k, t["v"], t["log_decay"],
                                    chunk=chunk, bonus=t["bonus"],
                                    initial_state=t["initial_state"])
    assert torch.equal(y, yp) and torch.equal(state, sp)
    leaves = [t[n] for n in ("q", "k", "v", "log_decay", "bonus")
              if t[n] is not None]
    got = torch.autograd.grad((y * t["dy"]).sum(), leaves)
    want = torch.autograd.grad((yp * t["dy"]).sum(), leaves)
    x, _, _ = _case_inputs(case)
    tols = _tols(x, chunk)
    for g, a, w in zip(GRADS, got, want):
        assert _normwise(a.detach(), w) <= tols[g], g


def test_function_refuses_a_final_state_cotangent(plain_launchers):
    t, chunk, _ = _leaves(CASES[0])
    y, state, _ = chunk_scan.GLAChunked.apply(
        t["q"], t["k"], t["v"], t["log_decay"], t["bonus"], None, chunk)
    with pytest.raises(NotImplementedError, match="final state"):
        (y.sum() + state.sum()).backward()


def test_function_refuses_an_initial_state_gradient(plain_launchers):
    t, chunk, _ = _leaves(CASES[1])
    s0 = t["initial_state"].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="initial_state"):
        chunk_scan.GLAChunked.apply(t["q"], t["k"], t["v"], t["log_decay"],
                                    t["bonus"], s0, chunk)


def test_function_refuses_vmap(plain_launchers):
    t, chunk, _ = _leaves(CASES[0])

    def one(q):
        return chunk_scan.GLAChunked.apply(q, t["k"][0], t["v"][0],
                                           t["log_decay"][0], t["bonus"],
                                           None, chunk)[0]
    with pytest.raises(NotImplementedError, match="vmap"):
        torch.func.vmap(one)(t["q"].detach()[:, None])


def test_launchers_refuse_inputs_under_grad():
    """A direct launcher call on an input that requires grad raises, naming
    the Function, before it looks at the device."""
    t, chunk, _ = _leaves(CASES[0])
    args = (t["q"], t["k"], t["v"], t["log_decay"])
    launches = chunk_scan.gla_chunk_f32.launches
    with pytest.raises(NotImplementedError, match="GLAChunked"):
        chunk_scan.gla_chunk_f32(*args, chunk=chunk, bonus=t["bonus"])
    with pytest.raises(NotImplementedError, match="GLAChunked"):
        chunk_scan.gla_chunk_bwd_f32(*args, t["dy"], torch.zeros(1),
                                     chunk=chunk, bonus=t["bonus"])
    with torch.no_grad(), pytest.raises(ValueError, match="not CUDA"):
        chunk_scan.gla_chunk_f32(*args, chunk=chunk, bonus=t["bonus"])
    assert chunk_scan.gla_chunk_f32.launches == launches


def test_backward_launcher_refuses_cpu_and_bad_shapes():
    x, chunk, h = _case_inputs(CASES[0])
    t = _torch(x, h)
    args = (t["q"], t["k"], t["v"], t["log_decay"])
    launches = chunk_scan.gla_chunk_bwd_f32.launches
    with pytest.raises(ValueError, match="dy"):
        chunk_scan.gla_chunk_bwd_f32(*args, t["dy"][:, :-1], torch.zeros(1),
                                     chunk=chunk, bonus=t["bonus"])
    with pytest.raises(ValueError, match="not CUDA"):
        chunk_scan.gla_chunk_bwd_f32(*args, t["dy"], torch.zeros(1),
                                     chunk=chunk, bonus=t["bonus"])
    with pytest.raises(ValueError, match="log_decay"):
        chunk_scan.gla_chunk_bwd_f32(*args[:3], t["log_decay"][..., :3],
                                     t["dy"], torch.zeros(1), chunk=chunk,
                                     bonus=t["bonus"])
    assert chunk_scan.gla_chunk_bwd_f32.launches == launches


def test_cpu_route_under_grad_is_autograd_of_the_plain_gla(monkeypatch):
    """On the CPU `gla_chunked` under grad stays autograd of
    `gla_chunked_plain`: bitwise its values and gradients, without the
    Function."""
    def refuse(*a, **kw):
        raise AssertionError("GLAChunked taken on the CPU")
    monkeypatch.setattr(chunk_scan.GLAChunked, "apply", refuse)
    t, chunk, _ = _leaves(CASES[0])
    args = (t["q"], t["k"], t["v"], t["log_decay"])
    y, s = TSSM.gla_chunked(*args, chunk=chunk, bonus=t["bonus"])
    yp, sp = TSSM.gla_chunked_plain(*args, chunk=chunk, bonus=t["bonus"])
    assert torch.equal(y, yp) and torch.equal(s, sp)
    leaves = [*args, t["bonus"]]
    got = torch.autograd.grad((y * t["dy"]).sum(), leaves)
    want = torch.autograd.grad((yp * t["dy"]).sum(), leaves)
    assert all(torch.equal(a, w) for a, w in zip(got, want))
