"""The GLA backward (`models/ssm.gla_chunked_bwd_plain`, the plain version
of csrc/gla_chunk_bwd_f32.cu) and its autograd Function
(`kernels/chunk_scan.GLAChunked`) against the JAX reference: the same
numpy inputs through `jax.grad` of the reference's `models.ssm.
gla_chunked`, through autograd of the port's `gla_chunked_plain`, and
through an emulation of the kernel's pass order.

The kernel runs only on the card (`chip_smoke.py` phase 13 (b)); here its
launcher must refuse what it cannot take, and the Function is driven on
the CPU with its two launchers replaced by their plain versions.

Tolerances, normwise (chip_smoke.py phase 13 (b)'s f32 limits; L the
chunk, K the key width, B·T the tokens): dq, dk and dv L·K·2⁻²³ (sums of
up to L·K f32 terms taken in another order), and d log_decay the same
(its reverse sum runs over one chunk's tokens, later chunks entering as
one ⟨dS, S⟩); d bonus (L·K + B·T)·2⁻²³ (a sum over B·T tokens). d log_decay is held normwise
only: under a zero initial state its first token's exact 0 is a rounding
residue in every route."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JSSM
from repro_torch.kernels import chunk_scan
from repro_torch.models import ssm as TSSM

torch.set_num_threads(2)

GRADS = ("dq", "dk", "dv", "dlog_decay", "dbonus")
TILE = 32        # the kernel's row tiles (chunk_scan.BWD_TILE)

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
# an emulation of the kernel's pass order
# ---------------------------------------------------------------------------

def emulate_kernel_bwd(q, k, v, ld, dy, chunk, bonus, states):
    """The backward kernel's passes on f32 CPU tensors, in its order: (1)
    dq by tiles of TILE query rows (q ⊙ dq into the decay slot, the bonus
    partials), (2) Q_c and e^{lc_L} a chunk, (3) dS backwards over the
    chunks, (4) dk and dv by tiles of TILE keys (k ⊙ dk out of the decay
    slot), (5) the decay's reverse sum token by token from the end, (6) d
    bonus over b, then the tiles in order. Shapes as the launcher's."""
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    per_channel = ld.dim() == 4
    pre = bonus is not None
    chunk = min(chunk, t)
    nc = -(-t // chunk)
    f = [x.float() for x in (q, k, v, dy)]
    pad = nc * chunk - t
    qf, kf, vf, yf = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
                      for x in f)
    lf = ld.float() if per_channel else ld.float()[..., None]
    lf = torch.nn.functional.pad(lf, (0, 0, 0, 0, 0, pad))
    S = states.reshape(b, h, nc, kd, vd)
    dq, dk = torch.zeros_like(qf), torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    slot = torch.zeros(b, nc * chunk, h, lf.shape[-1])
    tiles = -(-chunk // TILE)
    part = torch.zeros(b, h, nc * tiles, kd)

    def lz_of(c):               # row 0 zeros, row r + 1 the running sum
        lc = torch.cumsum(lf[:, c * chunk:(c + 1) * chunk], 1)
        return torch.cat([torch.zeros_like(lc[:, :1]), lc], 1)

    def masked(i, j):
        return j < i if pre else j <= i

    # (1) dq
    for c in range(nc):
        lz, c0 = lz_of(c), c * chunk
        for rb in range(tiles):
            i0 = rb * TILE
            rows = range(i0, min(i0 + TILE, chunk))
            for i in rows:
                lq = lz[:, i if pre else i + 1]                # (B, H, K')
                acc = torch.exp(lq) * torch.einsum(
                    "bhkv,bhv->bhk", S[:, :, c], yf[:, c0 + i])
                for j in range(chunk):
                    if not masked(i, j):
                        continue
                    p = (yf[:, c0 + i] * vf[:, c0 + j]).sum(-1)[..., None]
                    acc = acc + p * kf[:, c0 + j] * torch.exp(
                        lq - lz[:, j + 1])
                a = qf[:, c0 + i] * acc
                if not per_channel:
                    a = a.sum(-1, keepdim=True)
                if not pre:
                    slot[:, c0 + i] = a
                elif i > 0:             # the first token's: the carry's
                    slot[:, c0 + i - 1] = a
                if pre:
                    dg = (yf[:, c0 + i] * vf[:, c0 + i]).sum(-1)[..., None]
                    acc = acc + bonus * kf[:, c0 + i] * dg
                    part[:, :, c * tiles + rb] += \
                        qf[:, c0 + i] * kf[:, c0 + i] * dg
                dq[:, c0 + i] = acc
    # (2), (3) the reverse state pass
    qc, dc = [], []
    for c in range(nc):
        lz, c0 = lz_of(c), c * chunk
        lq = lz[:, :chunk] if pre else lz[:, 1:]
        qc.append(torch.einsum("blhk,blhv->bhkv",
                               qf[:, c0:c0 + chunk] * torch.exp(lq),
                               yf[:, c0:c0 + chunk]))
        dc.append(torch.exp(lz[:, chunk])[..., None])
    ds, g = [None] * nc, torch.zeros(b, h, kd, vd)
    for c in reversed(range(nc)):
        ds[c] = g
        g = dc[c] * g + qc[c]
    # (4) dk and dv
    for c in range(nc):
        lz, c0 = lz_of(c), c * chunk
        for j in range(chunk):
            kdec = torch.exp(lz[:, chunk] - lz[:, j + 1])        # (B,H,K')
            accv = torch.einsum("bhk,bhkv->bhv", kf[:, c0 + j] * kdec,
                                ds[c])
            acck = kdec * torch.einsum("bhkv,bhv->bhk", ds[c],
                                       vf[:, c0 + j])
            for i in range(j, chunk):
                if not masked(i, j):
                    continue
                ex = torch.exp(lz[:, i if pre else i + 1] - lz[:, j + 1])
                s = (qf[:, c0 + i] * kf[:, c0 + j] * ex).sum(-1)[..., None]
                p = (yf[:, c0 + i] * vf[:, c0 + j]).sum(-1)[..., None]
                accv = accv + s * yf[:, c0 + i]
                acck = acck + p * qf[:, c0 + i] * ex
            bk = kf[:, c0 + j] * acck
            slot[:, c0 + j] -= bk if per_channel else bk.sum(-1,
                                                             keepdim=True)
            if pre:
                dgj = (qf[:, c0 + j] * bonus * kf[:, c0 + j]).sum(-1)
                dd = (yf[:, c0 + j] * vf[:, c0 + j]).sum(-1)[..., None]
                accv = accv + dgj[..., None] * yf[:, c0 + j]
                acck = acck + bonus * qf[:, c0 + j] * dd
            dv[:, c0 + j], dk[:, c0 + j] = accv, acck
    # (5) the decay's reverse sums a chunk: the carry ⟨dS_{c+1}, S_{c+1}⟩,
    # then the chunk's tokens from its end, each plus the carry
    dld = torch.zeros(b, nc * chunk, h, lf.shape[-1])
    for c in range(nc):
        carry = torch.zeros(b, h, lf.shape[-1])
        if c + 1 < nc:
            carry = (ds[c] * S[:, :, c + 1]).sum(-1)
            if not per_channel:
                carry = carry.sum(-1, keepdim=True)
        r = torch.zeros(b, h, lf.shape[-1])
        for i in reversed(range(chunk)):
            r = r + slot[:, c * chunk + i]
            dld[:, c * chunk + i] = r + carry
    dld = dld[:, :t]
    if not per_channel:
        dld = dld[..., 0]
    # (6) d bonus: over b, then over the tiles in order
    dbonus = None
    if pre:
        dbonus = torch.zeros(h, kd)
        for bb in range(b):
            for i in range(nc * tiles):
                dbonus = dbonus + part[bb, :, i]
    return (dq[:, :t].to(q.dtype), dk[:, :t].to(k.dtype),
            dv[:, :t].to(v.dtype), dld, dbonus)


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
    """Mamba2's chunk of 128 splits into four tiles of 32 rows in both the
    dq and the dk/dv pass; the emulation at that chunk, ragged, matches the
    f64 plain backward."""
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
    bonus partial a row tile of 32 and channel, per (b, h)."""
    b, t, h, kd, vd = 2, 300, 3, 16, 8
    for chunk, tiles in ((32, 1), (128, 4), (100, 4), (500, 10)):
        n = b * h * -(-t // min(chunk, t))
        assert chunk_scan.bwd_workspace_floats(b, t, h, kd, vd, chunk) == \
            n * kd * vd + n * kd + n * tiles * kd


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
