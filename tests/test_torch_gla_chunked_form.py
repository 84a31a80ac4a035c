"""The numerics of the GLA kernel's chunk-parallel form (csrc/gla_chunk_f32.cu),
emulated in plain PyTorch on the CPU and held against the JAX reference.

The kernel splits a call in two passes:
- the state pass: per chunk c, U_c = (k ⊙ e^{lc_L − lc})ᵀ v and d_c =
  e^{lc_L}, in f32 (FFMA); then S_{c+1} = S_c ⊙ d_c + U_c over the chunks
  in order, each S_c (the state chunk c enters with) kept for the output
  pass;
- the output pass: per block of query rows of a chunk, y = P·v +
  (q ⊙ e^{lq})·S_c [+ the bonus diagonal under "pre"], P the masked scores.

The output pass runs bf16 inputs with scalar decay under "post" (Mamba2) on
the tensor cores (bf16 mma, f32 accumulation): q, k and v enter as one term
each (they hold bf16 values exactly); the scores P and the entering state
S, f32, as their exact three-term bf16 splits x = hi + mid + lo, keeping
the products whose term orders sum to at most 2 (hi·hi, hi·mid, mid·hi,
hi·lo, mid·mid, lo·hi). Everything else (per-channel decay, "pre", f32
inputs) takes every product in f32 (FFMA), each pair's exponent one
difference ≤ 0. `split3` and `tc_mm` below are that arithmetic; `emulate`
is the whole call.

Per-channel decay (RWKV6) on the tensor cores, the route a kernel build
took and the card measured slower than FFMA (so the kernel keeps FFMA), is
emulated too ("tc-per-channel"): the scores by sub-chunks of 16 query
rows, keys before a sub-chunk through a reference point r between them,
e^{lq_i − lc_j} = e^{lq_i − r}·e^{r − lc_j} (both exponents ≤ 0, so no
factor overflows), the diagonal block split once more at its 8th row, and
only its two 8 × 8 diagonal blocks pair by pair in f32; q̃, k̃ and
q ⊙ e^{lq} in three terms each.

Tolerances: phase 13's, normwise. f32: L·K·2⁻²³ for y and for the state
(sums of up to L·K terms taken in another order; the dropped split products
are below 2⁻²⁴ of each product). bf16 inputs: y adds one bf16 rounding,
2⁻⁸ (both sides round an f32 sum once); the state stays f32; and at most
a share 2⁻¹⁰ of y's bf16 values may differ from the plain version's. The
negative cases show the rejected single roundings failing: k ⊙ e^{lc_L −
lc} in the state update misses the state tolerance; P, S_c or the
rescaled q and k in the output pass pass the normwise y limit but change
far more than 2⁻¹⁰ of y's values."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JREF
from repro.models import ssm as JSSM
from repro_torch.kernels import chunk_scan
from repro_torch.models import ssm as TSSM

torch.set_num_threads(2)

BF16_ROUNDING = 2.0 ** -8
# chip_smoke.py's BF16_MISMATCH_TOL: the share of y's bf16 values that may
# differ from the plain version's
BF16_MISMATCH_TOL = 2.0 ** -10


def split3(x):
    """x (f32) as three bf16 values hi + mid + lo, each the bf16 rounding of
    what the earlier terms leave (the differences are exact in f32)."""
    hi = x.to(torch.bfloat16).float()
    r = x - hi
    mid = r.to(torch.bfloat16).float()
    lo = (r - mid).to(torch.bfloat16).float()
    return hi, mid, lo


def tc_mm(a, b, exact_a, exact_b, terms_a=3, terms_b=3):
    """a @ b as the tensor cores form it: bf16 products (exact in f32)
    summed in f32. An exact operand is one term; otherwise the first
    `terms_a` (`terms_b`) of its split: three, or one for the rejected
    single rounding. Products kept where the term orders sum to ≤ 2."""
    ta = [a] if exact_a else list(split3(a))[:terms_a]
    tb = [b] if exact_b else list(split3(b))[:terms_b]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i, x in enumerate(ta):
        for j, y in enumerate(tb):
            if i + j <= 2:
                out = out + x @ y
    return out


def state_pass(k, v, ld, chunk, s0, round_kh=False):
    """Entering states (B, H, chunks, K, V) and the final state, as the
    state pass forms them; `round_kh` rounds k ⊙ e^{lc_L − lc} to bf16 once
    (the rejected variant)."""
    b, t, h, kd = k.shape
    vd = v.shape[-1]
    s = (torch.zeros(b, h, kd, vd) if s0 is None else s0.clone())
    entering = []
    for c0 in range(0, t, chunk):
        kx, vx, lx = (x[:, c0:c0 + chunk].float() for x in (k, v, ld))
        n = kx.shape[1]
        if n < chunk:                       # the ragged tail: inert rows
            pad = chunk - n
            kx, vx, lx = (torch.nn.functional.pad(
                x, (0, 0) * (x.dim() - 2) + (0, pad)) for x in (kx, vx, lx))
        lc = torch.cumsum(lx, 1)
        if lc.dim() == 3:
            lc = lc[..., None]              # scalar decay: one column
        kh = kx * torch.exp(lc[:, -1:] - lc)
        if round_kh:
            kh = kh.to(torch.bfloat16).float()
        u = torch.einsum("blhk,blhv->bhkv", kh, vx)
        entering.append(s)
        s = s * torch.exp(lc[:, -1])[..., None] + u
    return torch.stack(entering, 2), s


SUB = 16   # a warp's query rows on the tensor cores: the sub-chunk


def _exact_scores(qx, kx, lq, lc, mask, rows, keys):
    """(B, H, rows, keys) per-channel scores pair by pair in f32, each
    exponent one difference, masked pairs 0."""
    diff = lq[:, rows, None] - lc[:, None, keys]            # (B,r,k,H,K)
    ex = torch.exp(torch.where(mask[rows, keys][None, :, :, None, None],
                               diff, torch.full_like(diff, -torch.inf)))
    return torch.einsum("blhk,bmhk,blmhk->bhlm", qx[:, rows], kx[:, keys],
                        ex)


def _split_scores(qx, kx, lq, lc, rows, keys, ref, qk_terms):
    """(B, H, rows, keys) per-channel scores through the reference point
    `ref` (B, 1, H, K), lq of the rows ≤ ref ≤ lc of the keys: q̃ = q ⊙
    e^{lq − ref} and k̃ = k ⊙ e^{ref − lc} (both exponents ≤ 0) on the
    tensor cores in `qk_terms` bf16 terms each."""
    qt = (qx[:, rows] * torch.exp(lq[:, rows] - ref)).permute(0, 2, 1, 3)
    kt = (kx[:, keys] * torch.exp(ref - lc[:, keys])).permute(0, 2, 3, 1)
    return tc_mm(qt, kt, False, False, qk_terms, qk_terms)


def per_channel_scores(qx, kx, lq, lc, mask, qk_terms=3):
    """(B, H, L, L) masked scores with per-channel decay as the tensor-core
    output pass forms them, sub-chunk by sub-chunk of SUB query rows. The
    keys before a sub-chunk go through the reference point r = lc of the
    row before it: e^{lq_i − lc_j} = e^{lq_i − r}·e^{r − lc_j}, both
    exponents ≤ 0 (`_split_scores`). The diagonal block splits once more
    at its 8th row: its lower-left 8 × 8 through r = lc of its row 7, its
    two 8 × 8 diagonal blocks pair by pair (`_exact_scores`)."""
    b, n, h, kd = qx.shape
    p = torch.zeros(b, h, n, n)
    for w0 in range(0, n, SUB):
        w1, wm = min(w0 + SUB, n), min(w0 + SUB // 2, n)
        for r_, k_ in ((slice(w0, wm), slice(w0, wm)),
                       (slice(wm, w1), slice(wm, w1))):
            p[:, :, r_, k_] = _exact_scores(qx, kx, lq, lc, mask, r_, k_)
        if wm < w1:
            p[:, :, wm:w1, w0:wm] = _split_scores(
                qx, kx, lq, lc, slice(wm, w1), slice(w0, wm),
                lc[:, wm - 1:wm], qk_terms)
        if w0 > 0:
            p[:, :, w0:w1, :w0] = _split_scores(
                qx, kx, lq, lc, slice(w0, w1), slice(0, w0),
                lc[:, w0 - 1:w0], qk_terms)
    return p


def output_pass(q, k, v, ld, chunk, bonus, entering, route, rounded=()):
    """y (B, T, H, V) f32 from the entering states: per chunk, the masked
    scores, P·v and (q ⊙ e^{lq})·S_c [+ the bonus diagonal]. `route`:
    "ffma" (every product in f32), "tc-scalar" (scalar decay, "post":
    q·kᵀ, P·v and q·S_c on the tensor cores) or "tc-per-channel"
    (`per_channel_scores`, then P·v and (q ⊙ e^{lq})·S_c on the tensor
    cores). `rounded` names the f32 operands taken as one bf16 term, not
    three: "p" (the scores), "s" (S_c), "qk" (the rescaled q and k of the
    per-channel route): the rejected variants."""
    b, t, h, kd = q.shape
    pre = bonus is not None
    terms = {name: 1 if name in rounded else 3 for name in ("p", "s", "qk")}
    ys = []
    for ci, c0 in enumerate(range(0, t, chunk)):
        qx, kx, vx, lx = (x[:, c0:c0 + chunk].float() for x in (q, k, v, ld))
        n = qx.shape[1]
        lc = torch.cumsum(lx, 1)
        per_channel = lc.dim() == 4
        if not per_channel:
            lc = lc[..., None]
        lq = torch.cat([torch.zeros_like(lc[:, :1]), lc[:, :-1]], 1) \
            if pre else lc
        idx = torch.arange(n)
        mask = idx[:, None] > idx[None, :] if pre else \
            idx[:, None] >= idx[None, :]
        s_c = entering[:, :, ci]                           # (B, H, K, V)
        qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (qx, kx, vx))
        if route == "tc-scalar":
            raw = tc_mm(qh, kh.transpose(-1, -2), True, True)   # (B,H,L,L)
            diff = (lq[..., 0][:, :, None] - lc[..., 0][:, None]).permute(
                0, 3, 1, 2)
            p = torch.where(mask, raw * torch.exp(torch.where(
                mask, diff, torch.zeros_like(diff))), torch.zeros_like(raw))
            y = tc_mm(p, vh, False, True, terms["p"])
            inter = tc_mm(qh, s_c, True, False, terms_b=terms["s"])
            y = y + torch.exp(lq[..., 0]).permute(0, 2, 1)[..., None] * inter
            ys.append(y.permute(0, 2, 1, 3))
            continue
        if route == "tc-per-channel":
            p = per_channel_scores(qx, kx, lq, lc, mask, terms["qk"])
            y = tc_mm(p, vh, False, True, terms["p"])
            qe = (qx * torch.exp(lq)).permute(0, 2, 1, 3)
            y = y + tc_mm(qe, s_c, False, False, terms["qk"], terms["s"])
            y = y.permute(0, 2, 1, 3)
        else:
            diff = lq[:, :, None] - lc[:, None]            # (B,L,L,H,K)
            ex = torch.exp(torch.where(mask[None, :, :, None, None], diff,
                                       torch.full_like(diff, -torch.inf)))
            if per_channel:
                p = torch.einsum("blhk,bmhk,blmhk->blmh", qx, kx, ex)
            else:
                p = torch.einsum("blhk,bmhk->blmh", qx, kx) * ex[..., 0]
            y = torch.einsum("blmh,bmhv->blhv", p, vx)
            y = y + torch.einsum("blhk,bhkv->blhv", qx * torch.exp(lq), s_c)
        if pre:
            y = y + torch.einsum("blhk,hk,blhk->blh", qx, bonus,
                                 kx)[..., None] * vx
        ys.append(y)
    return torch.cat(ys, 1)


def route(q, ld, bonus):
    """The output pass the kernel takes for these inputs."""
    tc = q.dtype == torch.bfloat16 and ld.dim() == 3 and bonus is None
    return "tc-scalar" if tc else "ffma"


def emulate(q, k, v, ld, *, chunk, bonus=None, initial_state=None,
            round_kh=False, rounded=(), route_as=None):
    """The kernel's arithmetic for one call: (y in v's dtype, final state).
    `round_kh` and `rounded` plant the rejected single roundings;
    `route_as` forces an output pass."""
    t = q.shape[1]
    chunk = min(chunk, t)
    entering, s = state_pass(k, v, ld, chunk, initial_state, round_kh)
    y = output_pass(q, k, v, ld, chunk, bonus, entering,
                    route_as or route(q, ld, bonus), rounded)
    return y.to(v.dtype), s


def _inputs(seed, b, t, h, kd, vd, per_channel, pre, init, strong,
            shared_qk):
    """numpy inputs as the models make them (see chip_smoke phase 13):
    q, k, v ~ N(0, 1); per-channel log decay −exp(N − 1), scalar
    −softplus(N); strong decay −exp(min(1.5·N + 1.5, 3)) per channel and
    −exp(min(N + 2, 3)) per head (down to −e³); `shared_qk` draws q and k
    once for all heads (the hybrid's head stride 0)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    qh = 1 if shared_qk else h
    x = dict(q=np.broadcast_to(rng.normal(size=(b, t, qh, kd)),
                               (b, t, h, kd)).astype(f32),
             k=np.broadcast_to(rng.normal(size=(b, t, qh, kd)),
                               (b, t, h, kd)).astype(f32),
             v=rng.normal(size=(b, t, h, vd)).astype(f32))
    shape = (b, t, h, kd) if per_channel else (b, t, h)
    z = rng.normal(size=shape)
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
    return x


def _torch(x, dtype, shared_qk):
    out = {}
    for name, val in x.items():
        if val is None:
            out[name] = None
            continue
        t = torch.from_numpy(np.ascontiguousarray(val))
        if name in ("q", "k", "v"):
            t = t.to(dtype)
            if shared_qk and name in ("q", "k"):
                t = t[:, :, :1].expand(val.shape)   # head stride 0
        out[name] = t
    return out


def _normwise(a, b):
    a, b = torch.as_tensor(np.array(a)).double(), \
        torch.as_tensor(np.array(b)).double()
    return float((a - b).norm() / b.norm())


# (name, B, T, H, K, V, chunk, per-channel, pre, initial state, strong,
#  q and k shared over the heads)
CASES = [
    ("rwkv6-like", 2, 96, 2, 32, 32, 32, True, True, False, False, False),
    ("rwkv6-ragged-s0", 1, 70, 2, 16, 24, 32, True, True, True, False,
     False),
    ("rwkv6-strong", 1, 64, 2, 16, 16, 32, True, True, True, True, False),
    ("mamba2-like", 2, 160, 3, 16, 16, 64, False, False, False, False,
     True),
    ("mamba2-ragged-s0", 1, 150, 2, 16, 32, 128, False, False, True, False,
     True),
    ("mamba2-strong", 1, 128, 2, 16, 16, 64, False, False, True, True,
     True),
    ("mamba2-k64", 1, 80, 1, 64, 64, 64, False, False, False, False, False),
    ("scalar-pre", 1, 60, 2, 16, 16, 32, False, True, True, False, False),
    ("per-channel-post", 1, 60, 2, 16, 16, 32, True, False, False, False,
     False),
    # a head of each model's full-width layer call (phase 13's shapes)
    ("rwkv6-head", 1, 512, 2, 64, 64, 32, True, True, False, False, False),
    ("zamba2-head", 1, 512, 2, 64, 64, 128, False, False, False, False,
     True),
]


ROUTES = [(case, dtype, None) for case in CASES
          for dtype in (torch.float32, torch.bfloat16)]
ROUTES += [(case, torch.bfloat16, "tc-per-channel") for case in CASES
           if case[7]]


@pytest.mark.parametrize("case,dtype,route_as", ROUTES,
                         ids=[f"{c[0]}-{str(d)[6:]}" + (f"-{r}" if r else "")
                              for c, d, r in ROUTES])
def test_emulation_matches_references(case, dtype, route_as):
    """The emulated kernel (and, per channel, the tensor-core route it does
    not take) against the JAX chunked formulation, the JAX recurrence and
    the port's plain version, within phase 13's bounds."""
    (_, b, t, h, kd, vd, chunk, per_channel, pre, init, strong,
     shared) = case
    x = _inputs(zlib.crc32(case[0].encode()), b, t, h, kd, vd, per_channel,
                pre, init, strong, shared)
    tx = _torch(x, dtype, shared)
    y, s = emulate(tx["q"], tx["k"], tx["v"], tx["log_decay"], chunk=chunk,
                   bonus=tx["bonus"], initial_state=tx["initial_state"],
                   route_as=route_as)
    assert torch.isfinite(y.float()).all() and torch.isfinite(s).all()
    # the references see the same (bf16-rounded) inputs, in f32
    ref_in = {k: None if v is None else
              (v.float().numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in tx.items()}
    j = {k: None if v is None else jnp.asarray(v) for k, v in ref_in.items()}
    yj, sj = JSSM.gla_chunked(j["q"], j["k"], j["v"], j["log_decay"],
                              chunk=chunk, bonus=j["bonus"],
                              initial_state=j["initial_state"])
    yr, sr = JREF.gla_recurrence_ref(j["q"], j["k"], j["v"],
                                     j["log_decay"], bonus=j["bonus"],
                                     initial_state=j["initial_state"])
    yp, sp = TSSM.gla_chunked_plain(tx["q"], tx["k"], tx["v"],
                                    tx["log_decay"], chunk=chunk,
                                    bonus=tx["bonus"],
                                    initial_state=tx["initial_state"])
    f32_tol = min(chunk, t) * kd * 2.0 ** -23
    y_tol = f32_tol + (BF16_ROUNDING if dtype == torch.bfloat16 else 0.0)
    for name, want_y, want_s in (("jax chunked", yj, sj),
                                 ("jax recurrence", yr, sr),
                                 ("plain", yp.float(), sp)):
        want_y = np.asarray(want_y, dtype=np.float32)
        if dtype == torch.bfloat16:   # both sides round once to bf16
            want_y = torch.from_numpy(want_y).bfloat16().float().numpy()
        assert _normwise(y.float(), want_y) <= y_tol, name
        assert _normwise(s, want_s) <= f32_tol, name
    if dtype == torch.bfloat16:
        assert float((y != yp).double().mean()) <= BF16_MISMATCH_TOL


ROUNDING_CASES = ("rwkv6-like", "mamba2-like", "mamba2-ragged-s0")


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c[0] in ROUNDING_CASES],
                         ids=lambda c: c[0])
def test_single_rounding_of_the_state_update_fails(case):
    """The rejected variant: k ⊙ e^{lc_L − lc} rounded once to bf16 (one
    tensor-core term) puts the state beyond L·K·2⁻²³ of the reference."""
    (_, b, t, h, kd, vd, chunk, per_channel, pre, init, strong,
     shared) = case
    x = _inputs(zlib.crc32(case[0].encode()), b, t, h, kd, vd, per_channel,
                pre, init, strong, shared)
    tx = _torch(x, torch.bfloat16, shared)
    _, s = emulate(tx["q"], tx["k"], tx["v"], tx["log_decay"], chunk=chunk,
                   bonus=tx["bonus"], initial_state=tx["initial_state"],
                   round_kh=True)
    j = {k: None if v is None else jnp.asarray(
        v.float().numpy() if isinstance(v, torch.Tensor) else v)
        for k, v in tx.items()}
    _, sr = JREF.gla_recurrence_ref(j["q"], j["k"], j["v"], j["log_decay"],
                                    bonus=j["bonus"],
                                    initial_state=j["initial_state"])
    assert _normwise(s, sr) > min(chunk, t) * kd * 2.0 ** -23


OPERAND_CASES = [(case, operand) for case in CASES
                 if case[0] in ("rwkv6-like", "mamba2-like", "rwkv6-head",
                                "zamba2-head")
                 for operand in (("p", "s", "qk") if case[7] else ("p", "s"))]


@pytest.mark.parametrize("case,operand", OPERAND_CASES,
                         ids=[f"{c[0]}-{o}" for c, o in OPERAND_CASES])
def test_single_rounding_of_an_output_operand_fails(case, operand):
    """The rejected variants of the tensor-core output pass (per channel,
    of the "tc-per-channel" route): P, S_c or the rescaled q and k rounded
    once to bf16 (one term, not three). Each stays within phase 13's
    normwise y limit, and each changes more than BF16_MISMATCH_TOL of y's
    bf16 values against the plain version, as the routes with three terms
    do not (`test_emulation_matches_references`)."""
    (_, b, t, h, kd, vd, chunk, per_channel, pre, init, strong,
     shared) = case
    x = _inputs(zlib.crc32(case[0].encode()), b, t, h, kd, vd, per_channel,
                pre, init, strong, shared)
    tx = _torch(x, torch.bfloat16, shared)
    y, _ = emulate(tx["q"], tx["k"], tx["v"], tx["log_decay"], chunk=chunk,
                   bonus=tx["bonus"], initial_state=tx["initial_state"],
                   rounded=(operand,),
                   route_as="tc-per-channel" if per_channel else None)
    yp, _ = TSSM.gla_chunked_plain(tx["q"], tx["k"], tx["v"],
                                   tx["log_decay"], chunk=chunk,
                                   bonus=tx["bonus"],
                                   initial_state=tx["initial_state"])
    y_tol = min(chunk, t) * kd * 2.0 ** -23 + BF16_ROUNDING
    assert _normwise(y.float(), yp.float()) <= y_tol
    assert float((y != yp).double().mean()) > BF16_MISMATCH_TOL


def test_reference_points_keep_exponents_nonpositive():
    """Every exponent the per-channel split takes is ≤ 0, so no factor
    overflows, down to the strong decay's −e³ a token: lq of a sub-chunk's
    rows lies at or below the reference point, lc of the keys before it at
    or above."""
    x = _inputs(7, 1, 128, 2, 16, 16, True, True, False, True, False)
    ld = torch.from_numpy(x["log_decay"])
    for pre in (True, False):
        lc = torch.cumsum(ld[:, :32], 1)
        lq = torch.cat([torch.zeros_like(lc[:, :1]), lc[:, :-1]], 1) \
            if pre else lc
        for w0 in range(8, 32, 8):
            ref = lc[:, w0 - 1:w0]
            assert (lq[:, w0:] - ref <= 0).all()
            assert (ref - lc[:, :w0] <= 0).all()


def test_split3_is_exact_to_f32():
    """hi + mid + lo recovers an f32 value to within 2⁻²⁴ of itself, and a
    bf16 value is its own hi."""
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32)) * 37.0
    hi, mid, lo = split3(x)
    assert ((hi + mid + lo - x).abs() <= x.abs() * 2.0 ** -24).all()
    xb = x.to(torch.bfloat16).float()
    hb, mb, lb = split3(xb)
    assert torch.equal(hb, xb) and not mb.any() and not lb.any()


@pytest.mark.parametrize("t,chunk", [(512, 32), (500, 128), (70, 128),
                                     (1, 32)])
def test_workspace_sizes(t, chunk):
    """The workspaces the wrapper allocates: one K×V state and one K decay
    per chunk and (b, h)."""
    b, h, kd, vd = 2, 3, 48, 40
    n_ws, n_dws = chunk_scan.workspace_floats(b, t, h, kd, vd, chunk)
    chunks = -(-t // min(chunk, t))
    assert n_ws == b * h * chunks * kd * vd
    assert n_dws == b * h * chunks * kd


def test_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper takes no CPU tensor (the CPU route is the plain
    version); it raises before building or loading anything."""
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError):
        chunk_scan.gla_chunk_f32(q, q, q, torch.zeros(1, 4, 2), chunk=4)
