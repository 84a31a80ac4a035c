"""State-space sequence mixers: Mamba2 (SSD) and RWKV6 (Finch) (port of
``repro/models/ssm.py``).

Both are instances of a gated-linear-attention recurrence over a matrix
state S ∈ R^{K×V} per head:

    S_t = D_t ⊙ S_{t-1} + k_tᵀ v_t          (D_t: decay, scalar or per K)
    y_t = q_t · S_t                           ("post" convention, Mamba2)
    y_t = q_t · (S_{t-1} + diag(u) k_tᵀ v_t)  ("pre" + bonus u, RWKV6)

Prefill and the full-sequence forward use the chunked formulation
(`gla_chunked`); decode is the one-step recurrence (`gla_step`), plain
PyTorch as in the reference. `gla_chunked` routes by device: on a CUDA
tensor it runs `kernels/chunk_scan.GLAChunked`, the GLA chunk kernel (one
launch a call) with the GLA backward kernel as its gradient; on a CPU
tensor it runs
`gla_chunked_plain`, the reference's formulation (under grad through
autograd, as the reference through `jax.grad`), which is also the
kernel's plain version on the card. `gla_chunked_bwd_plain` is the
backward kernel's plain version. Parameters are name → tensor dicts in
the reference's leaf names; the f32 leaves (``A_log``, ``dt_bias``, ``D``, ``w_decay_base``,
``bonus_u``) stay f32 in a bf16 model, as the reference's init makes
them."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.chunk_scan import GLAChunked
from repro_torch.models.base import Params
from repro_torch.models.layers import (ACC, _he, _proj, rms_norm,
                                       rms_norm_init)

# ---------------------------------------------------------------------------
# Core chunked GLA
# ---------------------------------------------------------------------------


def _compute_dtype(x):
    return torch.float64 if x.dtype == torch.float64 else ACC


def _pad_time(x, pad):
    """x (B, T, …) with `pad` zero rows appended along T."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad)) if pad else x


def gla_chunked_plain(q, k, v, log_decay, *, chunk: int, bonus=None,
                      initial_state=None):
    """The reference's chunked formulation (`models/ssm.gla_chunked`), on
    any device: a loop over chunks of min(chunk, T) tokens, f32 throughout,
    with the pairwise decay taken as differences of the running log-decay
    sums (every exponent ≤ 0). A ragged T is zero-padded: k = v = 0 adds
    nothing and log_decay = 0 leaves the state as it is. Shapes as in
    `gla_chunked`."""
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    per_channel = log_decay.dim() == 4
    chunk = min(chunk, t)
    pad = (-t) % chunk
    q, k, v, log_decay = (_pad_time(x, pad) for x in (q, k, v, log_decay))
    nc = (t + pad) // chunk
    qf, kf, vf, ldf = (x.to(ACC) for x in (q, k, v, log_decay))
    if not per_channel:
        ldf = ldf[..., None]                         # (B, T, H, 1)
    s = (torch.zeros((b, h, kd, vd), dtype=ACC, device=q.device)
         if initial_state is None else initial_state.to(ACC))
    pre = bonus is not None
    if pre:
        bonus = bonus.to(ACC)
    idx = torch.arange(chunk, device=q.device)
    mask = (idx[:, None] > idx[None, :]) if pre else \
        (idx[:, None] >= idx[None, :])               # (L, L): j ≤ i or j < i
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        qx, kx, vx, ld = qf[:, sl], kf[:, sl], vf[:, sl], ldf[:, sl]
        lc = torch.cumsum(ld, dim=1)                 # inclusive
        lq = torch.cat([torch.zeros_like(lc[:, :1]), lc[:, :-1]], dim=1) \
            if pre else lc                           # exponent of the q side

        # inter-chunk: y_i += (q_i ⊙ e^{lq_i}) · S
        y = torch.einsum("blhk,bhkv->blhv", qx * torch.exp(lq), s)

        # intra-chunk
        if per_channel:
            diff = lq[:, :, None] - lc[:, None, :]   # (B, L, L, H, K)
            ex = torch.exp(torch.where(mask[None, :, :, None, None], diff,
                                       torch.full_like(diff, -torch.inf)))
            sc = torch.einsum("blhk,bmhk,blmhk->blmh", qx, kx, ex)
        else:
            diff = lq[:, :, None, :, 0] - lc[:, None, :, :, 0]  # (B,L,L,H)
            ex = torch.exp(torch.where(mask[None, :, :, None], diff,
                                       torch.full_like(diff, -torch.inf)))
            sc = torch.einsum("blhk,bmhk->blmh", qx, kx) * ex
        y = y + torch.einsum("blmh,bmhv->blhv", sc, vx)
        if pre:                                      # current-token bonus
            y = y + torch.einsum("blhk,hk,blhk->blh", qx, bonus,
                                 kx)[..., None] * vx

        # state: S' = e^{lc_L} ⊙ S + Σ_j e^{lc_L − lc_j} k_jᵀ v_j
        k_eff = kx * torch.exp(lc[:, -1:] - lc)      # exponents ≤ 0
        s = s * torch.exp(lc[:, -1])[..., None] + torch.einsum(
            "blhk,blhv->bhkv", k_eff, vx)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :t]
    return y.to(v.dtype), s


def gla_chunk_states_plain(k, v, log_decay, *, chunk: int,
                           initial_state=None):
    """The state each chunk of min(chunk, T) tokens enters with, (B·H,
    chunks, K, V), by the forward's recurrence over the chunks (f64 for
    f64 inputs, else f32): the layout the GLA kernel's workspace hands to
    its backward (`gla_chunk_f32(..., return_states=True)`)."""
    b, t, h, kd = k.shape
    vd = v.shape[-1]
    dt = _compute_dtype(k)
    chunk = min(chunk, t)
    pad = (-t) % chunk
    kf, vf, ldf = (_pad_time(x.to(dt), pad) for x in (k, v, log_decay))
    if log_decay.dim() == 3:
        ldf = ldf[..., None]
    s = (torch.zeros((b, h, kd, vd), dtype=dt, device=k.device)
         if initial_state is None else initial_state.to(dt))
    out = []
    for c0 in range(0, t + pad, chunk):
        kx, vx = kf[:, c0:c0 + chunk], vf[:, c0:c0 + chunk]
        lc = torch.cumsum(ldf[:, c0:c0 + chunk], dim=1)
        out.append(s)
        s = s * torch.exp(lc[:, -1])[..., None] + torch.einsum(
            "blhk,blhv->bhkv", kx * torch.exp(lc[:, -1:] - lc), vx)
    return torch.stack(out, 2).reshape(b * h, len(out), kd, vd)


def gla_chunked_bwd_plain(q, k, v, log_decay, dy, *, chunk: int,
                          bonus=None, initial_state=None, states=None):
    """The gradient of `gla_chunked` with respect to q, k, v, log_decay
    and the bonus under the cotangent dy of y (none for the final state):
    the GLA backward kernel's plain version, by its formulas in chunks of
    min(chunk, T) tokens, f32 throughout (f64 for f64 inputs: the card's
    oracle for the kernel's f32 route). With lc the running log decay in
    a chunk, lq = lc (or lc shifted by one under "pre"), S_c the state
    chunk c enters with (`states`, or the forward's recurrence from
    `initial_state`) and dS_{c+1} the cotangent of the state it leaves
    with (0 after the last chunk):
    - reverse state pass: dS_c = e^{lc_L} ⊙ dS_{c+1} + Σ_i (q_i ⊙
      e^{lq_i})ᵀ dy_i;
    - per chunk, dq = e^{lq} ⊙ (dy·S_cᵀ) + intra-chunk terms, dk = e^{lc_L
      − lc} ⊙ (v·dS_{c+1}ᵀ) + intra-chunk terms, dv = (k ⊙ e^{lc_L −
      lc})·dS_{c+1} + Σ_i s_ij dy_i, each pair's exponent one difference
      ≤ 0, and under "pre" the bonus diagonal;
    - the decay: with G the running log decay over the whole sequence,
      ∂/∂G_t = q_t ⊙ dq_t − k_t ⊙ dk_t ("post") or q_{t+1} ⊙ dq_{t+1} −
      k_t ⊙ dk_t ("pre"), dq and dk without the bonus terms, and
      d log_decay_t its reverse running sum (over K for a scalar decay):
      inside the chunk token by token, and over every later chunk at
      once as ⟨dS_{c+1}, S_{c+1}⟩ (over V: the sum's own value, since
      raising G from the next chunk on scales the state it enters with;
      under "pre" that includes q_{t+1} ⊙ dq_{t+1} of the next chunk's
      first token). A running sum over all T tokens in f32 puts T·2⁻²⁴ of
      its partial sums into the gradient of anything that sums the decay
      gradient over T (Mamba2's A_log);
    - d bonus = Σ_{b,t} q_t ⊙ k_t (dy_t·v_t).
    Returns (dq, dk, dv in q's, k's and v's dtypes; d log_decay and d
    bonus (H, K) in the compute dtype, d bonus None without a bonus)."""
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    dt = _compute_dtype(q)
    per_channel = log_decay.dim() == 4
    chunk = min(chunk, t)
    pad = (-t) % chunk
    nc = (t + pad) // chunk
    qf, kf, vf, ldf, dyf = (_pad_time(x.to(dt), pad)
                            for x in (q, k, v, log_decay, dy))
    if not per_channel:
        ldf = ldf[..., None]                         # (B, T, H, 1)
    if states is None:
        states = gla_chunk_states_plain(k, v, log_decay, chunk=chunk,
                                        initial_state=initial_state)
    S = states.to(dt).reshape(b, h, nc, kd, vd)
    pre = bonus is not None
    u = bonus.to(dt) if pre else None
    idx = torch.arange(chunk, device=q.device)
    mask = (idx[:, None] > idx[None, :]) if pre else \
        (idx[:, None] >= idx[None, :])               # (L, L): j ≤ i or j < i

    def chunk_of(c):
        sl = slice(c * chunk, (c + 1) * chunk)
        qx, kx, vx, dyx = qf[:, sl], kf[:, sl], vf[:, sl], dyf[:, sl]
        lc = torch.cumsum(ldf[:, sl], dim=1)         # inclusive
        lq = torch.cat([torch.zeros_like(lc[:, :1]), lc[:, :-1]], dim=1) \
            if pre else lc
        return qx, kx, vx, dyx, lc, lq

    # reverse state pass: dS_out[c], the cotangent of the state chunk c
    # leaves with
    dS_out, g = [None] * nc, torch.zeros((b, h, kd, vd), dtype=dt,
                                         device=q.device)
    for c in reversed(range(nc)):
        qx, _, _, dyx, lc, lq = chunk_of(c)
        dS_out[c] = g
        g = torch.exp(lc[:, -1])[..., None] * g + torch.einsum(
            "blhk,blhv->bhkv", qx * torch.exp(lq), dyx)

    dqs, dks, dvs, dlds = [], [], [], []
    for c in range(nc):
        qx, kx, vx, dyx, lc, lq = chunk_of(c)
        dp = torch.einsum("blhv,bmhv->blmh", dyx, vx)    # (B, L, L, H)
        if per_channel:
            diff = lq[:, :, None] - lc[:, None, :]       # (B, L, L, H, K)
            ex = torch.exp(torch.where(mask[None, :, :, None, None], diff,
                                       torch.full_like(diff, -torch.inf)))
            sc = torch.einsum("blhk,bmhk,blmhk->blmh", qx, kx, ex)
            dq_in = torch.einsum("blmh,bmhk,blmhk->blhk", dp, kx, ex)
            dk_in = torch.einsum("blmh,blhk,blmhk->bmhk", dp, qx, ex)
        else:
            diff = lq[:, :, None, :, 0] - lc[:, None, :, :, 0]  # (B,L,L,H)
            ex = torch.exp(torch.where(mask[None, :, :, None], diff,
                                       torch.full_like(diff, -torch.inf)))
            sc = torch.einsum("blhk,bmhk->blmh", qx, kx) * ex
            dpe = dp * ex
            dq_in = torch.einsum("blmh,bmhk->blhk", dpe, kx)
            dk_in = torch.einsum("blmh,blhk->bmhk", dpe, qx)
        k_dec = torch.exp(lc[:, -1:] - lc)               # exponents ≤ 0
        dq_c = torch.exp(lq) * torch.einsum(
            "blhv,bhkv->blhk", dyx, S[:, :, c]) + dq_in
        dk_c = k_dec * torch.einsum("bhkv,blhv->blhk", dS_out[c], vx) + \
            dk_in
        dv_c = torch.einsum("blhk,bhkv->blhv", kx * k_dec, dS_out[c]) + \
            torch.einsum("blmh,blhv->bmhv", sc, dyx)
        # the decay: q ⊙ dq − k ⊙ dk (q one token on under "pre"), summed
        # back to each token inside the chunk, plus the chunk's carry, the
        # sum over every later token: ⟨dS_{c+1}, S_{c+1}⟩ (over V, and K
        # for a scalar decay)
        a, bk = qx * dq_c, kx * dk_c
        if not per_channel:
            a, bk = a.sum(-1, keepdim=True), bk.sum(-1, keepdim=True)
        if pre:
            a = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        r = torch.flip(torch.cumsum(torch.flip(a - bk, [1]), 1), [1])
        if c + 1 < nc:
            carry = (dS_out[c] * S[:, :, c + 1]).sum(-1)    # (B, H, K)
            if not per_channel:
                carry = carry.sum(-1, keepdim=True)
            r = r + carry[:, None]
        dlds.append(r)
        if pre:                                          # bonus diagonal
            dg = torch.einsum("blhv,blhv->blh", dyx, vx)[..., None]
            dq_c = dq_c + u * kx * dg
            dk_c = dk_c + u * qx * dg
            dv_c = dv_c + torch.einsum("blhk,hk,blhk->blh", qx, u,
                                       kx)[..., None] * dyx
        dqs.append(dq_c)
        dks.append(dk_c)
        dvs.append(dv_c)

    def whole(xs):
        return torch.cat(xs, dim=1)[:, :t]
    dld = whole(dlds)
    if not per_channel:
        dld = dld[..., 0]
    dbonus = None
    if pre:
        dgt = torch.einsum("bthv,bthv->bth", dyf[:, :t], vf[:, :t])
        dbonus = torch.einsum("bthk,bthk,bth->hk", qf[:, :t], kf[:, :t],
                              dgt)
    return (whole(dqs).to(q.dtype), whole(dks).to(k.dtype),
            whole(dvs).to(v.dtype), dld, dbonus)


def gla_chunked(q, k, v, log_decay, *, chunk: int, bonus=None,
                initial_state=None):
    """Chunked gated linear attention.

    q, k: (B, T, H, K); v: (B, T, H, V).
    log_decay: (B, T, H) scalar per head or (B, T, H, K) per channel, ≤ 0.
    bonus: None → post convention (Mamba2); (H, K) → pre convention with
    the current-token bonus (RWKV6).
    Returns y (B, T, H, V) in v's dtype and the final state (B, H, K, V)
    in f32. CUDA: `GLAChunked`, the GLA chunk kernel (one launch) with
    the GLA backward kernel as its gradient (one launch); CPU:
    `gla_chunked_plain`."""
    if q.device.type == "cuda":
        return GLAChunked.apply(q, k, v, log_decay, bonus, initial_state,
                                chunk)[:2]
    if q.device.type == "cpu":
        return gla_chunked_plain(q, k, v, log_decay, chunk=chunk,
                                 bonus=bonus, initial_state=initial_state)
    raise ValueError(f"gla_chunked: no route for tensors on {q.device}")


def gla_step(q, k, v, log_decay, state, *, bonus=None):
    """One-token recurrence. q, k: (B, H, K); v: (B, H, V); log_decay
    (B, H) or (B, H, K); state (B, H, K, V) f32."""
    q, k, v32 = q.to(ACC), k.to(ACC), v.to(ACC)
    if log_decay.dim() == 2:                         # scalar per head
        log_decay = log_decay[..., None]
    d = torch.exp(log_decay.to(ACC))[..., None]      # (B, H, K, 1)
    kv = k[..., None] * v32[..., None, :]            # (B, H, K, V)
    if bonus is None:
        state = d * state + kv
        y = torch.einsum("bhk,bhkv->bhv", q, state)
    else:
        y = torch.einsum("bhk,bhkv->bhv", q,
                         state + bonus.to(ACC)[None, :, :, None] * kv)
        state = d * state + kv
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

class Mamba2Dims(NamedTuple):
    d_inner: int
    n_heads: int
    head_dim: int
    state: int
    conv_width: int


def mamba2_dims(cfg) -> Mamba2Dims:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return Mamba2Dims(d_inner, d_inner // s.head_dim, s.head_dim,
                      s.state_size, s.conv_width)


def mamba2_init(gen: torch.Generator, cfg, dtype, lead=()) -> Params:
    """Mamba2 mixer weights in the reference's leaf names: He-normal
    projections and conv (fan-in = the input dim, the conv width), f32
    A_log = 0, dt_bias = 0, D = 1, unit norm scales; `lead` stacks them."""
    dm = mamba2_dims(cfg)
    d, lead, dev = cfg.d_model, tuple(lead), gen.device
    conv_dim = dm.d_inner + 2 * dm.state
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "A_log": torch.zeros(lead + (dm.n_heads,), **f32),
        "D": torch.ones(lead + (dm.n_heads,), **f32),
        "conv_w": _he(gen, lead + (dm.conv_width, conv_dim), dtype,
                      fan_in=dm.conv_width),
        "dt_bias": torch.zeros(lead + (dm.n_heads,), **f32),
        "norm.scale": rms_norm_init(dm.d_inner, dtype, dev, lead)["scale"],
        # in_proj -> [z, x, B, C, dt]
        "w_in": _he(gen, lead + (d, 2 * dm.d_inner + 2 * dm.state +
                                 dm.n_heads), dtype, fan_in=d),
        "w_out": _he(gen, lead + (dm.d_inner, d), dtype, fan_in=dm.d_inner),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B, T, C); w: (W, C); state: (B, W-1, C)
    or None. Returns (out, new state)."""
    width = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, width - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    t = x.shape[1]
    out = xp[:, 0:t] * w[0].to(x.dtype)
    for i in range(1, width):
        out = out + xp[:, i:i + t] * w[i].to(x.dtype)
    new_state = xp[:, -(width - 1):] if width > 1 else None
    return out, new_state


def _mamba2_qkvd(p: Params, cfg, x, conv_state=None):
    dm = mamba2_dims(cfg)
    b, t, _ = x.shape
    proj = _proj(x, p["w_in"])
    z, xbc, dt = torch.split(
        proj, [dm.d_inner, dm.d_inner + 2 * dm.state, dm.n_heads], dim=-1)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], conv_state)
    xbc = F.silu(xbc)
    xs, bm, cm = torch.split(xbc, [dm.d_inner, dm.state, dm.state], dim=-1)
    dt = F.softplus(dt.to(ACC) + p["dt_bias"])                    # (B,T,H)
    a = -torch.exp(p["A_log"])                                    # (H,) < 0
    log_decay = dt * a                                            # ≤ 0
    xh = xs.reshape(b, t, dm.n_heads, dm.head_dim)
    k = bm[:, :, None, :].expand(b, t, dm.n_heads, dm.state)
    q = cm[:, :, None, :].expand(b, t, dm.n_heads, dm.state)
    v = (xh.to(ACC) * dt[..., None]).to(x.dtype)
    return q, k, v, log_decay, xh, z, new_conv


def _mamba2_out(p: Params, cfg, x, y, xh, z):
    """The mixer's output from the GLA's y: the D skip, the gated norm and
    the out projection."""
    dm = mamba2_dims(cfg)
    b, t, _ = x.shape
    y = y + xh * p["D"][None, None, :, None].to(x.dtype)
    y = y.reshape(b, t, dm.d_inner)
    y = rms_norm(p["norm.scale"], y * F.silu(z), cfg.norm_eps)
    return _proj(y, p["w_out"])


def mamba2_block(p: Params, cfg, x):
    """Full-sequence Mamba2 mixer. x: (B, T, D) -> (B, T, D)."""
    t = x.shape[1]
    q, k, v, log_decay, xh, z, _ = _mamba2_qkvd(p, cfg, x)
    y, _ = gla_chunked(q, k, v, log_decay, chunk=min(cfg.ssm.chunk_size, t))
    return _mamba2_out(p, cfg, x, y, xh, z)


def mamba2_decode(p: Params, cfg, x, ssm_state, conv_state):
    """One-token step. x: (B, 1, D); ssm_state: (B, H, N, P) f32;
    conv_state (B, W-1, conv_dim). Returns (out, ssm state, conv state)."""
    q, k, v, log_decay, xh, z, new_conv = _mamba2_qkvd(p, cfg, x, conv_state)
    y, new_state = gla_step(q[:, 0], k[:, 0], v[:, 0], log_decay[:, 0],
                            ssm_state)
    return _mamba2_out(p, cfg, x, y[:, None], xh, z), new_state, new_conv


# ---------------------------------------------------------------------------
# RWKV6 block (Finch): data-dependent per-channel decay via LoRA.
# ---------------------------------------------------------------------------

RWKV_LORA = 64


def rwkv6_init(gen: torch.Generator, cfg, dtype, lead=()) -> Params:
    """RWKV6 time-mix weights in the reference's leaf names: token-shift
    lerps 0.5, He-normal projections, the decay LoRA (b ~ N(0, 0.01²)),
    f32 w_decay_base = −2 and bonus_u = 0, unit norm scale; `lead`
    stacks them."""
    d = cfg.d_model
    s = cfg.ssm
    n_heads = d // s.head_dim
    lead, dev = tuple(lead), gen.device
    lora_b = torch.randn(lead + (RWKV_LORA, d), generator=gen, device=dev,
                         dtype=ACC) * 0.01
    return {
        "bonus_u": torch.zeros(lead + (n_heads, s.head_dim),
                               dtype=torch.float32, device=dev),
        "ln_x.scale": rms_norm_init(d, dtype, dev, lead)["scale"],
        "mix": torch.full(lead + (5, d), 0.5, dtype=dtype, device=dev),
        "w_decay_base": torch.full(lead + (d,), -2.0, dtype=torch.float32,
                                   device=dev),
        "w_g": _he(gen, lead + (d, d), dtype, fan_in=d),
        "w_k": _he(gen, lead + (d, d), dtype, fan_in=d),
        "w_lora_a": _he(gen, lead + (d, RWKV_LORA), dtype, fan_in=d),
        "w_lora_b": lora_b.to(dtype),
        "w_o": _he(gen, lead + (d, d), dtype, fan_in=d),
        "w_r": _he(gen, lead + (d, d), dtype, fan_in=d),
        "w_v": _he(gen, lead + (d, d), dtype, fan_in=d),
    }


def _rwkv6_inputs(p: Params, cfg, x, x_prev):
    """x: (B, T, D); x_prev: (B, 1, D), the last token of the previous
    segment. Returns r, k, v (B, T, H, K), the gate g (B, T, D), the log
    decay (B, T, H, K) ≤ 0 and x's last token."""
    s = cfg.ssm
    d = cfg.d_model
    b, t, _ = x.shape
    h = d // s.head_dim
    shifted = torch.cat([x_prev.to(x.dtype), x[:, :-1]], dim=1)
    mix = p["mix"].to(ACC)
    xf, sf = x.to(ACC), shifted.to(ACC)
    mr, mk, mv, mw, mg = [(xf * mix[i] + sf * (1 - mix[i])).to(x.dtype)
                          for i in range(5)]
    r = _proj(mr, p["w_r"]).reshape(b, t, h, s.head_dim)
    k = _proj(mk, p["w_k"]).reshape(b, t, h, s.head_dim)
    v = _proj(mv, p["w_v"]).reshape(b, t, h, s.head_dim)
    g = F.silu(_proj(mg, p["w_g"]))
    # data-dependent decay (the Finch contribution): w = -exp(base + lora)
    lora = torch.tanh(mw.to(ACC)) @ p["w_lora_a"].to(ACC) @ \
        p["w_lora_b"].to(ACC)
    log_decay = -torch.exp(p["w_decay_base"] + lora)             # ≤ 0
    log_decay = log_decay.reshape(b, t, h, s.head_dim)
    return r, k, v, g, log_decay, x[:, -1:]


def _rwkv6_out(p: Params, cfg, x, y, g):
    b, t, d = x.shape
    y = rms_norm(p["ln_x.scale"], y.reshape(b, t, d), cfg.norm_eps) * g
    return _proj(y, p["w_o"])


def rwkv6_block(p: Params, cfg, x, x_prev: Optional[torch.Tensor] = None):
    """Full-sequence RWKV6 time mix. x: (B, T, D) -> (B, T, D)."""
    t = x.shape[1]
    if x_prev is None:
        x_prev = torch.zeros_like(x[:, :1])
    r, k, v, g, log_decay, _ = _rwkv6_inputs(p, cfg, x, x_prev)
    y, _ = gla_chunked(r, k, v, log_decay, chunk=min(32, t),
                       bonus=torch.exp(p["bonus_u"]))
    return _rwkv6_out(p, cfg, x, y, g)


def rwkv6_decode(p: Params, cfg, x, state, x_prev):
    """x: (B, 1, D); state: (B, H, K, V) f32; x_prev: (B, 1, D). Returns
    (out, state, x's token as the next x_prev)."""
    r, k, v, g, log_decay, new_prev = _rwkv6_inputs(p, cfg, x, x_prev)
    y, new_state = gla_step(r[:, 0], k[:, 0], v[:, 0], log_decay[:, 0], state,
                            bonus=torch.exp(p["bonus_u"]))
    return _rwkv6_out(p, cfg, x, y[:, None], g), new_state, new_prev
