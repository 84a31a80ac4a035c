"""Plain PyTorch versions of the kernels' functions (port of the matching
oracles in ``repro/kernels/ref.py``). They are the CPU path and the
ground truth the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 GEMM ground truth for the GEMM kernel (`gemm_ref`)."""
    return a.float() @ b.float()


gemm_ref = matmul_ref


def conv2d_ref(x: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """SAME stride-1 NHWC conv with HWIO weights via `F.conv2d` — the
    independent oracle for `local_step.conv2d_gemm`. On a CUDA tensor it
    runs with cuDNN's TF32 off, so it stays an f32 reference, and with
    deterministic algorithms and no benchmark search, so it repeats bit
    for bit. These flags hold for the forward only: a caller that
    differentiates it holds the same flags around its `autograd.grad`
    (`models.cnn.native_conv_flags`)."""
    with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                    deterministic=True, allow_tf32=False):
        y = F.conv2d(x.float().permute(0, 3, 1, 2),
                     w.float().permute(3, 2, 0, 1), padding="same")
    return y.permute(0, 2, 3, 1) + b


def maxpool2x2_ref(x: torch.Tensor) -> torch.Tensor:
    """Non-overlapping 2×2 max pool (NHWC) via `F.max_pool2d` — forward
    oracle for `local_step.maxpool2x2` (its gradient picks one element on
    ties, so it is a forward-only reference)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def sgd_update_ref(p: torch.Tensor, g: torch.Tensor, *, lr: float,
                   wd: float = 0.0) -> torch.Tensor:
    """p − lr·(g + wd·p) in f32 — the SGD kernel's plain version. Written
    as two `torch.add(…, alpha=)` so each step rounds once, as an FMA:
    that is how XLA's CPU update and the kernel round (bitwise equal to
    both; separate multiply and add would differ in the last bit)."""
    p32 = p.float()
    return torch.add(p32, torch.add(g.float(), p32, alpha=wd),
                     alpha=-lr).to(p.dtype)


NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Dense softmax attention with f32 scores, out in q's dtype — the
    flash-attention kernel's plain version. q: (B, Tq, H, hd); k, v:
    (B, Tk, KV, hd); query head h reads kv head h // (H / KV)."""
    g = q.shape[2] // k.shape[2]
    s = _scaled_scores(q, k, torch.float32)
    mask = _attention_mask(q.shape[1], k.shape[1], causal, window, q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    vf = v.float().repeat_interleave(g, dim=2)
    return torch.einsum("bhts,bshd->bthd", p, vf).to(q.dtype)


def _attention_mask(tq, tk, causal, window, device):
    q_pos = torch.arange(tq, device=device)[:, None]
    k_pos = torch.arange(tk, device=device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=device)
    if causal:
        mask &= q_pos >= k_pos
    if window:
        mask &= q_pos - k_pos < window
    return mask


def _scaled_scores(q, k, dt):
    """scale·q·kᵀ per query head, (B, H, Tq, Tk) in `dt`, kv heads
    repeated over their group."""
    hd = q.shape[-1]
    g = q.shape[2] // k.shape[2]
    kf = k.to(dt).repeat_interleave(g, dim=2)
    return torch.einsum("bthd,bshd->bhts", q.to(dt) * hd ** -0.5, kf)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int = 0) -> torch.Tensor:
    """The log-sum-exp of each query row's scaled, masked scores, (B, H,
    Tq) in f32 (f64 for f64 inputs): the forward kernel's ``lse`` output.
    A row with no valid key reads +inf, the kernel's sentinel (its P is
    exactly 0 in the backward)."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = _scaled_scores(q, k, dt)
    mask = _attention_mask(q.shape[1], k.shape[1], causal, window, q.device)
    lse = torch.logsumexp(torch.where(mask, s, torch.full_like(s, NEG_INF)),
                          dim=-1)
    return torch.where(mask.any(-1), lse, torch.full_like(lse, torch.inf))


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: int = 0):
    """The attention backward kernel's plain version: (dq, dk, dv) of
    `attention_ref` at `out` (its output) and `lse` (`attention_lse_ref`,
    or the forward kernel's), for the output gradient `dout`, by the
    explicit formulas

        D = rowsum(dO∘O),  P = exp(S − lse) on valid keys (0 elsewhere),
        dV = Σ_group Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP − D),
        dQ = scale·dS·K,  dK = scale·Σ_group dSᵀ·Q,

    with S the scaled scores and scale = hd^-1/2 (hd q's and k's head
    dim; v, out and dout may be narrower, dv, as MLA's). In f32 (f64 for f64
    inputs), returned in that type; a row with no valid key (lse = +inf)
    has P = 0, so its dq is 0 and it adds nothing to dk and dv."""
    dt = torch.float64 if q.dtype == torch.float64 else torch.float32
    b, tq, h, hd = q.shape
    tk, n_kv = k.shape[1], k.shape[2]
    g = h // n_kv
    scale = hd ** -0.5
    s = _scaled_scores(q, k, dt)
    mask = _attention_mask(tq, tk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - lse.to(dt)[..., None]),
                    torch.zeros_like(s))
    do, o = dout.to(dt), out.to(dt)
    kf = k.to(dt).repeat_interleave(g, dim=2)
    vf = v.to(dt).repeat_interleave(g, dim=2)
    d = torch.sum(do * o, dim=-1).transpose(1, 2)            # (B, H, Tq)
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    dp = torch.einsum("bthd,bshd->bhts", do, vf)
    ds = p * (dp - d[..., None])
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, q.to(dt))
    return (dq, dk.reshape(b, tk, n_kv, g, hd).sum(3),
            dv.reshape(b, tk, n_kv, g, v.shape[3]).sum(3))


def abs_ref(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's derivative, +1 at x == 0 (`torch.abs` gives 0 there),
    so that autograd of the plain sweep is the reference's gradient."""
    return torch.where(x >= 0, x, -x)


def pool_distance_ref(w_flat: torch.Tensor,
                      pool_flat: torch.Tensor) -> dict:
    """Per-member stats over flattened params, w (P,) and pool (C, P) →
    sq, l1, dot, norm each (C,) in f32."""
    w = w_flat.float()
    m = pool_flat.float()
    r = w[None, :] - m
    return {"sq": torch.sum(r * r, dim=1),
            "l1": torch.sum(abs_ref(r), dim=1),
            "dot": m @ w,
            "norm": torch.sum(m * m, dim=1)}


def pool_distance_stats_ref(w_flat: torch.Tensor,
                            pool_flat: torch.Tensor) -> dict:
    """The pool-distance sweep's plain version, single-run or batched
    (port of ``repro/core/distances.pool_distance_stats_ref``):

    * w (P,), pool (C, P)      → sq, l1, dot, norm each (C,)
    * w (B, P), pool (B, C, P) → each (B, C)

    in f32 over flattened tensors."""
    w = w_flat.float()
    m = pool_flat.float()
    w_row = w.unsqueeze(-2)                       # (…, 1, P) vs (…, C, P)
    r = w_row - m
    return {"sq": torch.sum(r * r, dim=-1),
            "l1": torch.sum(abs_ref(r), dim=-1),
            "dot": torch.sum(w_row * m, dim=-1),
            "norm": torch.sum(m * m, dim=-1)}


def pool_distance_stats_bwd_ref(w_flat: torch.Tensor, pool_flat: torch.Tensor,
                                g_sq: torch.Tensor, g_l1: torch.Tensor,
                                g_dot: torch.Tensor, *,
                                g_wsq=None) -> torch.Tensor:
    """The sweep's backward, plain: ∂/∂w of Σ_t ḡsq_t·sq_t + ḡl1_t·l1_t +
    ḡdot_t·dot_t (+ ḡwsq·Σw²) in f32, shaped like w,

        2Σ_t ḡsq_t·(w − m_t) + Σ_t ḡl1_t·s(w − m_t) + Σ_t ḡdot_t·m_t
        (+ 2·ḡwsq·w),

    with s(x) = +1 for x ≥ 0 and −1 otherwise: JAX's derivative of |x|
    (a pool model's first step sits exactly on its d2 anchor, r = 0).
    Shapes as `pool_distance_stats_ref`; the ḡ are (C,) or (B, C), ḡwsq
    a scalar or (B,)."""
    w = w_flat.float()
    m = pool_flat.float()
    r = w.unsqueeze(-2) - m
    sign = torch.where(r >= 0, 1.0, -1.0)
    grad = torch.sum(2.0 * g_sq.float()[..., None] * r +
                     g_l1.float()[..., None] * sign +
                     g_dot.float()[..., None] * m, dim=-2)
    if g_wsq is not None:
        g = torch.as_tensor(g_wsq, dtype=torch.float32, device=w.device)
        grad = grad + 2.0 * g[..., None] * w
    return grad


def factor_gram_ref(a: torch.Tensor) -> torch.Tensor:
    """f32 A·Aᵀ over the trailing axis, (…, M, P) → (…, M, M) — the factor
    Gram kernel's plain version."""
    af = a.float()
    return af @ af.transpose(-1, -2)


def bgmv_ref(x: torch.Tensor, u: torch.Tensor,
             v: torch.Tensor) -> torch.Tensor:
    """f32 batched low-rank correction y_s = (x_s @ u_s) @ v_sᵀ — the BGMV
    kernel's plain version. x: (S, N, d_in) per member or (N, d_in)
    shared; u: (S, d_in, r); v: (S, d_out, r) → (S, N, d_out)."""
    xf, uf, vf = x.float(), u.float(), v.float()
    t = xf @ uf            # (N, d_in) broadcasts over S
    return t @ vf.transpose(-1, -2)


def gla_recurrence_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       log_decay: torch.Tensor, *, bonus=None,
                       initial_state=None):
    """The gated-linear-attention recurrence token by token, in f32 — the
    semantic ground truth of the GLA chunk kernel and of its plain
    version. q, k: (B, T, H, K); v: (B, T, H, V); log_decay (B, T, H)
    or (B, T, H, K); bonus (H, K) or None; initial_state (B, H, K, V).

        S_t = e^{ld_t} ⊙ S_{t-1} + k_tᵀ v_t
        y_t = q_t · S_t                          (bonus None)
        y_t = q_t · (S_{t-1} + diag(u) k_tᵀ v_t)  (bonus u)

    Returns y (B, T, H, V) in v's dtype and the final state in f32."""
    b, t, h, kd = q.shape
    vd = v.shape[-1]
    if log_decay.dim() == 3:
        log_decay = log_decay[..., None]
    s = (torch.zeros((b, h, kd, vd), dtype=torch.float32, device=q.device)
         if initial_state is None else initial_state.float())
    ys = []
    for i in range(t):
        qt, kt, vt, ld = (x[:, i].float() for x in (q, k, v, log_decay))
        kv = kt[..., None] * vt[..., None, :]                # (B, H, K, V)
        if bonus is None:
            s = torch.exp(ld)[..., None] * s + kv
            ys.append(torch.einsum("bhk,bhkv->bhv", qt, s))
        else:
            ys.append(torch.einsum(
                "bhk,bhkv->bhv", qt,
                s + bonus.float()[None, :, :, None] * kv))
            s = torch.exp(ld)[..., None] * s + kv
    return torch.stack(ys, dim=1).to(v.dtype), s
