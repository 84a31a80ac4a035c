"""Transformer building blocks of the decoder and encoder-decoder families
(port of the dense, cross-attention and MLA subset of
``repro/models/layers.py``).

Conventions, as in the reference: activations (B, T, D); attention heads
in the last-but-one axis, q (B, T, H, hd); parameters are name → tensor
dicts whose layer-stacked leaves carry a leading L axis. Every product
accumulates in f32 and is cast back to the activation dtype exactly where
the reference casts (`preferred_element_type=f32` there): `matmul_f32`.

`flash_attention` routes by device. On a CUDA tensor it launches the
hand-written kernels (`kernels/flash_attention.py`) from position 0 (a
`q_offset`, which no caller passes, raises `NotImplementedError`): the forward
kernel alone, or, where an input requires grad (training), the
`FlashAttention` autograd Function, whose backward is the attention
backward kernel. On a CPU tensor it runs the reference's chunked
online-softmax formulation, kv block by kv block, and autograd
differentiates it as `jax.grad` differentiates the reference's.
`decode_attention` (one query against a KV cache, with the sliding
window of the dense family's ring buffer) is plain PyTorch on every
device, as the reference has no kernel for it.

`cross_attention` (the encoder-decoder's): queries from the decoder's
x, no rope, over keys and values projected from the encoder's output
beforehand, through `flash_attention` non-causal with Tq ≠ Tk (on the
card the forward kernel's non-causal mode).

MLA (DeepSeek-V2's Multi-head Latent Attention): `mla_latent` compresses
x into the cacheables, the normed latent c_kv (B, S, r) and one rope key
k_rope (B, S, rope) shared by the heads; `mla_attention` up-projects the
latent into per-head keys (nope | rope, the rope key broadcast over the
heads) and values of their own width, and attends through
`flash_attention` at scale (nope + rope)^-1/2: on the card the kernel's
(192, 128) instance for deepseek-v2-lite-16b.
Nothing in the decode path copies host memory to the card, so a decode
step can be captured in a CUDA graph (`launch.steps.CapturedDecode`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attn_f32)

ACC = torch.float32
NEG_INF = -1e30
Params = Dict[str, torch.Tensor]


def _he(gen: torch.Generator, shape, dtype, fan_in=None) -> torch.Tensor:
    """N(0, 1/fan_in) drawn on the generator's device (fan_in defaults to
    shape[0]), cast to the parameter dtype."""
    fan_in = fan_in or shape[0]
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=ACC)
    return x.div_(math.sqrt(fan_in)).to(dtype)   # one f32 buffer, not two


class _MatmulF32Out(torch.autograd.Function):
    """x @ w of two bf16 CUDA matrices, or of two stacks of them (E, C, K)
    @ (E, K, N), product by product (the experts'), accumulated and
    returned in f32 (cuBLAS with an f32 output, which has no derivative
    of its own). The backward multiplies the f32 cotangent g as the
    reference does, on the tensor cores: g is split into two bf16 terms,
    hi = bf16(g) and lo = bf16(g − hi), which hold g to ~2⁻¹⁷ of itself,
    and dx = g·wᵀ and dw = xᵀ·g are each the f32 sum of both terms'
    products, rounded once to the operands' dtype."""

    @staticmethod
    def forward(x, w):
        return _mm(x)(x, w, out_dtype=ACC)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        mm = _mm(x)
        hi = g.to(x.dtype)
        lo = (g - hi.to(ACC)).to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            wt = w.mT
            dx = mm(hi, wt, out_dtype=ACC)
            dx += mm(lo, wt, out_dtype=ACC)
            dx = dx.to(x.dtype)
        if ctx.needs_input_grad[1]:
            xt = x.mT
            dw = mm(xt, hi, out_dtype=ACC)
            dw += mm(xt, lo, out_dtype=ACC)
            dw = dw.to(w.dtype)
        return dx, dw


def _mm(x: torch.Tensor):
    """The product of x's rank: `torch.bmm` for a stack, else `torch.mm`."""
    return torch.bmm if x.dim() == 3 else torch.mm


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (…, d_in) @ w (d_in, d_out), or stack by stack x (E, C, d_in) @
    w (E, d_in, d_out) (the experts' products), accumulated in f32,
    returned in f32: the reference's ``einsum(...,
    preferred_element_type=f32)``. f32 operands multiply as they are (TF32
    must be off on the card); bf16 operands go through cuBLAS with an f32
    output on the card (under grad through `_MatmulF32Out`); anything else
    is widened to f32 first, which computes the same products."""
    stacked = w.dim() == 3
    x2 = x if stacked else x.reshape(-1, x.shape[-1])
    mm = _mm(x2)
    if x.dtype == ACC and w.dtype == ACC:
        y = mm(x2, w)
    elif x.device.type == "cuda" and x.dtype == w.dtype:
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            y = _MatmulF32Out.apply(x2, w)
        else:
            y = mm(x2, w, out_dtype=ACC)
    else:
        y = mm(x2.to(ACC), w.to(ACC))
    return y if stacked else y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm_init(d: int, dtype, device, lead=()) -> Params:
    """Unit scales; `lead` stacks them (the layer axis)."""
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=dtype,
                                device=device)}


def rms_norm(scale: torch.Tensor, x: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(ACC)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(ACC)).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """θ^(−2i/hd), computed on `device` from a scalar θ (exact in f32 for
    the configs' θ): no host-to-device copy, so it runs under capture."""
    exps = torch.arange(0, head_dim, 2, dtype=ACC, device=device) / head_dim
    return 1.0 / torch.pow(float(theta), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (…, T, H, hd) rotated pairwise (first half against second
    half); positions: (…, T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions.to(ACC)[..., None] * freqs        # (…, T, hd/2)
    cos = torch.cos(angles)[..., None, :]                 # (…, T, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(ACC), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, optional sliding window)
# ---------------------------------------------------------------------------

def _chunked_attention(q, k, v, *, causal, window, q_offset, kv_block):
    """The reference's jnp formulation: online softmax over kv blocks of
    `kv_block` keys, grouped queries (B, Tq, KV, G, hd), f32 throughout."""
    b, tq, h, hd = q.shape
    tk, n_kv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    g = h // n_kv
    qg = q.reshape(b, tq, n_kv, g, hd).to(ACC) * hd ** -0.5
    n_blocks = -(-tk // kv_block)
    pad = n_blocks * kv_block - tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = q_offset + torch.arange(tq, device=q.device)
    m = torch.full((b, tq, n_kv, g), NEG_INF, dtype=ACC, device=q.device)
    l = torch.zeros((b, tq, n_kv, g), dtype=ACC, device=q.device)
    acc = torch.zeros((b, tq, n_kv, g, vd), dtype=ACC, device=q.device)
    for blk in range(n_blocks):
        sl = slice(blk * kv_block, (blk + 1) * kv_block)
        k_c, v_c = k[:, sl].to(ACC), v[:, sl].to(ACC)
        k_pos = blk * kv_block + torch.arange(kv_block, device=q.device)
        s = torch.einsum("btkgh,bskh->btkgs", qg, k_c)
        mask = torch.ones((tq, kv_block), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        mask &= (k_pos < tk)[None, :]
        s = torch.where(mask[None, :, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("btkgs,bskh->btkgh", p,
                                                   v_c)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(b, tq, h, vd).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    kv_block: int = 512) -> torch.Tensor:
    """Causal / sliding-window / non-causal GQA attention. q: (B, Tq, H,
    hd); k: (B,
    Tk, KV, hd); v: (B, Tk, KV, dv), dv = hd or, for MLA, narrower; out
    (B, Tq, H, dv). q_offset: absolute position of q[0] relative to k[0].
    window: 0 = full; > 0 = only keys fewer than `window` positions back.
    CUDA: the flash-attention kernels (see the module docstring); CPU:
    the chunked formulation."""
    if q.device.type == "cuda":
        if q_offset:
            raise NotImplementedError(
                "flash_attention on CUDA starts at position 0: no path of "
                "the port or the reference passes q_offset != 0 (cached "
                "decode attends in plain PyTorch)")
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return FlashAttention.apply(q, k, v, causal, window)[0]
        return flash_attn_f32(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return _chunked_attention(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset, kv_block=kv_block)
    raise ValueError(f"flash_attention: no route for tensors on {q.device}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_pos: torch.Tensor,
                     pos: torch.Tensor, *, window: int = 0) -> torch.Tensor:
    """Single-token attention over a (possibly ring-buffer) KV cache. q:
    (B, 1, H, hd); caches (B, W, KV, hd); cache_pos (B, W): the absolute
    position of each entry (−1 = empty); pos (B,): the current position.
    An entry is valid when its position lies in [0, pos] and, with a
    `window` > 0, after pos − window. Scores and softmax in f32, out in
    q's dtype."""
    b, _, h, hd = q.shape
    n_kv = k_cache.shape[2]
    g = h // n_kv
    qg = q.reshape(b, n_kv, g, hd).to(ACC) * hd ** -0.5
    s = torch.einsum("bkgh,bwkh->bkgw", qg, k_cache.to(ACC))
    valid = (cache_pos >= 0) & (cache_pos <= pos[:, None])
    if window:
        valid &= cache_pos > pos[:, None] - window
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkh->bkgh", p, v_cache.to(ACC))
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention block
# ---------------------------------------------------------------------------

def attn_init(gen: torch.Generator, cfg, dtype, lead=()) -> Params:
    """GQA projections (He-normal, fan-in = the input dim) and optional
    zero biases, in the reference's leaf order; `lead` stacks them."""
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    lead, dev = tuple(lead), gen.device
    p = {"wk": _he(gen, lead + (d, kv * hd), dtype, fan_in=d),
         "wo": _he(gen, lead + (h * hd, d), dtype, fan_in=h * hd),
         "wq": _he(gen, lead + (d, h * hd), dtype, fan_in=d),
         "wv": _he(gen, lead + (d, kv * hd), dtype, fan_in=d)}
    if cfg.qkv_bias:
        for name, width in (("bk", kv * hd), ("bq", h * hd),
                            ("bv", kv * hd)):
            p[name] = torch.zeros(lead + (width,), dtype=dtype, device=dev)
    return dict(sorted(p.items()))


def _proj(x: torch.Tensor, w: torch.Tensor,
          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = matmul_f32(x, w)
    if b is not None:
        y = y + b.to(ACC)
    return y.to(x.dtype)


def attn_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    b, t, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(b, t, h, hd)
    k = _proj(x, p["wk"], p.get("bk")).reshape(b, t, kv, hd)
    v = _proj(x, p["wv"], p.get("bv")).reshape(b, t, kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_out(p: Params, o: torch.Tensor) -> torch.Tensor:
    b, t, h, hd = o.shape
    return _proj(o.reshape(b, t, h * hd), p["wo"])


def self_attention(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                   *, window: Optional[int] = None) -> torch.Tensor:
    q, k, v = attn_qkv(p, cfg, x, positions)
    window = cfg.sliding_window if window is None else window
    o = flash_attention(q, k, v, causal=True, window=window)
    return attn_out(p, o)


def cross_attn_init(gen: torch.Generator, cfg, dtype, lead=()) -> Params:
    """The cross-attention's projections: `attn_init`'s leaves (wk and wv
    project the encoder's output)."""
    return attn_init(gen, cfg, dtype, lead)


def cross_attention(p: Params, cfg, x: torch.Tensor, enc_kv) -> torch.Tensor:
    """Queries from x (B, T, D), no rope, over `enc_kv` = (k, v), each
    (B, T_src, KV, hd), projected from the encoder's output beforehand;
    non-causal attention, out through wo."""
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    q = _proj(x, p["wq"], p.get("bq")).reshape(b, t, h, hd)
    k, v = enc_kv
    return attn_out(p, flash_attention(q, k, v, causal=False))


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 Multi-head Latent Attention. Cache = compressed latent.
# ---------------------------------------------------------------------------

def mla_init(gen: torch.Generator, cfg, dtype, lead=()) -> Params:
    """The reference's MLA leaves in its order (He-normal: the down
    projections w_dq, w_dkv, w_kr at fan-in d_model, the up projections
    w_uk, w_uv at kv_lora_rank, wo at H·v; the latent norm's unit scale);
    `lead` stacks them."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk, r, lead = m.qk_nope_dim + m.qk_rope_dim, m.kv_lora_rank, tuple(lead)
    p = {"w_dq": _he(gen, lead + (d, h * qk), dtype, fan_in=d),
         "w_dkv": _he(gen, lead + (d, r), dtype, fan_in=d),
         "w_kr": _he(gen, lead + (d, m.qk_rope_dim), dtype, fan_in=d),
         "w_uk": _he(gen, lead + (r, h * m.qk_nope_dim), dtype, fan_in=r),
         "w_uv": _he(gen, lead + (r, h * m.v_head_dim), dtype, fan_in=r),
         "wo": _he(gen, lead + (h * m.v_head_dim, d), dtype,
                   fan_in=h * m.v_head_dim),
         "kv_norm.scale": rms_norm_init(r, dtype, gen.device,
                                        lead)["scale"]}
    return dict(sorted(p.items()))


def mla_latent(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor):
    """x (B, T, D) → the MLA cacheables: the normed latent c_kv (B, T, r)
    and the rope key k_rope (B, T, rope), in x's dtype."""
    c_kv = rms_norm(p["kv_norm.scale"], _proj(x, p["w_dkv"]), cfg.norm_eps)
    k_rope = _proj(x, p["w_kr"])[:, :, None, :]           # (B, T, 1, rope)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_qkv(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
            c_kv: torch.Tensor, k_rope: torch.Tensor):
    """Queries from x (B, T, H, nope + rope), rope applied to their rope
    part, and keys (B, S, H, nope + rope) and values (B, S, H, v)
    up-projected from the latent c_kv (B, S, r), the shared k_rope (B, S,
    rope) concatenated to every head's key."""
    m, h = cfg.mla, cfg.n_heads
    b, t, _ = x.shape
    s = c_kv.shape[1]
    q = _proj(x, p["w_dq"]).reshape(b, t, h, m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    k_nope = _proj(c_kv, p["w_uk"]).reshape(b, s, h, m.qk_nope_dim)
    v = _proj(c_kv, p["w_uv"]).reshape(b, s, h, m.v_head_dim)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, h, m.qk_rope_dim)], dim=-1)
    return torch.cat([q_nope, q_rope], dim=-1), k, v


def mla_out(p: Params, o: torch.Tensor) -> torch.Tensor:
    b, t, h, vd = o.shape
    return _proj(o.reshape(b, t, h * vd), p["wo"])


def mla_attention(p: Params, cfg, x: torch.Tensor, positions: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor, *,
                  q_offset: int = 0, causal: bool = True) -> torch.Tensor:
    """Queries from x attend over the latent cache (c_kv (B, S, r), k_rope
    (B, S, rope)) through `flash_attention`; keys and values are
    up-projected from the latent (only r + rope dims are cached)."""
    q, k, v = mla_qkv(p, cfg, x, positions, c_kv, k_rope)
    return mla_out(p, flash_attention(q, k, v, causal=causal,
                                      q_offset=q_offset))


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, dtype,
             lead=()) -> Params:
    """SwiGLU weights (He-normal); `lead` stacks them."""
    lead = tuple(lead)
    return {"w_down": _he(gen, lead + (d_ff, d), dtype, fan_in=d_ff),
            "w_gate": _he(gen, lead + (d, d_ff), dtype, fan_in=d),
            "w_up": _he(gen, lead + (d, d_ff), dtype, fan_in=d)}


def mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    g = matmul_f32(x, p["w_gate"])
    u = matmul_f32(x, p["w_up"])
    y = F.silu(g) * u
    return matmul_f32(y.to(x.dtype), p["w_down"]).to(x.dtype)
