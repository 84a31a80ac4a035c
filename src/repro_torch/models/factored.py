"""Factored ensemble forwards: serve a `LowRankDeltaPool` without
densifying it (port of ``repro/models/factored.py``).

Member t of a factor pool is ``base + U_t·V_tᵀ`` per matrix leaf, so every
linear site satisfies ``x·W_t = x·W_base + (x·U_t)·V_tᵀ``: the ensemble
forward reads the base weights once per batch and each member pays a
rank-r BGMV correction (`kernels/bgmv.py`: the hand-written kernel on the
card) instead of its own weight sweep. Activations diverge per member
after the first correction, so tensors here carry a leading pool axis S.

The capability hook: a model family that serves factored sets

    setattr(model.forward, FACTORED_FORWARD_ATTR,
            forward_factored)           # (base, deltas, batch) -> logits

where ``deltas`` is `LowRankDeltaPool.delta_tree()` (``{name:
LeafDelta}``). A hook may carry a ``prepare(base, deltas)`` attribute that
lays the deltas out once for many forwards; `serve.PoolServer.from_pool`
calls it when it builds the server, and a hook that has one takes only
what it returns. The decoder's `prepare` densifies
layer-stacked vector leaves and puts the layer axis first, contiguous
((C, L, …) → (L, C, …)), so layer l's factors are contiguous slices the
BGMV kernel takes as they are; the reference swaps the axes inside every
forward instead.

Numerics: every product accumulates in f32 and casts back to the
activation dtype where `models/layers.py` does; the base products are
`layers.matmul_f32` (cuBLAS on the card), as the reference leaves them to
XLA."""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.pool import LeafDelta
from repro_torch.kernels.bgmv import bgmv
from repro_torch.models import layers as L

ACC = torch.float32
Deltas = Dict[str, LeafDelta]

# Hook attribute on `model.forward`; see the module docstring.
FACTORED_FORWARD_ATTR = "forward_factored"


def factored_forward_for(forward: Callable) -> Optional[Callable]:
    """The model's factored forward, or None (`PoolServer.from_pool`'s
    probe)."""
    return getattr(forward, FACTORED_FORWARD_ATTR, None)


def densify_delta(d: LeafDelta) -> torch.Tensor:
    """(C, *lead, d_in, d_out) dense delta stack from either form."""
    if d.dense is not None:
        return d.dense
    return d.u @ d.v.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Factored layer primitives: activations carry a leading pool axis S —
# (S, B, T, D) at transformer sites, (S, N, D) (or shared (N, D)) at plain
# dense-layer sites.
# ---------------------------------------------------------------------------

def fdense(x: torch.Tensor, w: torch.Tensor, d: LeafDelta,
           b: Optional[torch.Tensor] = None,
           db: Optional[LeafDelta] = None) -> torch.Tensor:
    """Factored 2-D dense layer: x (N, d_in) shared across members (the
    base computed once) or (S, N, d_in) per member → (S, N, d_out) f32."""
    shared = x.dim() == 2
    y = L.matmul_f32(x.to(ACC), w.to(ACC))
    if d.dense is not None:
        corr = torch.einsum("nd,sdf->snf" if shared else "snd,sdf->snf",
                            x.to(ACC), d.dense)
    else:
        corr = bgmv(x, d.u, d.v)
    y = (y[None] if shared else y) + corr
    if b is not None:
        y = y + b.to(ACC)
    if db is not None:
        y = y + db.dense[:, None, :]
    return y


def fproj(x: torch.Tensor, w: torch.Tensor, d: LeafDelta,
          b: Optional[torch.Tensor] = None,
          db: Optional[LeafDelta] = None) -> torch.Tensor:
    """Factored `layers._proj`: x (S, B, T, d_in); w (d_in, d_out) read
    once for all members; the member term through BGMV."""
    s, bb, t, d_in = x.shape
    y = L.matmul_f32(x, w)
    if d.dense is not None:
        y = y + torch.einsum("sbtd,sdf->sbtf", x.to(ACC), d.dense)
    else:
        corr = bgmv(x.reshape(s, bb * t, d_in), d.u, d.v)
        y = y + corr.reshape(s, bb, t, -1)
    if b is not None:
        y = y + b.to(ACC)
    if db is not None:
        y = y + db.dense[:, None, None, :]
    return y.to(x.dtype)


def frms(scale: torch.Tensor, d: LeafDelta, x: torch.Tensor,
         eps: float) -> torch.Tensor:
    """Per-member `layers.rms_norm`: base scale + each member's dense scale
    delta (S, D); x (S, …, D)."""
    xf = x.to(ACC)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    sc = scale.to(ACC) + d.dense
    sc = sc.reshape((sc.shape[0],) + (1,) * (x.dim() - 2) + (sc.shape[-1],))
    return (y * sc).to(x.dtype)


def fembed(embed: torch.Tensor, d: LeafDelta,
           tokens: torch.Tensor) -> torch.Tensor:
    """Per-member embedding gather: base rows once plus each member's
    low-rank row correction U[tok]·Vᵀ; (B, T) → (S, B, T, D) in the embed
    dtype (exact: the gather commutes with densify-then-cast)."""
    tokens = tokens.long()
    x = embed[tokens].to(ACC)
    if d.dense is not None:
        corr = d.dense[:, tokens]
    else:
        corr = torch.einsum("sbtr,sdr->sbtd", d.u[:, tokens], d.v)
    return (x[None] + corr).to(embed.dtype)


# ---------------------------------------------------------------------------
# Decoder-only transformer factored forward (dense GQA family)
# ---------------------------------------------------------------------------

class LayerMajorDeltas(dict):
    """A decoder's deltas laid out for serving (`prepare_decoder_deltas`):
    every ``layers.`` leaf's stacks are (L, C, …) and contiguous."""


def prepare_decoder_deltas(base: Dict[str, torch.Tensor],
                           deltas: Deltas) -> LayerMajorDeltas:
    """Lay a decoder pool's deltas out once for many factored forwards:
    layer-stack leaves whose base leaf is not an (L, d_in, d_out) matrix
    batch — the (L, D) norm scales, which the pool factors as matrices
    when L ≥ FACTOR_MIN — become dense; then every layer leaf's stacks
    move the layer axis first, contiguous."""
    out = LayerMajorDeltas()
    for name, d in deltas.items():
        if name.startswith("layers."):
            if d.dense is None and base[name].dim() < 3:
                d = LeafDelta(None, None, densify_delta(d))
            d = LeafDelta(*(None if a is None
                            else a.transpose(0, 1).contiguous() for a in d))
        out[name] = d
    return out


def _layer_deltas(deltas: LayerMajorDeltas, l: int) -> Deltas:
    return {k[len("layers."):]: LeafDelta(*(None if a is None else a[l]
                                            for a in d))
            for k, d in deltas.items() if k.startswith("layers.")}


def _sub(tree: Dict, prefix: str) -> Dict:
    n = len(prefix) + 1
    return {k[n:]: v for k, v in tree.items() if k.startswith(prefix + ".")}


def _fattn(p, d, cfg, x, positions):
    """Factored `layers.self_attention`: q/k/v/o through `fproj`, the S
    axis folded into flash attention's batch (members attend
    independently)."""
    s, b, t, _ = x.shape
    nh, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = fproj(x, p["wq"], d["wq"], p.get("bq"), d.get("bq"))
    k = fproj(x, p["wk"], d["wk"], p.get("bk"), d.get("bk"))
    v = fproj(x, p["wv"], d["wv"], p.get("bv"), d.get("bv"))
    q = L.apply_rope(q.reshape(s * b, t, nh, hd), positions, cfg.rope_theta)
    k = L.apply_rope(k.reshape(s * b, t, kv, hd), positions, cfg.rope_theta)
    o = L.flash_attention(q, k, v.reshape(s * b, t, kv, hd), causal=True,
                          window=cfg.sliding_window)
    return fproj(o.reshape(s, b, t, nh * hd), p["wo"], d["wo"])


def _fmlp(p, d, x):
    """Factored SwiGLU (`layers.mlp`)."""
    g = fproj(x, p["w_gate"], d["w_gate"])
    u = fproj(x, p["w_up"], d["w_up"])
    y = (F.silu(g.to(ACC)) * u.to(ACC)).to(x.dtype)
    return fproj(y, p["w_down"], d["w_down"])


def _fblock(lp, ld, cfg, x, positions):
    h = frms(lp["ln1.scale"], ld["ln1.scale"], x, cfg.norm_eps)
    x = x + _fattn(_sub(lp, "attn"), _sub(ld, "attn"), cfg, h, positions)
    h = frms(lp["ln2.scale"], ld["ln2.scale"], x, cfg.norm_eps)
    return x + _fmlp(_sub(lp, "ffn"), _sub(ld, "ffn"), h)


def _flm_logits(params, deltas, cfg, h):
    """Factored `transformer.lm_logits`: (S, B, T, D) → (S, B, T, V) f32.
    Tied embeddings swap the factor roles: member unembed is
    (embed + U·Vᵀ)ᵀ = embedᵀ + V·Uᵀ, so the correction is bgmv(h, V, U)."""
    h = frms(params["final_norm.scale"], deltas["final_norm.scale"], h,
             cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    y = L.matmul_f32(h, w)
    s, b, t, dd = h.shape
    d = deltas["embed"] if cfg.tie_embeddings else deltas["lm_head"]
    if d.dense is not None:
        eq = "sbtd,svd->sbtv" if cfg.tie_embeddings else "sbtd,sdv->sbtv"
        return y + torch.einsum(eq, h.to(ACC), d.dense)
    fu, fv = (d.v, d.u) if cfg.tie_embeddings else (d.u, d.v)
    return y + bgmv(h.reshape(s, b * t, dd), fu, fv).reshape(s, b, t, -1)


def make_decoder_factored(cfg) -> Callable:
    """The `forward_factored(base, deltas, batch)` hook of the dense
    decoder family, with its `prepare` (see the module docstring). It takes
    only prepared deltas: `forward_factored(base, forward_factored.prepare(
    base, pool.delta_tree()), batch)`."""

    def forward_factored(params, deltas, batch):
        if not isinstance(deltas, LayerMajorDeltas):
            raise TypeError(
                "the decoder's forward_factored takes the deltas its "
                "`prepare(base, deltas)` lays out, not "
                f"{type(deltas).__name__}")
        tokens = batch["tokens"]
        b, t = tokens.shape
        x = fembed(params["embed"], deltas["embed"], tokens)  # (S, B, T, D)
        s = x.shape[0]
        positions = torch.arange(t, device=tokens.device).expand(s * b, t)
        for l in range(cfg.n_layers):
            lp = {k[len("layers."):]: v[l] for k, v in params.items()
                  if k.startswith("layers.")}
            x = _fblock(lp, _layer_deltas(deltas, l), cfg, x, positions)
        return _flm_logits(params, deltas, cfg, x)

    forward_factored.prepare = prepare_decoder_deltas
    return forward_factored
