"""Mixture-of-Experts layer: a top-k router and a sort-based capacity
dispatch (port of ``repro/models/moe.py``).

The semantics are the reference's, step for step. The router's logits
are f32 (x widened, the router leaf f32 on every dtype); softmax, top-k,
the k gates renormalised by max(Σ, 1e-9). The flat (token, j)
assignments are sorted by expert with a stable sort, each one's rank
within its expert taken from `searchsorted`, and an assignment is kept
when its rank lies below the capacity (`_capacity`); an overflowing one
goes to one dump row, discarded. Which tokens drop therefore follows
token order. The kept rows fill a dense (E, C, D) buffer, every expert
runs its SwiGLU on its C rows (three batched products with f32
accumulation, `silu(g)·u` cast to x's dtype, the down product cast to
x's dtype), and each token sums its kept outputs times their gates in
f32, plus the shared experts' MLP.

Two choices keep the step deterministic forward and backward, on the
card (no float atomics) and on the CPU (no sums in the threads' order).
The buffer is filled from x repeated k times, so that each (token, j)
assignment has a row of its own, gathered by the dispatch's order, a
permutation: that gather's backward writes each row once, and the
repeat's sums each token's k rows. The copy into the buffer has its
only duplicate index at the dump row, which is discarded. The combine
gathers each token's k outputs (zero where dropped) and sums them over
j, never adding into a shared buffer; its backward adds into one row
twice only at the clamped dump index, where every dropped assignment's
cotangent is an exact zero. The router's gradient flows through the
gates (top-k's values, their renormalisation) and the aux loss's mean
probabilities, not through the indices, the top-1 one-hot or the
dispatch, as in the reference. Nothing reads a device value on the
host, so a decode step through this layer can be captured in a CUDA
graph. The products are library calls (the reference computes them
outside any Pallas kernel) through `layers.matmul_f32`, stack by stack."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.base import Params

ACC = torch.float32


def moe_init(gen: torch.Generator, cfg, dtype, lead=()) -> Params:
    """The reference's draws in its leaf order: the router He-normal in
    f32 (fan-in d_model), the expert stacks He-normal with the
    reference's fan-in, which is shape[0] = n_experts for w_gate and w_up
    and d_ff_expert for w_down (ROADMAP C20), and the shared experts'
    SwiGLU. `lead` stacks them (the layer axis); the expert stacks are
    drawn a layer at a time, so one layer's f32 buffer is the largest
    transient."""
    m, d, lead = cfg.moe, cfg.d_model, tuple(lead)
    e, f = m.n_experts, m.d_ff_expert

    def experts(shape, fan_in):
        out = torch.empty(lead + shape, dtype=dtype, device=gen.device)
        for block in out.view((-1,) + shape):
            block.copy_(L._he(gen, shape, dtype, fan_in=fan_in))
        return out

    p = {"router": L._he(gen, lead + (d, e), ACC, fan_in=d),
         "w_gate": experts((e, d, f), e),
         "w_up": experts((e, d, f), e),
         "w_down": experts((e, f, d), f)}
    if m.n_shared_experts:
        shared = L.mlp_init(gen, d, f * m.n_shared_experts, dtype, lead)
        p.update({f"shared.{k}": v for k, v in shared.items()})
    return dict(sorted(p.items()))


def _capacity(n_tokens: int, cfg) -> int:
    """Rows per expert: int(N·k/E·cf), padded up to a multiple of 8, at
    least 8."""
    m = cfg.moe
    c = int(n_tokens * m.top_k / m.n_experts * m.capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(p: Params, cfg, xf: torch.Tensor):
    """The router on the flat tokens (N, D): the top-k experts (N, k)
    int64, their renormalised gates (N, k) f32, and the aux loss
    E·Σ_e mean(probs)_e·mean(onehot(top-1))_e (not yet weighted)."""
    m = cfg.moe
    logits = L.matmul_f32(xf.to(ACC), p["router"])
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, m.top_k, dim=-1)
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    ids = torch.arange(m.n_experts, device=xf.device)
    top1 = (experts[:, :1] == ids).to(ACC)
    aux = m.n_experts * torch.sum(probs.mean(0) * top1.mean(0))
    return experts, gates, aux


def dispatch(experts: torch.Tensor, cap: int, n_experts: int):
    """The sort-based dispatch of the (N, k) assignments: `order` (the
    stable sort by expert of the flat assignments), and in that order
    `keep` (rank within the expert below `cap`) and `slot` (expert·cap +
    rank, or the dump row E·cap)."""
    n, k = experts.shape
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    se = flat[order]
    pos = torch.arange(n * k, device=flat.device)
    seg_start = torch.searchsorted(
        se, torch.arange(n_experts, device=flat.device))
    rank = pos - seg_start[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank,
                       torch.full_like(se, n_experts * cap))
    return order, keep, slot


def moe_ffn(p: Params, cfg, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) → (y (B, T, D) in x's dtype, the weighted aux loss, a
    0-d f32)."""
    m = cfg.moe
    b, t, d = x.shape
    n = b * t
    e, k = m.n_experts, m.top_k
    xf = x.reshape(n, d)
    cap = _capacity(n, cfg)
    experts, gates, aux = route(p, cfg, xf)
    order, keep, slot = dispatch(experts, cap, e)

    # each (token, j) assignment's row once, in the dispatch's order
    rows = xf[:, None].expand(n, k, d).reshape(n * k, d)[order]
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, rows)       # duplicates only at the dump row
    buf = buf[:-1].reshape(e, cap, d)
    g = L.matmul_f32(buf, p["w_gate"])
    u = L.matmul_f32(buf, p["w_up"])
    h = (F.silu(g) * u).to(x.dtype)
    out = L.matmul_f32(h, p["w_down"]).to(x.dtype).reshape(e * cap, d)

    # the combine: each token gathers its k outputs, in (token, j) order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n * k, device=x.device)
    slot, keep = slot[inv], keep[inv]
    gathered = torch.where(keep[:, None],
                           out[torch.clamp(slot, max=e * cap - 1)],
                           torch.zeros((), dtype=x.dtype, device=x.device))
    y = (gathered.reshape(n, k, d).to(ACC) * gates[..., None]).sum(1)
    if m.n_shared_experts:
        shared = {kk[len("shared."):]: v for kk, v in p.items()
                  if kk.startswith("shared.")}
        y = y + L.mlp(shared, x).reshape(n, d).to(ACC)
    return y.reshape(b, t, d).to(x.dtype), aux * m.router_aux_weight


def drops(p: Params, cfg, x: torch.Tensor) -> torch.Tensor:
    """The assignments `moe_ffn` drops for x (B, T, D) at its capacity:
    a 0-d int64 count (a reading, not part of the layer)."""
    n = x.shape[0] * x.shape[1]
    experts, _, _ = route(p, cfg, x.reshape(n, -1))
    _, keep, _ = dispatch(experts, _capacity(n, cfg), cfg.moe.n_experts)
    return (~keep).sum()
