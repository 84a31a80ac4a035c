"""Distance regularizers d1 / d2 (paper Eq. 7–8) and the appendix's
logarithmic magnitude calibration (port of ``repro/core/distances.py``),
for the stacked, moment-form and low-rank pools.

d1: mean distance from the model in training to every live pool member
    (maximized → diversity).
d2: distance to the pool's first model m_0^i (minimized → anchor).
Measures: l2 (default), l1, cosine, squared_l2. Pool members never carry
gradient; `log_scale`'s calibration factor is detached (the reference's
`stop_gradient`).

The stacked pool's d1 and the d2 route by the tensors' device. On CUDA
they go through the pool-distance sweep (`kernels/pool_distance`: one
kernel launch for every leaf and member, forward and backward) and
`distances_from_stats`, as the reference designed its Pallas kernel for
them. The anchor m_0^i is the pool's member 0, so one sweep over the pool
gives both (`d1_d2_pool_distance`, which `eq9_distances` takes for the
Eq. 9 step of the trainer and of `fedelmy_loss`): d2 is the
sweep's column 0, and autograd adds both terms' ḡ into the one stats
tensor, so the step makes one forward and one backward launch. Alone, d2
is the sweep over a one-member pool of the anchor (MetaFed's anchored
step). On the CPU they take the per-leaf formulation, the reference's own
CPU path. Mixed devices raise."""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.pool import (LowRankDeltaPool, ModelPool, MomentPool,
                                   _leaf_key)
from repro_torch.kernels.pool_distance import (distances_from_stats,
                                               factor_gram_group,
                                               tree_pool_distance_stats)
from repro_torch.kernels.ref import abs_ref

F32 = torch.float32
Params = Dict[str, torch.Tensor]


def _leaf_sum(x: torch.Tensor, batched: bool) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1) if batched else x.sum()


def _distance(a: Params, b: Params, measure: str, batched: bool
              ) -> torch.Tensor:
    """dist(a, b[t]) for every member t of a stacked `b` when `batched`,
    else dist(a, b)."""
    def lead(x):
        return x.unsqueeze(0) if batched else x

    pairs = [(lead(a[k].to(F32)), b[k].to(F32)) for k in a]
    if measure in ("l2", "squared_l2"):
        sq = sum(_leaf_sum(torch.square(x - y), batched) for x, y in pairs)
        return sq if measure == "squared_l2" else torch.sqrt(sq + 1e-12)
    if measure == "l1":
        # JAX's derivative of |x| at 0: every pool model starts exactly at
        # its d2 anchor, so the l1 measure meets x == 0 on its first step
        return sum(_leaf_sum(abs_ref(x - y), batched) for x, y in pairs)
    if measure == "cosine":
        dot = sum(_leaf_sum(x * y, batched) for x, y in pairs)
        na = torch.sqrt(sum(x.square().sum() for x, _ in pairs) + 1e-12)
        nb = torch.sqrt(sum(_leaf_sum(y * y, batched) for _, y in pairs)
                        + 1e-12)
        return 1.0 - dot / (na * nb)
    raise ValueError(measure)


def pairwise_distance(a: Params, b: Params, measure: str = "l2"
                      ) -> torch.Tensor:
    """dist(a, b) over flattened parameters."""
    return _distance(a, b, measure, batched=False)


def _route(params: Params, other: Params, name: str) -> str:
    types = {t.device.type for t in params.values()} | \
        {t.device.type for t in other.values()}
    if types in ({"cuda"}, {"cpu"}):
        return types.pop()
    raise ValueError(f"{name}: no route for tensors on {sorted(types)}")


def d1_pool_sweep(params: Params, pool: ModelPool,
                  measure: str = "l2") -> torch.Tensor:
    """Eq. 7 through the pool-distance sweep: every member's stats in one
    pass over the pool's capacity, the empty slots masked out of the mean
    (their gradient is exactly 0)."""
    return d1_d2_pool_sweep(params, pool, measure)[0]


def d1_pool_distance(params: Params, pool: ModelPool,
                     measure: str = "l2") -> torch.Tensor:
    """Eq. 7: (1/|M|) Σ_t dist(m, m_t) over live members (masked). CUDA:
    `d1_pool_sweep`; CPU: per leaf."""
    if _route(params, pool.members, "d1_pool_distance") == "cuda":
        return d1_pool_sweep(params, pool, measure)
    members = {k: s.detach() for k, s in pool.members.items()}
    dists = _distance(params, members, measure, batched=True)
    return torch.sum(dists * pool.mask()) / pool.count.to(F32)


def d1_d2_pool_sweep(params: Params, pool: ModelPool, measure: str = "l2"
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. 7 and Eq. 8 through one pool-distance sweep: d1 the masked mean
    as `d1_pool_sweep` forms it, d2 member 0's column (the anchor
    `pool.first()` is member 0)."""
    stats, w_sq = tree_pool_distance_stats(params, pool.members)
    dists = distances_from_stats(stats, w_sq, measure)
    return (torch.sum(dists * pool.mask()) / pool.count.to(F32),
            dists[0])


def d1_d2_pool_distance(params: Params, pool: ModelPool,
                        measure: str = "l2"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d1, d2) of a stacked pool. CUDA: `d1_d2_pool_sweep`; CPU:
    `d1_pool_distance` and `d2_anchor_distance` per leaf."""
    if _route(params, pool.members, "d1_d2_pool_distance") == "cuda":
        return d1_d2_pool_sweep(params, pool, measure)
    return (d1_pool_distance(params, pool, measure),
            d2_anchor_distance(params, pool.first(), measure))


def eq9_distances(params: Params, pool, measure: str, use_d1: bool,
                  use_d2: bool, d1: Callable = d1_pool_distance
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(d1, d2) of Eq. 9, None where a regularizer is off: d1 from `d1` (a
    pool backend's), d2 the distance to the anchor. Where `d1` is the
    stacked pool's and both are on, one call of `d1_d2_pool_distance`
    gives both (one sweep on CUDA)."""
    if use_d1 and use_d2 and d1 is d1_pool_distance:
        return d1_d2_pool_distance(params, pool, measure)
    return (d1(params, pool, measure) if use_d1 else None,
            d2_anchor_distance(params, pool.first(), measure)
            if use_d2 else None)


def lowrank_member_sq(params: Params,
                      pool: LowRankDeltaPool) -> torch.Tensor:
    """Per-member ‖m − m_t‖² (C,) in factor form, never densifying a
    member: with G = m − base and Δ_t = U_tV_tᵀ per matrix leaf,
    ‖G − Δ_t‖² = ‖G‖² − 2⟨GᵀU_t, V_t⟩ + ⟨U_tᵀU_t, V_tᵀV_t⟩; dense-delta
    leaves contribute their residuals directly."""
    total = torch.zeros((pool.capacity,), dtype=F32,
                        device=pool.mask().device)
    for i, (name, b) in enumerate(pool.base.items()):
        k = _leaf_key(i)
        g = params[name].to(F32) - b.to(F32)
        if k in pool.dense:
            r = g[None] - pool.dense[k]
            total = total + torch.sum(torch.square(r),
                                      dim=tuple(range(1, r.dim())))
        else:
            u, v = pool.u[k], pool.v[k]
            nd = tuple(range(1, u.dim()))
            gu = torch.einsum("...io,c...ir->c...or", g, u)
            cross = torch.sum(gu * v, dim=nd)
            uu = torch.einsum("c...ir,c...is->c...rs", u, u)
            vv = torch.einsum("c...ir,c...is->c...rs", v, v)
            total = total + (torch.sum(g * g) - 2.0 * cross +
                             torch.sum(uu * vv, dim=nd))
    return torch.clamp_min(total, 0.0)


def d1_lowrank(params: Params, pool: LowRankDeltaPool,
               measure: str = "l2") -> torch.Tensor:
    """Eq. 7 over factor-form members (l2 / squared_l2 only: l1 and cosine
    have no exact Gram form)."""
    sq = lowrank_member_sq(params, pool)
    if measure == "l2":
        d = torch.sqrt(sq + 1e-12)
    elif measure == "squared_l2":
        d = sq
    else:
        raise ValueError(
            f"lowrank pool supports l2/squared_l2, got {measure!r}")
    return torch.sum(d * pool.mask()) / pool.count.to(F32)


def lowrank_pairwise_sq(pool: LowRankDeltaPool,
                        gram_fn: Optional[Callable] = None) -> torch.Tensor:
    """Pairwise ‖m_i − m_j‖² (C, C) from r×r Grams: the base cancels, and
    ⟨Δ_i, Δ_j⟩ = ⟨U_iᵀU_j, V_iᵀV_j⟩_F comes from two long-axis Grams over
    the (C·r)-row factor stacks of each leaf. By default every stack goes
    to `kernels.pool_distance.factor_gram_group` at once (one kernel launch
    on CUDA, the plain version stack by stack on the CPU); a `gram_fn`,
    A (…, M, P) → A·Aᵀ, is called on each stack instead."""
    c = pool.capacity
    stacks, ranks = [], []
    for k, u in pool.u.items():
        v = pool.v[k]
        r = u.shape[-1]
        # (C, *lead, d, r) → (L, C·r, d): the Gram's long axis is d; the
        # flattened lead dims ride the kernel's batch axis.
        for f in (u, v):
            ff = f.reshape((c, -1) + tuple(f.shape[-2:]))
            stacks.append(ff.permute(1, 0, 3, 2).reshape(
                ff.shape[1], c * r, f.shape[-2]).contiguous())
        ranks.append(r)
    grams = (factor_gram_group(stacks) if gram_fn is None
             else [gram_fn(a) for a in stacks])
    inner = torch.zeros((c, c), dtype=F32, device=pool.mask().device)
    for r, gu, gv in zip(ranks, grams[0::2], grams[1::2]):
        inner = inner + torch.einsum("lirjs,lirjs->ij",
                                     gu.reshape(-1, c, r, c, r),
                                     gv.reshape(-1, c, r, c, r))
    for d in pool.dense.values():
        df = d.reshape(d.shape[0], -1).to(F32)
        inner = inner + df @ df.T
    diag = torch.diagonal(inner)
    return torch.clamp_min(diag[:, None] + diag[None, :] - 2.0 * inner, 0.0)


def d1_moment(params: Params, pool: MomentPool) -> torch.Tensor:
    """Moment-form d1: the RMS of the exact mean squared distance."""
    return torch.sqrt(pool.mean_sq_distance(params) + 1e-12)


def d2_anchor_sweep(params: Params, anchor: Params,
                    measure: str = "l2") -> torch.Tensor:
    """Eq. 8 through the pool-distance sweep, over a one-member pool of
    the anchor's leaves (views, nothing copied)."""
    stats, w_sq = tree_pool_distance_stats(
        params, {k: v.unsqueeze(0) for k, v in anchor.items()})
    return distances_from_stats(stats, w_sq, measure)[0]


def d2_anchor_distance(params: Params, anchor: Params,
                       measure: str = "l2") -> torch.Tensor:
    """Eq. 8: dist(m, m_0^i). CUDA: `d2_anchor_sweep`; CPU: per leaf."""
    if _route(params, anchor, "d2_anchor_distance") == "cuda":
        return d2_anchor_sweep(params, anchor, measure)
    return pairwise_distance(params, {k: v.detach()
                                      for k, v in anchor.items()}, measure)


def log_scale(dist: torch.Tensor, task_loss: torch.Tensor) -> torch.Tensor:
    """Appendix calibration: rescale `dist` to one order of magnitude below
    the task loss (e.g. ℓ=6.02, d=45 → 0.45). The scale factor is detached,
    so only the distance direction receives gradient."""
    mag_d = torch.floor(torch.log10(torch.clamp_min(dist.detach(), 1e-12)))
    mag_l = torch.floor(torch.log10(
        torch.clamp_min(task_loss.detach(), 1e-12)))
    scale = 10.0 ** (mag_d + 1.0 - mag_l)
    return dist / torch.clamp_min(scale, 1e-12)
