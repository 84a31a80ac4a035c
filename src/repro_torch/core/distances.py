"""Distance regularizers d1 / d2 (paper Eq. 7–8) and the appendix's
logarithmic magnitude calibration (port of ``repro/core/distances.py``).

d1: mean distance from the model in training to every live pool member
    (maximized → diversity).
d2: distance to the pool's first model m_0^i (minimized → anchor).
Measures: l2 (default), l1, cosine, squared_l2. Pool members never carry
gradient; `log_scale`'s calibration factor is detached (the reference's
`stop_gradient`)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.pool import ModelPool

F32 = torch.float32
Params = Dict[str, torch.Tensor]


def _abs(x: torch.Tensor) -> torch.Tensor:
    """|x| with the reference's derivative: +1 at x == 0 (JAX differentiates
    `abs` as select(x >= 0, g, -g); `torch.abs` gives 0 there). Every pool
    model starts exactly at its d2 anchor, so the l1 measure meets x == 0
    on its first step."""
    return torch.where(x >= 0, x, -x)


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
        return sum(_leaf_sum(_abs(x - y), batched) for x, y in pairs)
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


def d1_pool_distance(params: Params, pool: ModelPool,
                     measure: str = "l2") -> torch.Tensor:
    """Eq. 7: (1/|M|) Σ_t dist(m, m_t) over live members (masked)."""
    members = {k: s.detach() for k, s in pool.members.items()}
    dists = _distance(params, members, measure, batched=True)
    return torch.sum(dists * pool.mask()) / float(pool.count)


def d2_anchor_distance(params: Params, anchor: Params,
                       measure: str = "l2") -> torch.Tensor:
    """Eq. 8: dist(m, m_0^i)."""
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
