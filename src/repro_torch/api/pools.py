"""Pool-backend registry (port of ``repro/api/pools.py``): how a client's
model pool is represented, bundled with its d1 functional, so the trainer
never type-dispatches on pool classes.

Built-ins:

* ``"stacked"`` — paper-faithful `ModelPool` (S+1 full copies); every
  distance measure.
* ``"moment"``  — `MomentPool` running statistics (μ, q); squared-L2 only.
* ``"lowrank"`` — `LowRankDeltaPool` (base + rank-r deltas,
  ``FedConfig.pool_rank``); l2 and squared-L2 through factor Grams.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Tuple

import torch

from repro_torch.api.registry import Registry
from repro_torch.configs.base import FedConfig
from repro_torch.core.distances import d1_lowrank, d1_moment, d1_pool_distance
from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool


@dataclasses.dataclass(frozen=True)
class PoolBackend:
    """A pool representation + its d1 functional.

    create(m0, fed) -> pool          — seed the pool with the incoming model
    d1(params, pool, measure) -> x   — Eq. 7 mean distance to live members
    supported_measures               — None = all distance measures
    """
    name: str
    create: Callable[[Any, FedConfig], Any]
    d1: Callable[[Any, Any, str], torch.Tensor]
    supported_measures: Optional[Tuple[str, ...]] = None


POOL_BACKENDS = Registry("pool backend")


def register_pool_backend(name: str, *, create, d1,
                          supported_measures=None) -> PoolBackend:
    backend = PoolBackend(name, create, d1,
                          tuple(supported_measures) if supported_measures
                          else None)
    POOL_BACKENDS.register(name, backend)
    return backend


def get_pool_backend(name: str) -> PoolBackend:
    return POOL_BACKENDS.get(name)


def list_pool_backends() -> List[str]:
    return POOL_BACKENDS.names()


def backend_for(fed: FedConfig) -> PoolBackend:
    """Resolve and cross-check the backend a FedConfig asks for."""
    backend = get_pool_backend(fed.resolved_pool_backend)
    if backend.supported_measures is not None and \
            fed.distance_measure not in backend.supported_measures:
        raise ValueError(
            f"pool backend {backend.name!r} supports distance measures "
            f"{backend.supported_measures}, got {fed.distance_measure!r}")
    return backend


register_pool_backend(
    "stacked",
    create=lambda m0, fed: ModelPool.create(m0, capacity=fed.pool_size + 1),
    d1=d1_pool_distance)

register_pool_backend(
    "moment",
    create=lambda m0, fed: MomentPool.create(m0),
    d1=lambda params, pool, measure: d1_moment(params, pool),
    supported_measures=("squared_l2",))

register_pool_backend(
    "lowrank",
    create=lambda m0, fed: LowRankDeltaPool.create(
        m0, capacity=fed.pool_size + 1, rank=fed.pool_rank),
    d1=d1_lowrank,
    supported_measures=("l2", "squared_l2"))
