"""Pool-backend registry (port of ``repro/api/pools.py``): how a client's
model pool is represented, bundled with its d1 functional, so the trainer
never type-dispatches on pool classes. This slice registers the
paper-faithful ``"stacked"`` backend (`ModelPool`), which supports every
distance measure; the moment and low-rank backends, whose measures are
restricted, arrive with their slice."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.api.registry import Registry
from repro_torch.configs.base import FedConfig
from repro_torch.core.distances import d1_pool_distance
from repro_torch.core.pool import ModelPool


@dataclasses.dataclass(frozen=True)
class PoolBackend:
    """A pool representation + its d1 functional.

    create(m0, fed) -> pool          — seed the pool with the incoming model
    d1(params, pool, measure) -> x   — Eq. 7 mean distance to live members
    """
    name: str
    create: Callable[[Any, FedConfig], Any]
    d1: Callable[[Any, Any, str], torch.Tensor]


POOL_BACKENDS = Registry("pool backend")


def register_pool_backend(name: str, *, create, d1) -> PoolBackend:
    backend = PoolBackend(name, create, d1)
    POOL_BACKENDS.register(name, backend)
    return backend


def get_pool_backend(name: str) -> PoolBackend:
    return POOL_BACKENDS.get(name)


def backend_for(fed: FedConfig) -> PoolBackend:
    """The backend a FedConfig asks for (FedConfig has already checked
    its distance measure against it)."""
    return get_pool_backend(fed.resolved_pool_backend)


register_pool_backend(
    "stacked",
    create=lambda m0, fed: ModelPool.create(m0, capacity=fed.pool_size + 1),
    d1=d1_pool_distance)
