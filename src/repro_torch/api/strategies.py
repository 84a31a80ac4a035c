"""The strategy registry (port of ``repro/api/strategies.py``). This slice
registers paper Algorithm 1, ``fedelmy``: chain topology, warm-up on the
first client, then one pool block per client."""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

from repro_torch.api.plan import LocalBlock, StrategyPlan, Topology, interpret
from repro_torch.api.registry import Registry

STRATEGIES = Registry("strategy")


class StrategySpec(NamedTuple):
    """A registered strategy: the callable the engine invokes and its
    plan."""
    fn: Callable
    plan: StrategyPlan


def register_plan(name: str, plan: StrategyPlan) -> StrategyPlan:
    """Register a declarative strategy, executed through `interpret`."""
    STRATEGIES.register(name, StrategySpec(
        functools.partial(interpret, plan=plan), plan))
    return plan


def get_strategy_spec(name: str) -> StrategySpec:
    return STRATEGIES.get(name)


def list_strategies():
    return STRATEGIES.names()


register_plan("fedelmy", StrategyPlan(topology=Topology("chain"),
                                      phases=(LocalBlock("pool"),)))
