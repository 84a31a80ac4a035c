"""Typed run results (port of ``repro/api/results.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.configs.base import FedConfig


@dataclasses.dataclass
class ModelRecord:
    """One pool model trained inside a client's local procedure."""
    index: int                       # j ∈ [0, S)
    task_loss: float                 # last-step task loss ℓ(m_j)
    val_metric: Optional[float] = None

    def to_legacy(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"model": self.index, "task_loss": self.task_loss}
        if self.val_metric is not None:
            d["val_acc"] = self.val_metric
        return d


@dataclasses.dataclass
class ClientRecord:
    """One client visit in a sequential chain."""
    client: int                      # dataset index
    rank: int                        # position in the visit order
    models: List[ModelRecord] = dataclasses.field(default_factory=list)
    global_metric: Optional[float] = None   # eval_fn(m) after this client

    def to_legacy(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"client": self.client, "rank": self.rank,
                             "models": [m.to_legacy() for m in self.models]}
        if self.global_metric is not None:
            d["global_acc"] = self.global_metric
        return d


@dataclasses.dataclass
class RoundRecord:
    """One full cycle around the ring (few-shot adaptation)."""
    round: int
    global_metric: Optional[float] = None

    def to_legacy(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"shot": self.round}
        if self.global_metric is not None:
            d["global_acc"] = self.global_metric
        return d


@dataclasses.dataclass
class RunResult:
    """Everything a federated run produced."""
    strategy: str
    params: Any                      # final global model (name → tensor)
    fed: FedConfig
    clients: List[ClientRecord] = dataclasses.field(default_factory=list)
    rounds: List[RoundRecord] = dataclasses.field(default_factory=list)
    final_metric: Optional[float] = None
    wall_time_s: float = 0.0
    final_pool: Any = None           # last client's pool, if kept

    def history(self) -> List[Dict[str, Any]]:
        """Legacy history dicts, as the reference's deprecated drivers
        return them: per-shot records for few-shot runs, per-client
        records for sequential chains, else one global record."""
        if self.rounds:
            return [r.to_legacy() for r in self.rounds]
        if self.clients:
            return [c.to_legacy() for c in self.clients]
        if self.final_metric is not None:
            return [{"global_acc": self.final_metric}]
        return []

    def require_final_pool(self) -> Any:
        """The trained pool, or a diagnosis of why there is none: the
        strategy's plan discards it, or the run trained no pool."""
        if self.final_pool is not None:
            return self.final_pool
        from repro_torch.api.strategies import get_strategy_spec
        try:
            plan = get_strategy_spec(self.strategy).plan
        except (KeyError, ValueError):
            plan = None
        if plan is not None and not getattr(plan, "keep_final_pool", False):
            raise ValueError(
                f"strategy {self.strategy!r} discards its pool "
                "(keep_final_pool=False in its StrategyPlan) — it only "
                "produces an aggregated model. Serve that with "
                "PoolServer.from_params(model, result.params) instead.")
        raise ValueError(
            f"run of {self.strategy!r} produced no pool (use_pool=False, "
            "a custom strategy without pool blocks, or a result built "
            "before pools were retained). Re-run with FedConfig("
            "use_pool=True) or serve the aggregated params via "
            "PoolServer.from_params(model, result.params).")


@dataclasses.dataclass
class BatchResult:
    """What a sweep returns (`launch` of a list, a scenario or `axes=`):
    one RunResult per experiment, in input order, plus the whole sweep's
    wall clock (a batched run's own `wall_time_s` is its share of its
    group's). `n_compiled_groups` counts the program groups the sweep was
    split into, as the reference counts them: each batched group once,
    each run that ran alone once (1 = the whole sweep in one group)."""
    runs: List[RunResult]
    wall_time_s: float = 0.0
    n_compiled_groups: int = 0

    def __len__(self) -> int:
        return len(self.runs)

    def __getitem__(self, i: int) -> RunResult:
        return self.runs[i]

    def __iter__(self):
        return iter(self.runs)

    def final_metrics(self) -> List[Optional[float]]:
        return [r.final_metric for r in self.runs]


@dataclasses.dataclass
class CohortRecord:
    """One fleet round: which registered clients took part, the round's
    training wall clock, and (when evaluated) the global metric after the
    round's aggregate."""
    round: int
    clients: List[int]
    global_metric: Optional[float] = None
    wall_time_s: float = 0.0


@dataclasses.dataclass
class FleetResult:
    """What `repro_torch.scenarios.run_fleet` (and `launch(FleetSpec)`)
    returns: the final global params after every cohort round, per-round
    records and throughput accounting. `resumed_from` is the checkpointed
    round the sweep restarted after (None for an uninterrupted run); a
    resumed run is bitwise the uninterrupted one, so `cohorts` covers only
    the rounds this call ran."""
    fleet: Any                       # the FleetSpec
    strategy: str
    params: Any
    fed: FedConfig
    cohorts: List[CohortRecord] = dataclasses.field(default_factory=list)
    final_metric: Optional[float] = None
    wall_time_s: float = 0.0
    resumed_from: Optional[int] = None

    @property
    def clients_trained(self) -> int:
        return sum(len(c.clients) for c in self.cohorts)

    def clients_per_s(self) -> float:
        """Trained clients per second of cohort-training wall clock."""
        t = sum(c.wall_time_s for c in self.cohorts)
        return self.clients_trained / t if t > 0 else 0.0


@dataclasses.dataclass
class StrategyOutput:
    """What a strategy hands back to the engine (the engine adds timing
    and the final metric to build the RunResult)."""
    params: Any
    clients: List[ClientRecord] = dataclasses.field(default_factory=list)
    rounds: List[RoundRecord] = dataclasses.field(default_factory=list)
    final_pool: Any = None
