"""The strategy-plan IR and its sequential interpreter (port of the
sequential backend of ``repro/api/plan.py``, as far as paper Algorithm 1
uses it).

A ``StrategyPlan`` states a federated method as data: a client
``Topology`` and one ``LocalBlock`` per phase. This slice registers one
plan, ``fedelmy``, and the IR holds what that plan uses: a ``chain``
topology that threads one model through ``Experiment.order``, ``pool``
blocks (the paper's diversity procedure), a warm-up on the first client,
one record per client visit and the last pool kept. The reference's ring
and independent topologies, plain and custom blocks, optional warm-up,
tree-mean aggregation and init broadcasts arrive with the strategies that
use them."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from repro_torch.api.results import ClientRecord, StrategyOutput
from repro_torch.api.trainer import LocalTrainer

_TOPOLOGIES = ("chain",)
_BLOCK_KINDS = ("pool",)


@dataclasses.dataclass(frozen=True)
class Topology:
    """Client-visit structure of one phase pass: ``chain`` visits
    ``Experiment.order`` (default 0..N-1) with one model."""
    kind: str

    def __post_init__(self):
        if self.kind not in _TOPOLOGIES:
            raise ValueError(f"unknown topology kind {self.kind!r}; "
                             f"expected one of {_TOPOLOGIES}")

    def schedule(self, exp) -> List[int]:
        return exp.resolved_order()


@dataclasses.dataclass(frozen=True)
class LocalBlock:
    """What one client visit executes: ``pool`` — S diversity-regularized
    models of fed.e_local steps each, handing off the pool average."""
    kind: str

    def __post_init__(self):
        if self.kind not in _BLOCK_KINDS:
            raise ValueError(f"unknown local block kind {self.kind!r}; "
                             f"expected one of {_BLOCK_KINDS}")


@dataclasses.dataclass(frozen=True)
class StrategyPlan:
    """A federated strategy as declarative data. Before the phases, the
    interpreter trains fed.e_warmup plain steps on the first scheduled
    client (paper Alg. 1's warm-up)."""
    topology: Topology
    phases: Tuple[LocalBlock, ...]

    def __post_init__(self):
        if not self.phases:
            raise ValueError("a plan needs at least one phase")


def _eval(exp, params) -> Optional[float]:
    return float(exp.eval_fn(params)) if exp.eval_fn is not None else None


def interpret(experiment, plan: StrategyPlan) -> StrategyOutput:
    """Execute one Experiment through its plan, sequentially."""
    trainer = LocalTrainer(experiment.model.loss_fn, experiment.fed)
    return _interpret_sequenced(experiment, plan, trainer)


def _train_visit(trainer: LocalTrainer, m, it, n_steps: int):
    """Plain training over one client stream (the per-step loop)."""
    m, _ = trainer.train(m, it, n_steps)
    return m


def _interpret_sequenced(exp, plan: StrategyPlan,
                         trainer: LocalTrainer) -> StrategyOutput:
    """chain: one model threads through the schedule, phase by phase,
    starting from ``Experiment.init_params`` (else ``model.init(seed)``);
    one record per client visit."""
    schedule = plan.topology.schedule(exp)
    m = (exp.init_params if exp.init_params is not None
         else exp.model.init(exp.resolved_seed()))
    m = _train_visit(trainer, m, exp.client_iters[schedule[0]],
                     exp.fed.e_warmup)

    clients: List[ClientRecord] = []
    pool = None
    for _ in plan.phases:                  # every block is a pool block
        for rank, ci in enumerate(schedule):
            m, pool, models = trainer.local_client_train(
                m, exp.client_iters[ci],
                on_model_end=exp.callbacks.on_model_end)
            rec = ClientRecord(client=int(ci), rank=rank, models=models,
                               global_metric=_eval(exp, m))
            clients.append(rec)
            if exp.callbacks.on_client_end is not None:
                exp.callbacks.on_client_end(rec, m)
    return StrategyOutput(params=m, clients=clients, final_pool=pool)
