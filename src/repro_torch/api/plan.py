"""The strategy-plan IR and its two interpreters (port of
``repro/api/plan.py``).

A ``StrategyPlan`` states a federated method as data:

* ``Topology``   — how clients are visited: ``chain`` (one model threads
  through ``order``), ``ring`` (cycles × all clients; ``cycles="shots"``
  reads ``Experiment.shots``), or ``independent`` (clients train from
  broadcast inits, then aggregate).
* ``LocalBlock`` — what one visit does: ``plain`` steps for a FedConfig
  epoch budget, the ``pool`` diversity procedure (Alg. 1 lines 3–17), or a
  ``custom`` step factory (DFedSAM's SAM step, MetaFed's anchored
  penalty). A plan holds one block per *phase*; a phase is a full pass
  over the topology.
* ``aggregate``  — ``last`` (the threaded model) or ``tree_mean``.
* ``broadcast``  — how params reach a visit: ``handoff`` (sequential),
  ``shared_init`` (same init to every client), ``per_client_init``
  (independent inits, one seed per client from `per_client_seeds`).

`interpret` runs a plan sequentially. Visits of scan-wanting `DataPlan`
streams take the trainer's scanned local phase (plain and pool blocks,
the warm-up; on the card each step kind captured once in a CUDA graph a
run), as the reference routes them; custom blocks, per-model callbacks,
`scan=False` plans and `batch_iterator` streams keep the per-step loop
(a DataPlan serves it through the same cursor).

`interpret_batched` runs a group of experiments (`api.batch`) with a
leading run axis: the trainer's batched steps (`torch.func.vmap` over the
runs) and, where every stream of a visit wants it, the batched scanned
phase (one CUDA graph a step kind for the group); independent plans
flatten the run and client axes into one B·N axis. Each run consumes its
own streams in the order `interpret` does. A ``custom`` block supplies a
``batched_step_factory`` for it. There is no device mesh: a `mesh`
raises."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.api.results import ClientRecord, RoundRecord, StrategyOutput
from repro_torch.api.trainer import LocalTrainer, stack_trees, unstack_tree
from repro_torch.data.plan import all_want_scan, wants_scan

Params = Dict[str, torch.Tensor]

_TOPOLOGIES = ("chain", "ring", "independent")
_BLOCK_KINDS = ("plain", "pool", "custom")
_AGGREGATES = ("last", "tree_mean")
_BROADCASTS = ("handoff", "shared_init", "per_client_init")
_RECORDS = ("none", "clients", "clients_noeval", "rounds")


def tree_mean(trees: Sequence[Params]) -> Params:
    """Leaf-wise mean of parameter dicts — the one-shot averaging
    aggregate: a running left-to-right f32 sum divided by the count, as
    the reference defines it (bitwise equal to it)."""
    out = {}
    for k, first in trees[0].items():
        acc = first.to(torch.float32)
        for t in trees[1:]:
            acc = acc + t[k].to(torch.float32)
        out[k] = (acc / len(trees)).to(first.dtype)
    return out


def per_client_seeds(seed: int, n_clients: int) -> List[int]:
    """One init seed per client for ``per_client_init``, a deterministic
    function of the experiment's seed (the reference splits its PRNG key
    instead, so the inits match it in distribution only)."""
    state = np.random.SeedSequence(seed).generate_state(n_clients)
    return [int(s) for s in state]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Client-visit structure of one phase pass.

    kind         — "chain" | "ring" | "independent"
    honors_order — chain only: visit ``Experiment.order`` instead of
                   0..N-1 (ring/independent always use the natural order)
    cycles       — passes per phase: an int, or the string "shots" to
                   read ``Experiment.shots`` at run time (ring topology)
    """
    kind: str
    honors_order: bool = False
    cycles: Any = 1

    def __post_init__(self):
        if self.kind not in _TOPOLOGIES:
            raise ValueError(f"unknown topology kind {self.kind!r}; "
                             f"expected one of {_TOPOLOGIES}")

    def resolved_cycles(self, exp) -> int:
        return exp.shots if self.cycles == "shots" else int(self.cycles)

    def schedule(self, exp) -> List[int]:
        return (exp.resolved_order() if self.honors_order
                else list(range(len(exp.client_iters))))

    def label(self) -> str:
        if self.cycles == "shots":
            return f"{self.kind}×shots"
        if self.cycles != 1:
            return f"{self.kind}×{self.cycles}"
        return self.kind


@dataclasses.dataclass(frozen=True)
class LocalBlock:
    """What one client visit executes.

    kind       — "plain" (steps on the task loss), "pool" (the paper's
                 diversity procedure: S regularized models, pool average
                 handoff), or "custom" (the step factory below)
    epochs     — FedConfig field naming the step budget ("e_local")
    epochs_div — integer divisor of that budget (MetaFed: e_local // 2)
    anchored   — custom only: the factory receives the params at phase
                 entry (MetaFed's common model) as its anchor
    step_factory(trainer, exp, anchor) -> step_fn           — sequential
    batched_step_factory(trainer, exps, anchors) -> step_fn — batched;
                 ``anchors`` is the stacked (B, …) phase-entry params
    label      — human name for `describe_strategies`
    """
    kind: str
    epochs: str = "e_local"
    epochs_div: int = 1
    anchored: bool = False
    step_factory: Optional[Callable] = None
    batched_step_factory: Optional[Callable] = None
    label: Optional[str] = None

    def __post_init__(self):
        if self.kind not in _BLOCK_KINDS:
            raise ValueError(f"unknown local block kind {self.kind!r}; "
                             f"expected one of {_BLOCK_KINDS}")
        if self.kind == "custom" and (self.step_factory is None or
                                      self.batched_step_factory is None):
            raise ValueError("custom local blocks need both step_factory "
                             "and batched_step_factory")
        if self.kind == "pool" and (self.epochs != "e_local" or
                                    self.epochs_div != 1):
            raise ValueError(
                "pool blocks train fed.e_local steps per pool model "
                "(LocalTrainer.local_client_train owns that budget); "
                "epochs/epochs_div apply to plain/custom blocks only")

    def n_steps(self, fed) -> int:
        return getattr(fed, self.epochs) // self.epochs_div

    def describe(self) -> str:
        if self.label is not None:
            return self.label
        return "pool(d1,d2)" if self.kind == "pool" else self.kind


@dataclasses.dataclass(frozen=True)
class StrategyPlan:
    """A federated strategy as declarative data (see the module docstring
    for the field semantics). ``supports`` lists the optional Experiment
    fields the plan honors (the engine warns on the rest)."""
    topology: Topology
    phases: Tuple[LocalBlock, ...]
    aggregate: str = "last"
    broadcast: str = "handoff"
    init_from_experiment: bool = False    # honor Experiment.init_params
    warmup: Optional[str] = None          # None | "first" | "per_client"
    init_skips_warmup: bool = False       # resume: init_params ⇒ no warmup
    records: str = "none"
    keep_final_pool: bool = False
    client_selector: Optional[Callable] = None   # exp -> client indices
    trainer_overrides: Optional[Callable] = None  # fed -> LocalTrainer kw
    supports: Tuple[str, ...] = ()

    def __post_init__(self):
        if self.aggregate not in _AGGREGATES:
            raise ValueError(f"unknown aggregate {self.aggregate!r}; "
                             f"expected one of {_AGGREGATES}")
        if self.broadcast not in _BROADCASTS:
            raise ValueError(f"unknown broadcast {self.broadcast!r}; "
                             f"expected one of {_BROADCASTS}")
        if self.records not in _RECORDS:
            raise ValueError(f"unknown records policy {self.records!r}; "
                             f"expected one of {_RECORDS}")
        if not self.phases:
            raise ValueError("a plan needs at least one phase")
        if self.topology.kind == "independent":
            if len(self.phases) != 1:
                raise ValueError("independent topology is single-phase")
            if self.broadcast == "handoff":
                raise ValueError("independent topology broadcasts inits "
                                 "(shared_init or per_client_init), it "
                                 "cannot hand off sequentially")
        elif self.broadcast != "handoff":
            raise ValueError(f"{self.topology.kind} topology hands off "
                             "sequentially; broadcast must be 'handoff'")

    def describe(self) -> Dict[str, str]:
        """Plan metadata for `describe_strategies`."""
        return {
            "topology": self.topology.label(),
            "local_block": " → ".join(b.describe() for b in self.phases),
            "aggregate": self.aggregate,
            "broadcast": self.broadcast,
            "supports": ",".join(self.supports) or "—",
        }


# ---------------------------------------------------------------------------
# Shared helpers
# ---------------------------------------------------------------------------

def _make_trainer(loss_fn: Callable, fed, plan: StrategyPlan) -> LocalTrainer:
    kw = plan.trainer_overrides(fed) if plan.trainer_overrides else {}
    return LocalTrainer(loss_fn, fed, **kw)


def _eval(exp, params) -> Optional[float]:
    return float(exp.eval_fn(params)) if exp.eval_fn is not None else None


def _eval_slice(e, stacked: Params, i: int) -> Optional[float]:
    return (float(e.eval_fn(unstack_tree(stacked, i)))
            if e.eval_fn is not None else None)


def _resolved_init(exp, plan: StrategyPlan) -> Params:
    if plan.init_from_experiment and exp.init_params is not None:
        return exp.init_params
    return exp.model.init(exp.resolved_seed())


def _wants_warmup(exp, plan: StrategyPlan) -> bool:
    if plan.warmup is None:
        return False
    if plan.init_skips_warmup and plan.init_from_experiment \
            and exp.init_params is not None:
        return False                       # resuming: warmup already ran
    return True


def _selected_clients(exp, plan: StrategyPlan) -> List[int]:
    if plan.client_selector is not None:
        return list(plan.client_selector(exp))
    return list(range(len(exp.client_iters)))


def _alphas_betas(exps, device, repeat: int = 1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-run (α, β) as f32 tensors on `device`, each repeated `repeat`
    times (one per client of the flattened independent axis)."""
    return tuple(torch.tensor([getattr(e.fed, name) for e in exps
                               for _ in range(repeat)],
                              dtype=torch.float32, device=device)
                 for name in ("alpha", "beta"))


# ---------------------------------------------------------------------------
# Sequential backend (behind `launch`)
# ---------------------------------------------------------------------------

def interpret(experiment, plan: StrategyPlan) -> StrategyOutput:
    """Execute one Experiment through its plan, sequentially."""
    trainer = _make_trainer(experiment.model.loss_fn, experiment.fed, plan)
    plans = [it for it in experiment.client_iters if wants_scan(it)]
    if plans:
        trainer.scanned.reserve(plans)
    if plan.topology.kind == "independent":
        return _interpret_independent(experiment, plan, trainer)
    return _interpret_sequenced(experiment, plan, trainer)


def _train_visit(trainer: LocalTrainer, m: Params, it, n_steps: int):
    """Plain training over one client stream: the scanned phase for a
    scan-wanting DataPlan, else the per-step loop."""
    if wants_scan(it):
        m, _ = trainer.train_scanned(m, it, n_steps)
    else:
        m, _ = trainer.train(m, it, n_steps)
    return m


def _run_block(trainer: LocalTrainer, block: LocalBlock, m: Params, it,
               step_fn, exp, pool_out: Optional[str] = "copy"):
    """One client visit: returns (params, pool | None, model records).
    Scan-wanting DataPlans take the scanned phase; custom blocks and
    per-model callbacks keep the per-step loop. `pool_out` is how a pool
    visit hands its pool back (`ScannedPhase.local_client`; None drops
    it)."""
    if block.kind == "pool":
        if wants_scan(it) and exp.callbacks.on_model_end is None:
            return trainer.local_client_train_scanned(m, it, pool_out)
        m, pool, models = trainer.local_client_train(
            m, it, on_model_end=exp.callbacks.on_model_end)
        return m, (pool if pool_out is not None else None), models
    if block.kind == "plain" and wants_scan(it):
        m, _ = trainer.train_scanned(m, it, block.n_steps(trainer.fed))
        return m, None, []
    m, _ = trainer.train(m, it, block.n_steps(trainer.fed), step_fn=step_fn)
    return m, None, []


def _interpret_sequenced(exp, plan: StrategyPlan,
                         trainer: LocalTrainer) -> StrategyOutput:
    """chain / ring: one model threads through the schedule, phase by
    phase; records per client (chain) or per cycle (ring)."""
    fed = exp.fed
    schedule = plan.topology.schedule(exp)
    cycles = plan.topology.resolved_cycles(exp)
    m = _resolved_init(exp, plan)
    if _wants_warmup(exp, plan):
        m = _train_visit(trainer, m, exp.client_iters[schedule[0]],
                         fed.e_warmup)

    clients: List[ClientRecord] = []
    rounds: List[RoundRecord] = []
    pool = None
    for block in plan.phases:
        anchor = ({k: v.detach() for k, v in m.items()} if block.anchored
                  else None)
        step_fn = (block.step_factory(trainer, exp, anchor)
                   if block.kind == "custom" else None)
        for r in range(cycles):
            for rank, ci in enumerate(schedule):
                # only the last visit's pool is kept (handed over by the
                # scanned phase, not copied); the others' are not made
                last = r == cycles - 1 and rank == len(schedule) - 1
                keep = block.kind == "pool" and plan.keep_final_pool and last
                m, block_pool, models = _run_block(
                    trainer, block, m, exp.client_iters[ci], step_fn, exp,
                    "hand_over" if keep else None)
                if keep:
                    pool = block_pool
                if plan.records == "clients":
                    rec = ClientRecord(client=int(ci), rank=rank,
                                       models=models,
                                       global_metric=_eval(exp, m))
                    clients.append(rec)
                    if exp.callbacks.on_client_end is not None:
                        exp.callbacks.on_client_end(rec, m)
            if plan.records == "rounds":
                rec = RoundRecord(round=r, global_metric=_eval(exp, m))
                rounds.append(rec)
                if exp.callbacks.on_client_end is not None:
                    exp.callbacks.on_client_end(rec, m)
    return StrategyOutput(params=m, clients=clients, rounds=rounds,
                          final_pool=pool if plan.keep_final_pool else None)


def _interpret_independent(exp, plan: StrategyPlan,
                           trainer: LocalTrainer) -> StrategyOutput:
    """independent: selected clients train (one after another) from
    broadcast inits, then aggregate."""
    fed = exp.fed
    sel = _selected_clients(exp, plan)
    if plan.broadcast == "per_client_init":
        seeds = per_client_seeds(exp.resolved_seed(), len(exp.client_iters))
        inits = [exp.model.init(seeds[c]) for c in sel]
    else:
        m0 = _resolved_init(exp, plan)
        inits = [m0 for _ in sel]

    block = plan.phases[0]
    step_fn = (block.step_factory(trainer, exp, None)
               if block.kind == "custom" else None)
    outs: List[Params] = []
    clients: List[ClientRecord] = []
    pool = None
    for ci, m0 in zip(sel, inits):
        it = exp.client_iters[ci]
        if plan.warmup == "per_client":
            m0 = _train_visit(trainer, m0, it, fed.e_warmup)
        m, pool, models = _run_block(trainer, block, m0, it, step_fn, exp)
        outs.append(m)
        if plan.records == "clients_noeval":
            rec = ClientRecord(client=int(ci), rank=int(ci), models=models)
            clients.append(rec)
            if exp.callbacks.on_client_end is not None:
                exp.callbacks.on_client_end(rec, m)
    params = tree_mean(outs) if plan.aggregate == "tree_mean" else outs[-1]
    # "final pool" is the last visited client's pool, as in the sequenced
    # interpreter
    return StrategyOutput(params=params, clients=clients,
                          final_pool=pool if plan.keep_final_pool else None)


# ---------------------------------------------------------------------------
# Batched backend (behind `api.batch._run_batch`)
# ---------------------------------------------------------------------------

def interpret_batched(exps: List[Any], plan: StrategyPlan,
                      mesh=None, *, _trainer: Optional[LocalTrainer] = None
                      ) -> List[StrategyOutput]:
    """Execute a group of Experiments (`api.batch` groups them) through
    their plan with a leading run axis; one StrategyOutput a run, each
    run's streams consumed in `interpret`'s order. No device mesh is
    ported: a `mesh` raises. `_trainer` (`_make_trainer`'s, for this plan
    and FedConfig) lets a caller that runs many groups of one shape —
    `run_fleet`'s rounds — keep one trainer, and so one capture a step
    kind, across them."""
    if mesh is not None:
        raise NotImplementedError(
            "interpret_batched: mesh= (sharding a group over devices) is "
            "not ported yet")
    trainer = (_trainer if _trainer is not None else
               _make_trainer(exps[0].model.loss_fn, exps[0].fed, plan))
    if plan.topology.kind == "independent":
        return _interpret_independent_batched(exps, plan, trainer)
    return _interpret_sequenced_batched(exps, plan, trainer)


def _stacked_inits(exps, plan: StrategyPlan) -> Params:
    return stack_trees([_resolved_init(e, plan) for e in exps])


def _reserve(trainer: LocalTrainer, streams) -> None:
    """Size the batched scanned phase's arrays for the longest shard the
    group visits, so that every visit fits one capture a step kind."""
    plans = [it for it in streams if wants_scan(it)]
    if plans:
        trainer.scanned_batched.reserve(plans)


def _batched_visit(trainer: LocalTrainer, m: Params, its, n_steps: int,
                   step_fn=None) -> Params:
    """One batched plain/custom visit: all-DataPlan visits take the batched
    scanned phase, anything else the per-step loop."""
    if step_fn is None and all_want_scan(its):
        m, _ = trainer.train_scanned_batched(m, its, n_steps)
    else:
        m, _ = trainer.train_batched(m, its, n_steps, step_fn=step_fn)
    return m


def _batched_pool_visit(trainer: LocalTrainer, m: Params, its, alphas,
                        betas):
    if all_want_scan(its):
        return trainer.local_client_train_scanned_batched(m, its, alphas,
                                                          betas)
    return trainer.local_client_train_batched(m, its, alphas, betas)


def _interpret_sequenced_batched(exps, plan: StrategyPlan,
                                 trainer: LocalTrainer
                                 ) -> List[StrategyOutput]:
    fed = exps[0].fed
    schedules = [plan.topology.schedule(e) for e in exps]
    cycles = plan.topology.resolved_cycles(exps[0])
    m = _stacked_inits(exps, plan)
    alphas, betas = _alphas_betas(exps, next(iter(m.values())).device)
    _reserve(trainer, [e.client_iters[ci]
                       for e, s in zip(exps, schedules) for ci in s])
    if _wants_warmup(exps[0], plan):
        warm = [e.client_iters[s[0]] for e, s in zip(exps, schedules)]
        m = _batched_visit(trainer, m, warm, fed.e_warmup)

    clients: List[List[ClientRecord]] = [[] for _ in exps]
    rounds: List[List[RoundRecord]] = [[] for _ in exps]
    pools = None
    for block in plan.phases:
        anchors = ({k: v.detach() for k, v in m.items()} if block.anchored
                   else None)
        step_fn = (block.batched_step_factory(trainer, exps, anchors)
                   if block.kind == "custom" else None)
        for r in range(cycles):
            for rank in range(len(schedules[0])):
                its = [e.client_iters[s[rank]]
                       for e, s in zip(exps, schedules)]
                if block.kind == "pool":
                    m, pools, recs = _batched_pool_visit(trainer, m, its,
                                                         alphas, betas)
                else:
                    m = _batched_visit(trainer, m, its, block.n_steps(fed),
                                       step_fn=step_fn)
                    recs = [[] for _ in exps]
                if plan.records == "clients":
                    for i, e in enumerate(exps):
                        clients[i].append(ClientRecord(
                            client=int(schedules[i][rank]), rank=rank,
                            models=recs[i],
                            global_metric=_eval_slice(e, m, i)))
            if plan.records == "rounds":
                for i, e in enumerate(exps):
                    rounds[i].append(RoundRecord(
                        round=r, global_metric=_eval_slice(e, m, i)))
    return [StrategyOutput(
                params=unstack_tree(m, i), clients=clients[i],
                rounds=rounds[i],
                final_pool=(unstack_tree(pools, i)
                            if plan.keep_final_pool and pools is not None
                            else None))
            for i in range(len(exps))]


def _interpret_independent_batched(exps, plan: StrategyPlan,
                                   trainer: LocalTrainer
                                   ) -> List[StrategyOutput]:
    """Clients within a run are independent, so the run and client axes
    flatten into one (B·N,) run axis: every client of every run trains in
    the same batched steps."""
    fed = exps[0].fed
    sel = _selected_clients(exps[0], plan)   # the group key fixes it
    n_sel = len(sel)
    if plan.broadcast == "per_client_init":
        inits = []
        for e in exps:
            seeds = per_client_seeds(e.resolved_seed(), len(e.client_iters))
            inits.extend(e.model.init(seeds[c]) for c in sel)
    else:
        m0s = [_resolved_init(e, plan) for e in exps]
        inits = [m0 for m0 in m0s for _ in sel]
    flat = stack_trees(inits)
    flat_iters = [e.client_iters[c] for e in exps for c in sel]
    _reserve(trainer, flat_iters)
    if plan.warmup == "per_client":
        flat = _batched_visit(trainer, flat, flat_iters, fed.e_warmup)

    block = plan.phases[0]
    recs: List[List[Any]] = [[] for _ in flat_iters]
    pools = None
    if block.kind == "pool":
        alphas, betas = _alphas_betas(exps, next(iter(flat.values())).device,
                                      repeat=n_sel)
        flat, pools, recs = _batched_pool_visit(trainer, flat, flat_iters,
                                                alphas, betas)
    else:
        step_fn = (block.batched_step_factory(trainer, exps, None)
                   if block.kind == "custom" else None)
        flat = _batched_visit(trainer, flat, flat_iters, block.n_steps(fed),
                              step_fn=step_fn)

    outs: List[StrategyOutput] = []
    for i, e in enumerate(exps):
        slices = [unstack_tree(flat, i * n_sel + k) for k in range(n_sel)]
        clients: List[ClientRecord] = []
        if plan.records == "clients_noeval":
            clients = [ClientRecord(client=int(c), rank=int(c),
                                    models=recs[i * n_sel + k])
                       for k, c in enumerate(sel)]
        params = (tree_mean(slices) if plan.aggregate == "tree_mean"
                  else slices[-1])
        # as in _interpret_independent: the run's last selected client's
        # pool (flat index i·n_sel + n_sel − 1)
        pool = (unstack_tree(pools, i * n_sel + n_sel - 1)
                if plan.keep_final_pool and pools is not None else None)
        outs.append(StrategyOutput(params=params, clients=clients,
                                   final_pool=pool))
    return outs
