"""Batched experiment execution (port of ``repro/api/batch.py``): N
experiments, grouped, each group one batched program.

The paper's claims are sweeps: Table 1 averages seeds, Fig. 10 sweeps the
(α, β) grid. `_run_batch` (behind `repro_torch.api.launch(exp, axes=...)`
and `launch([exp, ...])`) groups the experiments that share a step
program and runs each group through `plan.interpret_batched`, whose steps
carry a leading run axis: one launch of the GEMM and of the pool-distance
sweep serves every run of the group, and on the card each step kind of a
group is one CUDA graph.

    from repro_torch.api import BatchAxes, Experiment, launch

    batch = launch(Experiment(model=m, client_iters=make_iters(0), fed=fed),
                   axes=BatchAxes(seeds=range(4),
                                  client_iters_for_seed=make_iters))
    batch[0].params        # run 0's RunResult

Every run must own its stream objects: a `batch_iterator`'s position and
a `DataPlan`'s shuffle cursor are stateful, so neither may be shared
across the runs of a group (sharing raises); the BatchAxes factories exist
for that. Sharing the device arrays under several DataPlans is free.

Grouping rules, as the reference's:

* Two experiments batch together iff they share the strategy, the model's
  loss, the client count and visit-order length, `shots`, the strategy
  options, and every FedConfig field except ``alpha``/``beta`` (per-run
  tensors inside the batched step: the Fig. 10 grid) and ``seed``.
* Every plan-registered strategy batches (chain, ring, two-phase and
  independent topologies).
* Singleton groups, opaque (plan-less) strategies and experiments with
  callbacks run sequentially through `_run`. Results keep the input
  order.

Seeds follow the port's convention (`api.engine`): a run's seed is its
Experiment's `seed` (default ``fed.seed``), where the reference takes a
PRNG key."""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.api.engine import (Experiment, _run, finalize_result,
                                    warn_unsupported_fields)
from repro_torch.api.plan import interpret_batched
from repro_torch.api.results import BatchResult, RunResult
from repro_torch.api.strategies import get_strategy_spec


@dataclasses.dataclass
class BatchAxes:
    """The sweep axes `_run_batch` expands a base Experiment over (the
    cartesian product of whichever axes are set).

    seeds                 — per-run seed (→ ``Experiment.seed``)
    fed_grid              — per-run FedConfig overrides, e.g.
                            ``[{"alpha": a, "beta": b} for a in A for b in B]``
                            (only alpha/beta keep runs in one group)
    strategy_options_grid — per-run strategy_options overrides
    client_iters_for_seed — optional factory: seed → fresh client streams
    eval_fn_for_seed      — optional factory: seed → eval_fn
    client_iters_for_run  — optional factory: flat run index → fresh client
                            streams; takes precedence over the seed
                            factory (stateful streams must not be shared
                            across runs)
    """
    seeds: Optional[Sequence[int]] = None
    fed_grid: Optional[Sequence[Dict[str, Any]]] = None
    strategy_options_grid: Optional[Sequence[Dict[str, Any]]] = None
    client_iters_for_seed: Optional[Callable[[int], Sequence[Any]]] = None
    eval_fn_for_seed: Optional[Callable[[int], Callable]] = None
    client_iters_for_run: Optional[Callable[[int], Sequence[Any]]] = None

    def expand(self, base: Experiment) -> List[Experiment]:
        seeds = list(self.seeds) if self.seeds is not None else [None]
        feds = list(self.fed_grid) if self.fed_grid is not None else [None]
        opts = (list(self.strategy_options_grid)
                if self.strategy_options_grid is not None else [None])
        exps = []
        for seed in seeds:
            for fo in feds:
                for so in opts:
                    repl: Dict[str, Any] = {}
                    if seed is not None:
                        repl["seed"] = int(seed)
                        if self.client_iters_for_seed is not None:
                            repl["client_iters"] = \
                                self.client_iters_for_seed(seed)
                        if self.eval_fn_for_seed is not None:
                            repl["eval_fn"] = self.eval_fn_for_seed(seed)
                    if fo:
                        repl["fed"] = dataclasses.replace(base.fed, **fo)
                    if so:
                        repl["strategy_options"] = {**base.strategy_options,
                                                    **so}
                    if self.client_iters_for_run is not None:
                        repl["client_iters"] = \
                            self.client_iters_for_run(len(exps))
                    exps.append(dataclasses.replace(base, **repl))
        return exps


# ---------------------------------------------------------------------------
# Grouping
# ---------------------------------------------------------------------------

def _static_fed(fed):
    """The FedConfig with the per-run fields normalized away: alpha and
    beta ride through the batched step as per-run tensors, seed only
    feeds the default seed (resolved per run)."""
    return dataclasses.replace(fed, alpha=0.0, beta=0.0, seed=0)


def _group_key(e: Experiment) -> tuple:
    # id(loss_fn): a group trains every run through one loss, so two
    # models whose params merely share shapes never alias (the experiment
    # list keeps every model alive for the call). `shots` is loop
    # structure for ring plans; a plan whose warm-up depends on
    # init_params (resume) splits on init presence too.
    key = (e.strategy, _static_fed(e.fed), id(e.model.loss_fn),
           len(e.client_iters), len(e.resolved_order()), e.shots,
           tuple(sorted((k, repr(v))
                        for k, v in e.strategy_options.items())))
    plan = get_strategy_spec(e.strategy).plan
    if plan is not None and plan.init_skips_warmup:
        key += (e.init_params is not None,)
    return key


def _check_no_shared_iterators(exps: List[Experiment]) -> None:
    """Stateful streams shared across the runs of a group would be drained
    round-robin (run 0 sees batches 0, B, 2B, …): reject. Sharing within
    one run is fine: the batched loop consumes each run's clients in the
    sequential order."""
    owner: Dict[int, int] = {}
    for i, e in enumerate(exps):
        for it in e.client_iters:
            first = owner.setdefault(id(it), i)
            if first != i:
                raise ValueError(
                    "experiments in a batched group share client iterator "
                    f"objects (runs {first} and {i}); stateful streams "
                    "cannot be shared across runs — build fresh iterators "
                    "per run (BatchAxes.client_iters_for_seed / "
                    "client_iters_for_run, or per-run lists in "
                    "experiments=)")


def _batchable(e: Experiment) -> bool:
    """Plan strategies batch; opaque callables and callback-bearing runs
    (callbacks observe sequential per-client state) run alone."""
    return (get_strategy_spec(e.strategy).plan is not None
            and e.callbacks.on_model_end is None
            and e.callbacks.on_client_end is None)


# ---------------------------------------------------------------------------
# _run_batch
# ---------------------------------------------------------------------------

def _run_batch(experiment: Optional[Experiment] = None,
               axes: Optional[BatchAxes] = None, *,
               experiments: Optional[Sequence[Experiment]] = None,
               mesh=None) -> BatchResult:
    """Execute a sweep: a base `experiment` expanded by `axes`
    (`BatchAxes.expand`), or an explicit `experiments` list. Groups of two
    or more runs go through `interpret_batched` (each run's wall time the
    group's share); the rest run through `_run`. `n_compiled_groups`
    counts the batched groups and the sequential runs. `mesh` (sharding a
    group over devices) is not ported yet and raises."""
    if mesh is not None:
        raise NotImplementedError(
            "launch: mesh= (sharding a batched group over devices) is not "
            "ported yet")
    if experiments is not None:
        exps = list(experiments)
    else:
        if experiment is None:
            raise ValueError("run_batch needs an Experiment (plus BatchAxes)"
                             " or an explicit experiments= list")
        exps = axes.expand(experiment) if axes is not None else [experiment]
    if not exps:
        return BatchResult(runs=[], wall_time_s=0.0, n_compiled_groups=0)

    groups: Dict[Any, List[int]] = {}
    sequential: List[int] = []
    for i, e in enumerate(exps):
        if _batchable(e):
            groups.setdefault(_group_key(e), []).append(i)
        else:
            sequential.append(i)

    t0 = time.time()
    results: List[Optional[RunResult]] = [None] * len(exps)
    n_groups = 0
    for idxs in groups.values():
        if len(idxs) == 1:        # a singleton runs the sequential path
            sequential.extend(idxs)
            continue
        sub = [exps[i] for i in idxs]
        for e in sub:             # sequential runs warn inside _run
            warn_unsupported_fields(e)
        _check_no_shared_iterators(sub)
        plan = get_strategy_spec(sub[0].strategy).plan
        g0 = time.time()
        outs = interpret_batched(sub, plan)
        per_run = (time.time() - g0) / len(sub)
        for i, e, out in zip(idxs, sub, outs):
            results[i] = finalize_result(e, out, per_run)
        n_groups += 1
    for i in sequential:
        results[i] = _run(exps[i])
        n_groups += 1
    return BatchResult(runs=results, wall_time_s=time.time() - t0,
                       n_compiled_groups=n_groups)


def run_batch(experiment: Optional[Experiment] = None,
              axes: Optional[BatchAxes] = None, *,
              experiments: Optional[Sequence[Experiment]] = None,
              mesh=None) -> BatchResult:
    """Deprecated: use ``repro_torch.api.launch(experiment, axes=...)`` or
    ``launch(list_of_experiments)``, which dispatch here."""
    warnings.warn(
        "repro_torch.api.run_batch is deprecated; use "
        "repro_torch.api.launch(...)", DeprecationWarning, stacklevel=2)
    return _run_batch(experiment, axes, experiments=experiments, mesh=mesh)
