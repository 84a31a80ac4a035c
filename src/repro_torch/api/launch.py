"""`repro_torch.api.launch` — the one front door for federated execution
(port of ``repro/api/launch.py``). It dispatches on what it is given:

    launch(experiment)                       -> RunResult
    launch([exp0, exp1, ...])                -> BatchResult
    launch(scenario_spec, model, fed=fed)    -> BatchResult
    launch(fleet_spec, model, fed=fed)       -> FleetResult
    launch("dir_label_skew", model, fed=fed) -> BatchResult  (registry)
    launch("fleet_100k", model, fed=fed)     -> FleetResult  (registry)

    launch(experiment, axes=BatchAxes(...)) -> BatchResult

Sweeps (a list, a scenario, `axes=`) go through the batched engine
(`api.batch._run_batch`): compatible experiments form one group, one
batched program; a fleet runs each round's cohort as one such group
(`scenarios.run_fleet`). `mesh=` is not ported yet and raises.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from repro_torch.api.batch import BatchAxes, _run_batch
from repro_torch.api.engine import Experiment, _run

Result = Any   # RunResult | BatchResult | FleetResult


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"launch: {what} is not ported yet (device meshes come with a "
        "later slice of the port)")


def _resolve_name(name: str):
    """A registered fleet or scenario name → its spec (fleets first: the
    catalogs' names are disjoint)."""
    from repro_torch.scenarios.registry import FLEETS, SCENARIOS
    for registry in (FLEETS, SCENARIOS):
        try:
            return registry.get(name)
        except ValueError:
            continue
    raise ValueError(
        f"launch: {name!r} names neither a registered fleet nor a "
        "registered scenario (see repro_torch.scenarios.list_fleets() / "
        "list_scenarios())")


def launch(target, model=None, *, axes: Optional[BatchAxes] = None,
           mesh=None, fed=None, **kw) -> Result:
    """Execute `target`, whatever it is (see the module docstring).

    target     — Experiment | Sequence[Experiment] | ScenarioSpec |
                 FleetSpec | registered scenario or fleet name
    model      — required for ScenarioSpec / FleetSpec targets (specs
                 describe data and strategy, not the model)
    axes       — Experiment targets only: expand into a batched sweep
    mesh       — not ported yet (raises)
    fed        — required for ScenarioSpec / FleetSpec targets
    **kw       — forwarded: `strategies=`/`seeds=`/`scan=`/... for
                 scenarios (`scenarios.build_experiments`),
                 `checkpoint_dir=`/`eval_every=`/`rounds=` for fleets
                 (`scenarios.run_fleet`), Experiment field overrides for
                 single runs
    """
    from repro_torch.scenarios.compile import _run_scenario, run_fleet
    from repro_torch.scenarios.spec import FleetSpec, ScenarioSpec

    if mesh is not None:
        raise _not_ported("mesh= (sharding over devices)")
    if isinstance(target, str):
        target = _resolve_name(target)

    if isinstance(target, Experiment):
        if axes is not None:
            return _run_batch(target, axes, **kw)
        return _run(target, **kw)
    if isinstance(target, FleetSpec):
        if model is None or fed is None:
            raise ValueError("launch(FleetSpec) needs model= and fed=")
        return run_fleet(target, model, fed=fed, **kw)
    if isinstance(target, ScenarioSpec):
        if model is None or fed is None:
            raise ValueError("launch(ScenarioSpec) needs model= and fed=")
        return _run_scenario(target, model, fed=fed, **kw)
    if isinstance(target, Sequence):
        exps = list(target)
        if not all(isinstance(e, Experiment) for e in exps):
            raise TypeError(
                "launch: a sequence target must contain only Experiments")
        return _run_batch(experiments=exps, **kw)
    raise TypeError(
        f"launch: cannot dispatch on {type(target).__name__}; expected an "
        "Experiment, a sequence of Experiments, a ScenarioSpec, a "
        "FleetSpec, or a registered scenario/fleet name")
