"""`repro_torch.api.launch` — the one front door for federated execution
(port of ``repro/api/launch.py``). It dispatches on what it is given:

    launch(experiment)                       -> RunResult
    launch([exp0, exp1, ...])                -> BatchResult
    launch(scenario_spec, model, fed=fed)    -> BatchResult
    launch("dir_label_skew", model, fed=fed) -> BatchResult  (registry)

    launch(experiment, axes=BatchAxes(...)) -> BatchResult

Sweeps (a list, a scenario, `axes=`) go through the batched engine
(`api.batch._run_batch`): compatible experiments form one group, one
batched program. Fleets (`FleetSpec`) and `mesh=` are not ported yet and
raise.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

from repro_torch.api.batch import BatchAxes, _run_batch
from repro_torch.api.engine import Experiment, _run

Result = Any   # RunResult | BatchResult


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"launch: {what} is not ported yet (fleets and device meshes "
        "come with a later slice of the port)")


def _resolve_name(name: str):
    """A registered scenario name → its spec."""
    from repro_torch.scenarios.registry import SCENARIOS
    try:
        return SCENARIOS.get(name)
    except ValueError:
        raise ValueError(
            f"launch: {name!r} names no registered scenario (see "
            "repro_torch.scenarios.list_scenarios(); fleets are not "
            "ported yet)") from None


def launch(target, model=None, *, axes: Optional[BatchAxes] = None,
           mesh=None, fed=None, **kw) -> Result:
    """Execute `target`, whatever it is (see the module docstring).

    target     — Experiment | Sequence[Experiment] | ScenarioSpec |
                 registered scenario name
    model      — required for ScenarioSpec targets (specs describe data
                 and strategy, not the model)
    axes       — Experiment targets only: expand into a batched sweep
    mesh       — not ported yet (raises)
    fed        — required for ScenarioSpec targets
    **kw       — forwarded: `strategies=`/`seeds=`/`scan=`/... for
                 scenarios (`scenarios.build_experiments`), Experiment
                 field overrides for single runs
    """
    from repro_torch.scenarios.compile import _run_scenario
    from repro_torch.scenarios.spec import ScenarioSpec

    if mesh is not None:
        raise _not_ported("mesh= (sharding over devices)")
    if type(target).__name__ == "FleetSpec":
        raise _not_ported("a FleetSpec target")
    if isinstance(target, str):
        target = _resolve_name(target)

    if isinstance(target, Experiment):
        if axes is not None:
            return _run_batch(target, axes, **kw)
        return _run(target, **kw)
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
        "Experiment, a sequence of Experiments, a ScenarioSpec or a "
        "registered scenario name")
