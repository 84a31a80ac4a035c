"""`repro_torch.api.launch` — the front door for federated execution
(port of the Experiment branch of ``repro/api/launch.py``)."""
from __future__ import annotations

from repro_torch.api.engine import Experiment, _run
from repro_torch.api.results import RunResult


def launch(target, **kw) -> RunResult:
    """Run an `Experiment`; keyword arguments override its fields. Sweeps,
    scenarios and fleets are not ported yet."""
    if isinstance(target, Experiment):
        return _run(target, **kw)
    raise TypeError(
        f"launch: cannot dispatch on {type(target).__name__}; this port "
        "runs single Experiments (sweeps, scenarios and fleets are not "
        "ported yet)")
