"""The engine: one Experiment through the strategy registry (port of
``repro/api/engine.py``). `Experiment` takes a `seed` (default
``fed.seed``) where the reference takes a PRNG key; initial parameters
come from ``model.init(seed)`` unless the strategy honors a given
`init_params`."""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.api.results import RunResult
from repro_torch.api.strategies import get_strategy_spec


@dataclasses.dataclass
class Callbacks:
    """on_model_end(record: ModelRecord, params)   — after each pool model
    on_client_end(record: ClientRecord | RoundRecord, params)
                                                 — after each client / round
    """
    on_model_end: Optional[Callable] = None
    on_client_end: Optional[Callable] = None


@dataclasses.dataclass
class Experiment:
    """A fully specified federated run. `client_iters` are per-client
    infinite batch streams on the model's device: `repro_torch.data.
    batch_iterator`s, or `DataPlan`s, whose visits take the captured local
    phase (`scan=True`) or the per-step loop over their device arrays."""
    model: Any                        # repro_torch.models.Model
    client_iters: Sequence[Any]
    fed: Any                          # FedConfig
    strategy: str = "fedelmy"
    seed: Optional[int] = None        # default: fed.seed
    eval_fn: Optional[Callable] = None
    order: Optional[Sequence[int]] = None   # client visit order
    init_params: Optional[Dict[str, Any]] = None   # skip model.init
    shots: int = 1                    # T for few-shot strategies
    strategy_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    callbacks: Callbacks = dataclasses.field(default_factory=Callbacks)

    def resolved_seed(self) -> int:
        return self.seed if self.seed is not None else self.fed.seed

    def resolved_order(self) -> list:
        return (list(self.order) if self.order is not None
                else list(range(len(self.client_iters))))


def warn_unsupported_fields(experiment: Experiment) -> None:
    """Warn when an optional Experiment field is set that the strategy
    does not honor."""
    spec = get_strategy_spec(experiment.strategy)
    for field, is_set in (("init_params", experiment.init_params is not None),
                          ("order", experiment.order is not None),
                          ("shots", experiment.shots != 1)):
        if is_set and field not in spec.supports:
            warnings.warn(
                f"strategy {experiment.strategy!r} ignores "
                f"Experiment.{field}; it honors "
                f"{sorted(spec.supports) or 'no optional fields'}",
                UserWarning, stacklevel=3)


def finalize_result(experiment: Experiment, out, wall_time_s: float,
                    ) -> RunResult:
    """Wrap a StrategyOutput into a RunResult: final metric + timing. The
    last record's metric (the last round's, else the last client's) is
    reused when it already evaluated the final params."""
    final = None
    if experiment.eval_fn is not None:
        last = out.rounds[-1] if out.rounds else \
            out.clients[-1] if out.clients else None
        final = (last.global_metric
                 if last is not None and last.global_metric is not None
                 else float(experiment.eval_fn(out.params)))
    return RunResult(strategy=experiment.strategy, params=out.params,
                     fed=experiment.fed, clients=out.clients,
                     rounds=out.rounds, final_metric=final,
                     wall_time_s=wall_time_s, final_pool=out.final_pool)


def _run(experiment: Optional[Experiment] = None, **kwargs) -> RunResult:
    """Execute an Experiment (or its fields as keywords) through the
    strategy registry; the implementation behind `launch`."""
    if experiment is None:
        experiment = Experiment(**kwargs)
    elif kwargs:
        experiment = dataclasses.replace(experiment, **kwargs)
    spec = get_strategy_spec(experiment.strategy)
    warn_unsupported_fields(experiment)
    t0 = time.time()
    out = spec.fn(experiment)
    return finalize_result(experiment, out, time.time() - t0)
