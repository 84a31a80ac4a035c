"""FedELMY: the Eq. 9 regularized objective and the deprecated driver
wrappers (port of ``repro/core/fedelmy.py``).

The drivers (Algorithm 1 one-shot SFL, Algorithm 2 few-shot, Algorithm 3
decentralized PFL) are registered strategies of `repro_torch.api`; use::

    from repro_torch.api import Experiment, launch
    result = launch(Experiment(model=model, client_iters=iters, fed=fed,
                               strategy="fedelmy"))

The ``run_fedelmy*`` functions below warn, delegate to `launch` and return
the legacy ``(params, history)`` tuples. They take an int `seed` where the
reference takes a PRNG key, as `Experiment` does."""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, Optional, Sequence

from repro_torch.configs.base import FedConfig
from repro_torch.core import distances as D
from repro_torch.core.pool import MomentPool

Params = Dict[str, Any]


def fedelmy_loss(loss_fn: Callable, params: Params, batch, pool,
                 fed: FedConfig):
    """L(m) = ℓ(m; D_i) − α·d1 + β·d2, with the appendix's log-calibration.

    Reference form with an isinstance dispatch on the pool; the engine's
    trainer builds the same objective from the pool-backend registry
    (`repro_torch.api.trainer.regularized_loss`)."""
    task = loss_fn(params, batch)
    total = task
    d1, d2 = D.eq9_distances(
        params, pool, fed.distance_measure, fed.use_d1, fed.use_d2,
        (lambda p, pool, measure: D.d1_moment(p, pool))
        if isinstance(pool, MomentPool) else D.d1_pool_distance)
    if d1 is not None:
        if fed.log_scale_distances:
            d1 = D.log_scale(d1, task)
        total = total - fed.alpha * d1
    if d2 is not None:
        if fed.log_scale_distances:
            d2 = D.log_scale(d2, task)
        total = total + fed.beta * d2
    return total, task


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use repro_torch.api.launch({new}) instead",
        DeprecationWarning, stacklevel=3)


def run_fedelmy(model, client_iters: Sequence, fed: FedConfig, seed: int,
                eval_fn: Optional[Callable] = None,
                order: Optional[Sequence[int]] = None,
                init_params: Optional[Params] = None,
                return_final_pool: bool = False):
    """Deprecated: Algorithm 1 via the engine. Returns (m_final, history)
    [+ final pool]."""
    _deprecated("run_fedelmy", "Experiment(strategy='fedelmy', ...)")
    from repro_torch.api import Experiment, launch
    res = launch(Experiment(model=model, client_iters=client_iters, fed=fed,
                            strategy="fedelmy", seed=seed, eval_fn=eval_fn,
                            order=order, init_params=init_params))
    if return_final_pool:
        return res.params, res.history(), res.final_pool
    return res.params, res.history()


def run_fedelmy_fewshot(model, client_iters: Sequence, fed: FedConfig,
                        seed: int, shots: int,
                        eval_fn: Optional[Callable] = None):
    """Deprecated: Algorithm 2 via the engine."""
    _deprecated("run_fedelmy_fewshot",
                "Experiment(strategy='fedelmy_fewshot', shots=T, ...)")
    from repro_torch.api import Experiment, launch
    res = launch(Experiment(model=model, client_iters=client_iters, fed=fed,
                            strategy="fedelmy_fewshot", seed=seed,
                            eval_fn=eval_fn, shots=shots))
    return res.params, res.history()


def run_fedelmy_pfl(model, client_iters: Sequence, fed: FedConfig, seed: int,
                    eval_fn: Optional[Callable] = None):
    """Deprecated: Algorithm 3 via the engine."""
    _deprecated("run_fedelmy_pfl", "Experiment(strategy='fedelmy_pfl', ...)")
    from repro_torch.api import Experiment, launch
    res = launch(Experiment(model=model, client_iters=client_iters, fed=fed,
                            strategy="fedelmy_pfl", seed=seed,
                            eval_fn=eval_fn))
    history = ([{"global_acc": res.final_metric}]
               if res.final_metric is not None else [])
    return res.params, history
