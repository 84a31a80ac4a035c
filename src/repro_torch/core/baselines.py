"""Deprecated baseline driver wrappers (paper §4.1; port of
``repro/core/baselines.py``).

The baselines (FedSeq, DFedAvgM, DFedSAM, MetaFed, local_only) are
registered strategies of `repro_torch.api`; use::

    from repro_torch.api import Experiment, launch
    m = launch(Experiment(model=model, client_iters=iters, fed=fed,
                          strategy="fedseq")).params

The ``run_*`` functions below warn, delegate to `launch` and return the
bare final params. They take an int `seed` where the reference takes a
PRNG key. ``BASELINES`` keeps the legacy name → driver map."""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

from repro_torch.configs.base import FedConfig


def _run(strategy: str, model, client_iters, fed, seed, **exp_kw):
    warnings.warn(
        f"run_{strategy} is deprecated; use repro_torch.api.launch("
        f"Experiment(strategy={strategy!r}, ...)) instead",
        DeprecationWarning, stacklevel=3)
    from repro_torch.api import Experiment, launch
    return launch(Experiment(model=model, client_iters=client_iters, fed=fed,
                             strategy=strategy, seed=seed, **exp_kw)).params


def run_fedseq(model, client_iters: Sequence, fed: FedConfig, seed: int,
               order: Optional[Sequence[int]] = None, init_params=None):
    """Deprecated: one-shot sequential chain via the engine."""
    return _run("fedseq", model, client_iters, fed, seed, order=order,
                init_params=init_params)


def run_dfedavgm(model, client_iters: Sequence, fed: FedConfig, seed: int):
    """Deprecated: decentralized FedAvg-with-momentum via the engine."""
    return _run("dfedavgm", model, client_iters, fed, seed)


def run_dfedsam(model, client_iters: Sequence, fed: FedConfig, seed: int,
                rho: float = 0.05):
    """Deprecated: DFedAvgM + SAM local steps via the engine."""
    return _run("dfedsam", model, client_iters, fed, seed,
                strategy_options={"rho": rho})


def run_metafed(model, client_iters: Sequence, fed: FedConfig, seed: int,
                anchor_beta: float = 0.5):
    """Deprecated: cyclic accumulation + anchored personalization."""
    return _run("metafed", model, client_iters, fed, seed,
                strategy_options={"anchor_beta": anchor_beta})


def run_local_only(model, client_iters: Sequence, fed: FedConfig, seed: int,
                   client: int = 0):
    """Deprecated: single-client sanity floor via the engine."""
    return _run("local_only", model, client_iters, fed, seed,
                strategy_options={"client": client})


BASELINES = {
    "fedseq": run_fedseq,
    "dfedavgm": run_dfedavgm,
    "dfedsam": run_dfedsam,
    "metafed": run_metafed,
    "local_only": run_local_only,
}
