"""`ScenarioSpec`: a declarative description of one non-IID federation,
and `FleetSpec`, a population-scale one (port of
``repro/scenarios/spec.py``).

A spec is *data* — which heterogeneity family, which partitioner at what
parameters, how many clients, who participates, who drops out or
straggles, and how evaluation is split — and the compiler in
`repro_torch.scenarios.compile` turns it into Experiments. Benchmark
setups are `replace` over registered specs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np

# Heterogeneity families (the two paper setups + the survey-driven axes:
# arXiv:2505.02426 §4, arXiv:2502.09104 §3).
FAMILIES = ("label_skew", "quantity_skew", "mixed_skew", "feature_shift",
            "domain_shift")
EVAL_SPLITS = ("global", "holdout")
PARTICIPATIONS = ("uniform", "cyclic")


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One non-IID scenario, fully declaratively.

    Population knobs compose with any partitioner: `participation`
    selects a seeded subset of clients per run, `dropout` removes fixed
    client indices entirely, and `stragglers` subsample the named
    clients' local data to `straggler_keep` (the step-budget proxy for
    slow clients — every client still trains the same `e_local` steps,
    a straggler just trains them on less data).

    Eval split policy: "global" draws a fresh held-out test set from the
    same generative process; "holdout" carves `holdout_frac` of the
    pooled training data *before* partitioning (index families only).
    `val_frac` > 0 additionally carves a per-client validation split
    (paper's 90/10) that rides along in the materialized data.
    """
    name: str
    family: str                     # one of FAMILIES
    partitioner: str                # registered partitioner name
    partitioner_params: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    # -- population -------------------------------------------------------
    n_clients: int = 4
    participation: float = 1.0      # fraction of (non-dropped) clients
    dropout: Tuple[int, ...] = ()   # client indices that never participate
    stragglers: Tuple[int, ...] = ()
    straggler_keep: float = 0.5     # data fraction a straggler keeps
    # -- data scale -------------------------------------------------------
    n_samples: int = 1600
    n_test: int = 400
    n_classes: int = 10
    side: int = 32
    noise: float = 2.5
    batch_size: int = 48
    # -- eval split policy ------------------------------------------------
    eval_split: str = "global"      # "global" | "holdout"
    holdout_frac: float = 0.2
    val_frac: float = 0.0           # per-client train/val carve

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}; expected one "
                             f"of {FAMILIES}")
        if self.eval_split not in EVAL_SPLITS:
            raise ValueError(f"unknown eval_split {self.eval_split!r}; "
                             f"expected one of {EVAL_SPLITS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError(
                f"participation must be in (0, 1], got {self.participation}")
        if not 0.0 < self.straggler_keep <= 1.0:
            raise ValueError(
                f"straggler_keep must be in (0, 1], got "
                f"{self.straggler_keep}")
        if not 0.0 < self.holdout_frac < 1.0:
            raise ValueError(
                f"holdout_frac must be in (0, 1), got {self.holdout_frac}")
        if not 0.0 <= self.val_frac < 1.0:
            raise ValueError(
                f"val_frac must be in [0, 1), got {self.val_frac}")
        for field in ("dropout", "stragglers"):
            bad = [c for c in getattr(self, field)
                   if not 0 <= c < self.n_clients]
            if bad:
                raise ValueError(f"{field} indices {bad} out of range for "
                                 f"n_clients={self.n_clients}")
        if len(set(self.dropout)) >= self.n_clients:
            raise ValueError("dropout removes every client")

    # -- population resolution -------------------------------------------

    @property
    def n_active(self) -> int:
        """Participating client count — a pure function of the spec (not
        the seed), so every seed of a sweep compiles into one group."""
        remaining = self.n_clients - len(set(self.dropout))
        return max(1, int(round(self.participation * remaining)))

    def active_clients(self, seed: int = 0) -> List[int]:
        """The client indices that enter the visit order for this seed:
        dropouts removed, then a seeded choice of `n_active` of the rest
        (sorted — the Experiment's `order` handles visit sequencing)."""
        remaining = [c for c in range(self.n_clients)
                     if c not in set(self.dropout)]
        if self.n_active >= len(remaining):
            return remaining
        rng = np.random.default_rng(seed + 7919)
        picked = rng.choice(len(remaining), size=self.n_active,
                            replace=False)
        return sorted(remaining[i] for i in picked)

    def replace(self, **kw) -> "ScenarioSpec":
        """`dataclasses.replace` convenience — benchmark configs derive
        from registered specs by overriding scale knobs."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """A population-scale federation, fully declaratively: a registered
    fleet of `fleet_size` clients (10⁵–10⁶, far beyond what a run ever
    materializes), a seeded participation trace drawing a cohort a round,
    and an `independent`-topology strategy whose aggregate is broadcast
    into the next round.

    Every piece is a pure function of (spec, round): `cohort(r)` draws the
    same ids on every call, each client's shard is a pure function of its
    id (`repro_torch.data.make_fleet_client_dataset`), and the round seeds
    fold `seed` with `r`, so a sweep resumed from a round checkpoint is
    bitwise the uninterrupted run.

    `participation`:
      "uniform" — cohort_size ids drawn uniformly without replacement
                  (sorted; independent draws per round)
      "cyclic"  — a round-robin walk over the fleet, cohort r covering
                  ids [r·cohort, (r+1)·cohort) mod fleet_size

    The strategy must be a registered plan with `independent` topology and
    a `shared_init` broadcast honoring `init_params` (dfedavgm, dfedsam);
    `run_fleet` checks it, so specs import without the strategy registry.
    """
    name: str
    fleet_size: int = 100_000
    cohort_size: int = 32
    rounds: int = 4
    strategy: str = "dfedavgm"
    participation: str = "uniform"
    # -- per-client data scale (see make_fleet_client_dataset) ------------
    samples_per_client: int = 64
    n_classes: int = 10
    side: int = 32
    noise: float = 2.5
    label_beta: float = 0.3
    batch_size: int = 16
    n_test: int = 400
    seed: int = 0

    def __post_init__(self):
        if self.participation not in PARTICIPATIONS:
            raise ValueError(
                f"unknown participation trace {self.participation!r}; "
                f"expected one of {PARTICIPATIONS}")
        if self.cohort_size < 1 or self.cohort_size > self.fleet_size:
            raise ValueError(
                f"cohort_size must be in [1, fleet_size={self.fleet_size}]"
                f", got {self.cohort_size}")
        if self.rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {self.rounds}")

    def cohort(self, r: int) -> np.ndarray:
        """Round r's participating client ids — deterministic in
        (spec.seed, participation, r), independent of execution history."""
        if self.participation == "cyclic":
            start = (r * self.cohort_size) % self.fleet_size
            return ((start + np.arange(self.cohort_size))
                    % self.fleet_size).astype(np.int64)
        rng = np.random.default_rng((self.seed, 0xC0807, r))
        ids = rng.choice(self.fleet_size, size=self.cohort_size,
                         replace=False)
        return np.sort(ids).astype(np.int64)

    def replace(self, **kw) -> "FleetSpec":
        return dataclasses.replace(self, **kw)
