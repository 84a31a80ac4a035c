"""Scenario, partitioner and fleet registries, mirroring the strategy
registry (port of ``repro/scenarios/registry.py``).

* Partitioners — the callables in `repro_torch.data.partition`, tagged
  with the `kind` of thing they return ("indices": per-client index
  arrays over a flat dataset; "datasets": per-client
  SyntheticImageDatasets). The compiler dispatches on the kind.
* Scenarios — registered `ScenarioSpec` instances. A benchmark or test
  asks for `get_scenario("pathological_shards")` and (optionally)
  `replace()`s scale knobs.
* Fleets — registered `FleetSpec` instances (`get_fleet("fleet_100k")`).
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple

from repro_torch.api.registry import Registry
from repro_torch.data import partition as P
from repro_torch.scenarios.spec import FleetSpec, ScenarioSpec

SCENARIOS = Registry("scenario")
PARTITIONERS = Registry("partitioner")
FLEETS = Registry("fleet")

PARTITIONER_KINDS = ("indices", "datasets")


class PartitionerSpec(NamedTuple):
    fn: Callable
    kind: str        # "indices" | "datasets"


def register_partitioner(name: str, fn: Callable, *,
                         kind: str = "indices") -> Callable:
    if kind not in PARTITIONER_KINDS:
        raise ValueError(f"unknown partitioner kind {kind!r}; expected one "
                         f"of {PARTITIONER_KINDS}")
    PARTITIONERS.register(name, PartitionerSpec(fn, kind))
    return fn


def get_partitioner(name: str) -> PartitionerSpec:
    return PARTITIONERS.get(name)


def list_partitioners() -> List[str]:
    return PARTITIONERS.names()


def register_scenario(spec: ScenarioSpec) -> ScenarioSpec:
    SCENARIOS.register(spec.name, spec)
    return spec


def get_scenario(name: str) -> ScenarioSpec:
    return SCENARIOS.get(name)


def list_scenarios() -> List[str]:
    return SCENARIOS.names()


def register_fleet(spec: FleetSpec) -> FleetSpec:
    FLEETS.register(spec.name, spec)
    return spec


def get_fleet(name: str) -> FleetSpec:
    return FLEETS.get(name)


def list_fleets() -> List[str]:
    return FLEETS.names()


# ---------------------------------------------------------------------------
# Built-in partitioners (repro_torch.data.partition)
# ---------------------------------------------------------------------------

register_partitioner("dirichlet", P.dirichlet_partition)
register_partitioner("shards", P.shard_partition)
register_partitioner("quantity", P.quantity_skew_partition)
register_partitioner("mixed", P.mixed_skew_partition)
register_partitioner("domain_robin", P.domain_shift_partition,
                     kind="datasets")
register_partitioner("feature_ladder", P.feature_shift_partition,
                     kind="datasets")


# ---------------------------------------------------------------------------
# Built-in scenario catalog, the reference's. Scale knobs are defaults;
# benchmarks `replace()` them to their scale.
# ---------------------------------------------------------------------------

# The paper's two headline setups:
register_scenario(ScenarioSpec(
    name="dir_label_skew", family="label_skew",
    partitioner="dirichlet", partitioner_params={"beta": 0.3}))
register_scenario(ScenarioSpec(
    name="domain_shift", family="domain_shift",
    partitioner="domain_robin", noise=2.0))

# Survey-driven extensions (arXiv:2505.02426, arXiv:2502.09104):
register_scenario(ScenarioSpec(
    name="pathological_shards", family="label_skew",
    partitioner="shards", partitioner_params={"classes_per_client": 2}))
register_scenario(ScenarioSpec(
    name="quantity_skew", family="quantity_skew",
    partitioner="quantity", partitioner_params={"beta": 0.5}))
register_scenario(ScenarioSpec(
    name="mixed_skew", family="mixed_skew",
    partitioner="mixed",
    partitioner_params={"beta_label": 0.3, "beta_quantity": 0.5}))
register_scenario(ScenarioSpec(
    name="feature_shift_ladder", family="feature_shift",
    partitioner="feature_ladder", partitioner_params={"max_severity": 1.0}))

# Population-dynamics variants of the Dirichlet setup:
register_scenario(ScenarioSpec(
    name="partial_participation", family="label_skew",
    partitioner="dirichlet", partitioner_params={"beta": 0.3},
    n_clients=6, participation=0.67, dropout=(5,)))
register_scenario(ScenarioSpec(
    name="stragglers", family="label_skew",
    partitioner="dirichlet", partitioner_params={"beta": 0.3},
    stragglers=(1, 3), straggler_keep=0.4))


# ---------------------------------------------------------------------------
# Built-in fleet catalog, the reference's. The fleet never materializes:
# fleet_size is the id space the participation trace draws from; only each
# round's cohort exists in memory.
# ---------------------------------------------------------------------------

# The benchmark fleet: 10⁵ registered clients, uniform participation.
register_fleet(FleetSpec(
    name="fleet_100k", fleet_size=100_000, cohort_size=32, rounds=4))

# Full-coverage variant: a deterministic cyclic walk over 10⁶ clients.
register_fleet(FleetSpec(
    name="fleet_1m_cyclic", fleet_size=1_000_000, cohort_size=64,
    rounds=8, participation="cyclic"))

# Tiny smoke fleet for tests.
register_fleet(FleetSpec(
    name="fleet_smoke", fleet_size=1_000, cohort_size=8, rounds=2,
    samples_per_client=32))
