"""`repro_torch.scenarios` — declarative non-IID scenarios and fleets
(port of ``repro/scenarios``).

A `ScenarioSpec` describes one heterogeneity setup as data (family,
partitioner + params, client population, dropout/straggler schedule,
eval-split policy); a `FleetSpec` a population-scale federation (a
registered fleet of 10⁵–10⁶ clients, a seeded participation trace, a
cohort a round). The registries mirror the strategy registry, and
`repro_torch.api.launch` is the front door for both:

    from repro_torch.api import launch
    from repro_torch.scenarios import get_fleet, get_scenario

    batch = launch(get_scenario("quantity_skew"), model, fed=fed,
                   strategies=("fedelmy", "fedseq"), seeds=(0, 1))
    fleet = launch(get_fleet("fleet_100k"), model, fed=fed,
                   checkpoint_dir="ckpt/fleet")
"""
from repro_torch.scenarios.compile import (CohortData, ScenarioData,
                                           accuracy_eval, build_experiments,
                                           fleet_eval, materialize,
                                           materialize_cohort, run_fleet)
from repro_torch.scenarios.registry import (FLEETS, PARTITIONERS, SCENARIOS,
                                            PartitionerSpec, get_fleet,
                                            get_partitioner, get_scenario,
                                            list_fleets, list_partitioners,
                                            list_scenarios, register_fleet,
                                            register_partitioner,
                                            register_scenario)
from repro_torch.scenarios.spec import (EVAL_SPLITS, FAMILIES,
                                        PARTICIPATIONS, FleetSpec,
                                        ScenarioSpec)

__all__ = [
    "ScenarioSpec", "ScenarioData", "FAMILIES", "EVAL_SPLITS",
    "FleetSpec", "CohortData", "PARTICIPATIONS",
    "register_scenario", "get_scenario", "list_scenarios", "SCENARIOS",
    "register_fleet", "get_fleet", "list_fleets", "FLEETS",
    "register_partitioner", "get_partitioner", "list_partitioners",
    "PARTITIONERS", "PartitionerSpec",
    "materialize", "build_experiments", "accuracy_eval",
    "materialize_cohort", "run_fleet", "fleet_eval",
]
