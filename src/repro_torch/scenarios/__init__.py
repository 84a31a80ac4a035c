"""`repro_torch.scenarios` — declarative non-IID scenarios (port of
``repro/scenarios``; fleets are not ported yet).

A `ScenarioSpec` describes one heterogeneity setup as data (family,
partitioner + params, client population, dropout/straggler schedule,
eval-split policy); the registries mirror the strategy registry, and
`repro_torch.api.launch` is the front door:

    from repro_torch.api import launch
    from repro_torch.scenarios import get_scenario

    batch = launch(get_scenario("quantity_skew"), model, fed=fed,
                   strategies=("fedelmy", "fedseq"), seeds=(0, 1))
"""
from repro_torch.scenarios.compile import (ScenarioData, accuracy_eval,
                                           build_experiments, materialize)
from repro_torch.scenarios.registry import (PARTITIONERS, SCENARIOS,
                                            PartitionerSpec,
                                            get_partitioner, get_scenario,
                                            list_partitioners,
                                            list_scenarios,
                                            register_partitioner,
                                            register_scenario)
from repro_torch.scenarios.spec import EVAL_SPLITS, FAMILIES, ScenarioSpec

__all__ = [
    "ScenarioSpec", "ScenarioData", "FAMILIES", "EVAL_SPLITS",
    "register_scenario", "get_scenario", "list_scenarios", "SCENARIOS",
    "register_partitioner", "get_partitioner", "list_partitioners",
    "PARTITIONERS", "PartitionerSpec",
    "materialize", "build_experiments", "accuracy_eval",
]
