"""`repro_torch.api` — the federated-run engine of the port:
``launch(Experiment(strategy=...))`` runs any of the eight registered
strategies (paper Algorithms 1–3 and the Table 1 baselines), over
`batch_iterator` or `DataPlan` streams; ``launch(scenario_spec, model,
fed=fed, strategies=..., seeds=...)`` runs a registered scenario's sweep
(a `BatchResult`); ``launch(experiment, axes=BatchAxes(seeds=...,
fed_grid=...))`` and ``launch([exp, ...])`` run sweeps through the batched
engine (`api.batch`), each group of compatible runs one batched program;
``launch(fleet_spec, model, fed=fed)`` runs a fleet's cohort rounds (a
`FleetResult`; `checkpoint_dir=` makes it resumable)."""
from repro_torch.api.batch import BatchAxes, run_batch
from repro_torch.api.engine import (Callbacks, Experiment,
                                    warn_unsupported_fields)
from repro_torch.api.launch import launch
from repro_torch.api.plan import (LocalBlock, StrategyPlan, Topology,
                                  interpret, interpret_batched,
                                  per_client_seeds, tree_mean)
from repro_torch.api.pools import (PoolBackend, backend_for, get_pool_backend,
                                   list_pool_backends, register_pool_backend)
from repro_torch.api.results import (BatchResult, ClientRecord, CohortRecord,
                                     FleetResult, ModelRecord, RoundRecord,
                                     RunResult, StrategyOutput)
from repro_torch.api.strategies import (describe_strategies, get_plan,
                                        get_strategy_spec, list_strategies,
                                        register_plan, register_strategy)
from repro_torch.api.trainer import (BatchedScannedPhase, LocalTrainer,
                                     ScannedPhase, make_batched_plain_step,
                                     make_batched_pool_step, make_plain_step,
                                     make_pool_step, regularized_loss,
                                     stack_trees, unstack_tree)

__all__ = [
    "launch", "Experiment", "Callbacks", "warn_unsupported_fields",
    "BatchAxes", "run_batch", "interpret_batched", "stack_trees",
    "unstack_tree", "BatchedScannedPhase", "make_batched_plain_step",
    "make_batched_pool_step",
    "RunResult", "BatchResult", "ClientRecord", "ModelRecord", "RoundRecord",
    "CohortRecord", "FleetResult",
    "StrategyOutput", "StrategyPlan", "Topology", "LocalBlock", "interpret",
    "per_client_seeds", "tree_mean",
    "register_plan", "register_strategy", "get_plan", "get_strategy_spec",
    "list_strategies", "describe_strategies",
    "register_pool_backend", "get_pool_backend", "list_pool_backends",
    "PoolBackend",
    "backend_for", "LocalTrainer", "ScannedPhase", "make_plain_step",
    "make_pool_step",
    "regularized_loss",
]
