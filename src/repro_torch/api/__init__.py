"""`repro_torch.api` — the federated-run engine of the port:
``launch(Experiment(strategy="fedelmy"))`` runs paper Algorithm 1."""
from repro_torch.api.engine import Callbacks, Experiment
from repro_torch.api.launch import launch
from repro_torch.api.plan import LocalBlock, StrategyPlan, Topology, interpret
from repro_torch.api.pools import (PoolBackend, backend_for, get_pool_backend,
                                   register_pool_backend)
from repro_torch.api.results import (ClientRecord, ModelRecord, RunResult,
                                     StrategyOutput)
from repro_torch.api.strategies import (get_strategy_spec, list_strategies,
                                        register_plan)
from repro_torch.api.trainer import (LocalTrainer, make_plain_step,
                                     make_pool_step, regularized_loss)

__all__ = [
    "launch", "Experiment", "Callbacks",
    "RunResult", "ClientRecord", "ModelRecord",
    "StrategyOutput", "StrategyPlan", "Topology", "LocalBlock", "interpret",
    "register_plan", "get_strategy_spec", "list_strategies",
    "register_pool_backend", "get_pool_backend", "PoolBackend",
    "backend_for", "LocalTrainer", "make_plain_step", "make_pool_step",
    "regularized_loss",
]
