"""LocalTrainer: the optimizer, the training steps and the pool procedure
of one run (port of the per-step path of ``repro/api/trainer.py``).

A step takes a fresh leaf per parameter, differentiates the loss with
`torch.autograd.grad` and applies the functional optimizer update. Every
step is built over `fused_loss_for(loss_fn)` — for the paper CNN the
im2col + GEMM-kernel formulation — so each conv of each step runs its
forward and both gradients through the GEMM kernel on the card."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.api.pools import PoolBackend, backend_for
from repro_torch.api.results import ModelRecord
from repro_torch.configs.base import FedConfig
from repro_torch.core import distances as D
from repro_torch.kernels.local_step import fused_loss_for
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import Optimizer

Params = Dict[str, torch.Tensor]


def hp_regularized_loss(loss_fn: Callable, fed: FedConfig,
                        backend: PoolBackend) -> Callable:
    """Eq. 9 with (α, β) as arguments:
    ``full_loss(params, batch, pool, alpha, beta) -> (total, task)``.
    d1 and d2 from `D.eq9_distances` (the stacked pool's one sweep when
    both are on)."""

    def full_loss(params, batch, pool, alpha, beta):
        task = loss_fn(params, batch)
        total = task
        d1, d2 = D.eq9_distances(params, pool, fed.distance_measure,
                                 fed.use_d1, fed.use_d2, backend.d1)
        if d1 is not None:
            if fed.log_scale_distances:
                d1 = D.log_scale(d1, task)
            total = total - alpha * d1
        if d2 is not None:
            if fed.log_scale_distances:
                d2 = D.log_scale(d2, task)
            total = total + beta * d2
        return total, task

    return full_loss


def regularized_loss(loss_fn: Callable, fed: FedConfig,
                     backend: PoolBackend) -> Callable:
    """Eq. 9: L(m) = ℓ(m; D_i) − α·d1 + β·d2, with the appendix's
    log-calibration; d1 comes from the pool backend."""
    hp_loss = hp_regularized_loss(loss_fn, fed, backend)

    def full_loss(params, batch, pool):
        return hp_loss(params, batch, pool, fed.alpha, fed.beta)

    return full_loss


def _grad_step(objective: Callable, opt: Optimizer, params: Params,
               opt_state, step: int):
    """Differentiate ``objective(leaves) -> (total, task)`` at `params`
    and apply one optimizer update; returns (params, opt_state, task)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, task = objective(leaves)
    grads = torch.autograd.grad(total, list(leaves.values()))
    params, opt_state = opt.update(params, dict(zip(leaves, grads)),
                                   opt_state, step)
    return params, opt_state, task.detach()


def make_plain_step(loss_fn: Callable, opt: Optimizer):
    """(params, opt_state, batch, step) → (params, opt_state, task)."""

    def step_fn(params, opt_state, batch, step):
        def objective(p):
            task = loss_fn(p, batch)
            return task, task
        return _grad_step(objective, opt, params, opt_state, step)

    return step_fn


def make_pool_step(loss_fn: Callable, fed: FedConfig, opt: Optimizer,
                   backend: PoolBackend):
    """Regularized step; the pool rides along as an argument."""
    full_loss = regularized_loss(loss_fn, fed, backend)

    def step_fn(params, opt_state, batch, pool, step):
        return _grad_step(lambda p: full_loss(p, batch, pool), opt, params,
                          opt_state, step)

    return step_fn


class LocalTrainer:
    """Per-run training engine: optimizer + steps + pool procedure, all
    configured by the FedConfig. `optimizer` / `learning_rate` /
    `weight_decay` override the FedConfig's values (baselines like
    DFedAvgM train with their own local optimizer while sharing the rest
    of the config)."""

    def __init__(self, loss_fn: Callable, fed: FedConfig, *,
                 optimizer: Optional[str] = None,
                 learning_rate: Optional[float] = None,
                 weight_decay: Optional[float] = None):
        self.loss_fn = loss_fn
        self.fed = fed
        self.backend = backend_for(fed)
        self.opt = make_optimizer(
            optimizer if optimizer is not None else fed.optimizer,
            learning_rate if learning_rate is not None else fed.learning_rate,
            weight_decay=(weight_decay if weight_decay is not None
                          else fed.weight_decay))
        step_loss = fused_loss_for(loss_fn)
        self.plain_step = make_plain_step(step_loss, self.opt)
        self.pool_step = make_pool_step(step_loss, fed, self.opt,
                                        self.backend)

    def train(self, params: Params, data_iter, n_steps: int, *,
              pool: Any = None, step_fn: Optional[Callable] = None
              ) -> Tuple[Params, torch.Tensor]:
        """Run n_steps from a fresh optimizer state. With `pool`, the
        regularized step; `step_fn` overrides the step entirely (signature
        (params, opt_state, batch, step), e.g. a SAM step). The returned
        task loss is a device scalar; callers defer `float()` (a sync) to
        record time."""
        params = {k: v.detach().clone() for k, v in params.items()}
        opt_state = self.opt.init(params)
        task = torch.zeros(())
        for s in range(n_steps):
            batch = next(data_iter)
            if step_fn is not None:
                params, opt_state, task = step_fn(params, opt_state, batch,
                                                  s)
            elif pool is None:
                params, opt_state, task = self.plain_step(
                    params, opt_state, batch, s)
            else:
                params, opt_state, task = self.pool_step(
                    params, opt_state, batch, pool, s)
        return params, task

    def local_client_train(self, m_in: Params, data_iter, *,
                           on_model_end: Optional[Callable] = None,
                           ) -> Tuple[Params, Any, List[ModelRecord]]:
        """Paper Alg. 1 lines 3–17 for one client: seed the pool with the
        incoming model, train S diversity-regularized models (each from
        the pool average, Eq. 6), return (pool average, pool, per-model
        records). With use_pool=False trains one plain model.
        `on_model_end(record, params)` fires after each pool model."""
        fed = self.fed
        if not fed.use_pool:
            params, _ = self.train(m_in, data_iter, fed.e_local)
            return params, None, []

        pool = self.backend.create(m_in, fed)
        tasks: List[torch.Tensor] = []
        records: List[ModelRecord] = []
        for j in range(fed.pool_size):          # train S models
            m_j = pool.average()                # Eq. 6 init
            m_j, task = self.train(m_j, data_iter, fed.e_local, pool=pool)
            pool = pool.append(m_j)
            if on_model_end is not None:
                rec = ModelRecord(index=j, task_loss=float(task))
                records.append(rec)
                on_model_end(rec, m_j)
            else:
                tasks.append(task)
        if on_model_end is None:
            # one deferred sync after every model's work is queued
            records = [ModelRecord(index=j, task_loss=float(t))
                       for j, t in enumerate(tasks)]
        return pool.average(), pool, records
