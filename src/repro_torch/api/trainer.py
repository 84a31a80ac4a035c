"""LocalTrainer: the optimizer, the training steps and the pool procedure
of one run, or of a group of B runs with a leading run axis (port of
``repro/api/trainer.py``: the per-step path, the scanned local phase
`train_scanned` / `local_client_train_scanned`, and their batched forms).

A step takes a fresh leaf per parameter, differentiates the loss with
`torch.autograd.grad` and applies the functional optimizer update. Every
step is built over `fused_loss_for(loss_fn)` — for the paper CNN the
im2col + GEMM-kernel formulation — so each conv of each step runs its
forward and both gradients through the GEMM kernel on the card. The step
counter is an int32 tensor on the parameters' device in every path.

The scanned local phase (`ScannedPhase`) runs a visit's steps over a
`DataPlan`'s schedule rows with the batch gathered on the device. On CUDA
each step kind (plain, pool) is captured once in a CUDA graph and
replayed for every later step of every visit of the run; its static
buffers are the parameters, the optimizer state, the pool (with its
count), the step counter, the row pointer, the visit's rows and the
client's arrays. On the CPU the same step body runs in a plain loop.

Batched runs (`train_batched`, `local_client_train_batched` and their
scanned forms, behind `plan.interpret_batched`) carry params, optimizer
state, batches and pools stacked along a leading run axis (`stack_trees`
/ `unstack_tree`). A batched step evaluates the one-run objective under
`torch.func.vmap` over that axis, so the GEMM and the pool-distance
sweep each take one launch for all B runs (their autograd Functions'
vmap rules); autograd of the runs' summed objective on the stacked
leaves gives each run its own gradient (one launch a backward product),
and the optimizer, elementwise, updates the stacked leaves directly. α
and β are per-run (B,) tensors. The batched scanned phase
(`BatchedScannedPhase`) captures one CUDA graph a step kind for the whole
group."""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.api.pools import PoolBackend, backend_for
from repro_torch.api.results import ModelRecord
from repro_torch.configs.base import FedConfig
from repro_torch.core import distances as D
from repro_torch.core.pool import ModelPool, _check_room, _tensors
from repro_torch.data.plan import DataPlan, gather, stack_plan_indices
from repro_torch.kernels import build
from repro_torch.kernels.local_step import fused_loss_for
from repro_torch.optim import make_optimizer
from repro_torch.optim.optimizers import Optimizer, apply_in_place

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
               opt_state, step: int, in_place: bool = False):
    """Differentiate ``objective(leaves) -> (total, task)`` at `params`
    and apply one optimizer update; returns (params, opt_state, task).
    `in_place` writes the update into `params` and `opt_state` themselves
    (`apply_in_place`: the same bits) and returns them."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, task = objective(leaves)
    grads = dict(zip(leaves, torch.autograd.grad(total,
                                                 list(leaves.values()))))
    if in_place:
        apply_in_place(opt, params, grads, opt_state, step)
    else:
        params, opt_state = opt.update(params, grads, opt_state, step)
    return params, opt_state, task.detach()


def make_plain_step(loss_fn: Callable, opt: Optimizer):
    """(params, opt_state, batch, step, in_place=False) → (params,
    opt_state, task); `step` an int or an int32 device tensor."""

    def step_fn(params, opt_state, batch, step, in_place=False):
        def objective(p):
            task = loss_fn(p, batch)
            return task, task
        return _grad_step(objective, opt, params, opt_state, step, in_place)

    return step_fn


def make_pool_step(loss_fn: Callable, fed: FedConfig, opt: Optimizer,
                   backend: PoolBackend):
    """Regularized step; the pool rides along as an argument."""
    full_loss = regularized_loss(loss_fn, fed, backend)

    def step_fn(params, opt_state, batch, pool, step, in_place=False):
        return _grad_step(lambda p: full_loss(p, batch, pool), opt, params,
                          opt_state, step, in_place)

    return step_fn


# ---------------------------------------------------------------------------
# Batched runs: stacked trees and the vmapped steps
# ---------------------------------------------------------------------------

def _map_tree(fn: Callable, *trees: Any) -> Any:
    """`fn` over the tensors of structurally equal pytrees (dicts, tuples,
    NamedTuples); other leaves (None) pass through from the first."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, dict):
        if any(not isinstance(t, dict) or list(t) != list(t0)
               for t in trees):
            raise ValueError(f"keys differ: {[list(t) for t in trees]}")
        return {k: _map_tree(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        if any(type(t) is not type(t0) or len(t) != len(t0) for t in trees):
            raise ValueError("tuples differ in type or length")
        parts = [_map_tree(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*parts) if hasattr(t0, "_fields") else \
            type(t0)(parts)
    return t0


def stack_trees(trees: List[Any]) -> Any:
    """Stack structurally identical pytrees (parameter dicts, batches,
    pools) along a new leading run axis. Mismatched leaves raise."""
    try:
        return _map_tree(lambda *xs: torch.stack(xs), *trees)
    except (ValueError, TypeError, RuntimeError) as e:
        raise ValueError(
            "run_batch requires structurally identical pytrees across the "
            f"batch (same leaves, shapes and dtypes): {e}") from e


def unstack_tree(tree: Any, i: int) -> Any:
    """Run `i` of a stacked pytree (inverse of `stack_trees`)."""
    return _map_tree(lambda x: x[i], tree)


def batched_grad_step(objective: Callable, opt: Optimizer, params: Params,
                      opt_state, step, *mapped):
    """One step of B runs: ``objective(leaves, *mapped_i) -> (total,
    task)`` is one run's, evaluated under `torch.func.vmap` over the
    leading run axis of `params` and of every tensor in `mapped`;
    autograd of the summed totals on the stacked leaves gives each run its
    gradient, and the optimizer updates the stacked leaves (elementwise,
    so each run's slice is its own update). Returns (params, opt_state,
    (B,) task)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, task = torch.func.vmap(objective)(leaves, *mapped)
    grads = torch.autograd.grad(total.sum(), list(leaves.values()))
    params, opt_state = opt.update(params, dict(zip(leaves, grads)),
                                   opt_state, step)
    return params, opt_state, task.detach()


def make_batched_plain_step(loss_fn: Callable, opt: Optimizer):
    """`make_plain_step` over B runs: (params, opt_state, batch, step) →
    (params, opt_state, (B,) task), every argument but the step counter
    with a leading run axis."""

    def objective(p, batch):
        task = loss_fn(p, batch)
        return task, task

    def step_fn(params, opt_state, batch, step):
        return batched_grad_step(objective, opt, params, opt_state, step,
                                 batch)

    return step_fn


def make_batched_pool_step(loss_fn: Callable, fed: FedConfig, opt: Optimizer,
                           backend: PoolBackend):
    """The regularized step over B runs: (params, opt_state, batch, pools,
    alphas, betas, step) → (params, opt_state, (B,) task), with stacked
    pools and per-run (B,) α and β (the Fig. 10 grid in one group)."""
    full_loss = hp_regularized_loss(loss_fn, fed, backend)

    def step_fn(params, opt_state, batch, pools, alphas, betas, step):
        return batched_grad_step(full_loss, opt, params, opt_state, step,
                                 batch, pools, alphas, betas)

    return step_fn


def batched_pool_average(pools: Any) -> Params:
    """Eq. 5/6 of each run's pool, stacked."""
    return torch.func.vmap(lambda pool: pool.average())(pools)


def batched_pool_append(pools: Any, params: Params) -> Any:
    """Each run's pool with its run's `params` appended (the runs of a
    group hold equal counts: one check of the room for all)."""
    first = unstack_tree(pools, 0)
    if hasattr(first, "capacity"):
        _check_room(first.count, first.capacity)
    return torch.func.vmap(lambda pool, m: pool._append(m))(pools, params)


def _model_records(task_grid: torch.Tensor, b: int
                   ) -> List[List[ModelRecord]]:
    """(S, B) last-step task losses → per-run ModelRecord lists, read in
    one transfer."""
    grid = task_grid.tolist()
    return [[ModelRecord(index=j, task_loss=row[i])
             for j, row in enumerate(grid)] for i in range(b)]


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
        self.batched_plain_step = make_batched_plain_step(step_loss,
                                                          self.opt)
        self.batched_pool_step = make_batched_pool_step(
            step_loss, fed, self.opt, self.backend)

    def train(self, params: Params, data_iter, n_steps: int, *,
              pool: Any = None, step_fn: Optional[Callable] = None
              ) -> Tuple[Params, torch.Tensor]:
        """Run n_steps from a fresh optimizer state. With `pool`, the
        regularized step; `step_fn` overrides the step entirely (signature
        (params, opt_state, batch, step), e.g. a SAM step). Step s gets the
        int32 device tensor s. The returned task loss is a device scalar;
        callers defer `float()` (a sync) to record time."""
        params = {k: v.detach().clone() for k, v in params.items()}
        opt_state = self.opt.init(params)
        task = torch.zeros(())
        steps = torch.arange(n_steps, dtype=torch.int32,
                             device=next(iter(params.values())).device)
        for s in range(n_steps):
            batch = next(data_iter)
            if step_fn is not None:
                params, opt_state, task = step_fn(params, opt_state, batch,
                                                  steps[s])
            elif pool is None:
                params, opt_state, task = self.plain_step(
                    params, opt_state, batch, steps[s])
            else:
                params, opt_state, task = self.pool_step(
                    params, opt_state, batch, pool, steps[s])
        return params, task

    def train_scanned(self, params: Params, plan: DataPlan,
                      n_steps: int) -> Tuple[Params, torch.Tensor]:
        """Plain `train` over the plan's next n_steps schedule rows, the
        batches gathered on the device: on CUDA the step captured once in
        a CUDA graph and replayed (`ScannedPhase`). Bitwise the per-step
        `train` over the same plan."""
        return self.scanned.train(params, plan, n_steps)

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

    def local_client_train_scanned(self, m_in: Params, plan: DataPlan,
                                   pool_out: Optional[str] = "copy"
                                   ) -> Tuple[Params, Any,
                                              List[ModelRecord]]:
        """`local_client_train` over the plan's next S·e_local schedule
        rows: S pool models × e_local steps (pool average init, the
        regularized step, pool append), on CUDA the step captured once in
        a CUDA graph and replayed (`ScannedPhase`); the per-model task
        losses come back in one sync. Bitwise the per-step path over the
        same plan; callers needing per-model callbacks use
        `local_client_train`. `pool_out` says how the pool comes back
        (`ScannedPhase.local_client`)."""
        fed = self.fed
        if not fed.use_pool:
            params, _ = self.train_scanned(m_in, plan, fed.e_local)
            return params, None, []
        return self.scanned.local_client(m_in, plan, pool_out)

    @property
    def scanned(self) -> "ScannedPhase":
        """The run's scanned phase (made at first use)."""
        if getattr(self, "_scanned", None) is None:
            self._scanned = ScannedPhase(self)
        return self._scanned

    # -- batched variants (B runs, leading run axis) -------------------------

    def batched_pool_create(self, m_in: Params) -> Any:
        """Each run's pool seeded with its run's model, stacked."""
        return torch.func.vmap(
            lambda m: self.backend.create(m, self.fed))(m_in)

    def train_batched(self, params: Params, data_iters: List[Any],
                      n_steps: int, *, pools: Any = None,
                      alphas: Optional[torch.Tensor] = None,
                      betas: Optional[torch.Tensor] = None,
                      step_fn: Optional[Callable] = None
                      ) -> Tuple[Params, torch.Tensor]:
        """`train` over stacked (B, …) params and B streams: each step
        stacks one batch a run and advances every run in one batched step
        (with `pools`, the regularized one at per-run α, β; `step_fn`, of
        the batched signature (params, opt_state, batch, step), overrides
        it). Returns (stacked params, (B,) last task losses)."""
        params = {k: v.detach().clone() for k, v in params.items()}
        opt_state = self.opt.init(params)
        device = next(iter(params.values())).device
        task = torch.zeros((len(data_iters),), device=device)
        steps = torch.arange(n_steps, dtype=torch.int32, device=device)
        for s in range(n_steps):
            batch = stack_trees([next(it) for it in data_iters])
            if step_fn is not None:
                params, opt_state, task = step_fn(params, opt_state, batch,
                                                  steps[s])
            elif pools is None:
                params, opt_state, task = self.batched_plain_step(
                    params, opt_state, batch, steps[s])
            else:
                params, opt_state, task = self.batched_pool_step(
                    params, opt_state, batch, pools, alphas, betas,
                    steps[s])
        return params, task

    def local_client_train_batched(self, m_in: Params, data_iters: List[Any],
                                   alphas: torch.Tensor, betas: torch.Tensor
                                   ) -> Tuple[Params, Any,
                                              List[List[ModelRecord]]]:
        """`local_client_train` over B runs in lockstep: B pools seeded
        from the stacked incoming models, S regularized models a run.
        Returns (stacked pool averages, stacked pools, per-run records)."""
        fed = self.fed
        b = len(data_iters)
        if not fed.use_pool:
            params, _ = self.train_batched(m_in, data_iters, fed.e_local)
            return params, None, [[] for _ in range(b)]
        pools = self.batched_pool_create(m_in)
        tasks = []
        for _ in range(fed.pool_size):
            m_j = batched_pool_average(pools)             # Eq. 6 init
            m_j, task = self.train_batched(m_j, data_iters, fed.e_local,
                                           pools=pools, alphas=alphas,
                                           betas=betas)
            pools = batched_pool_append(pools, m_j)
            tasks.append(task)
        return (batched_pool_average(pools), pools,
                _model_records(torch.stack(tasks), b))

    def train_scanned_batched(self, params: Params, plans: List[DataPlan],
                              n_steps: int) -> Tuple[Params, torch.Tensor]:
        """`train_scanned` over B runs: the plans' next n_steps rows each,
        the batches gathered on the device, one batched step a step; on
        CUDA captured once for the group (`BatchedScannedPhase`)."""
        return self.scanned_batched.train(params, plans, n_steps)

    def local_client_train_scanned_batched(self, m_in: Params,
                                           plans: List[DataPlan],
                                           alphas: torch.Tensor,
                                           betas: torch.Tensor
                                           ) -> Tuple[Params, Any,
                                                      List[List[ModelRecord]]]:
        """`local_client_train_scanned` over B runs (B × S × e_local
        steps), on CUDA one graph a step kind for the group."""
        fed = self.fed
        if not fed.use_pool:
            params, _ = self.train_scanned_batched(m_in, plans, fed.e_local)
            return params, None, [[] for _ in plans]
        return self.scanned_batched.local_client(m_in, plans, alphas, betas)

    @property
    def scanned_batched(self) -> "BatchedScannedPhase":
        """The group's batched scanned phase (made at first use)."""
        if getattr(self, "_scanned_batched", None) is None:
            self._scanned_batched = BatchedScannedPhase(self)
        return self._scanned_batched


# ---------------------------------------------------------------------------
# The scanned local phase: static buffers, one step body, CUDA graphs
# ---------------------------------------------------------------------------

def _copy_into(dst: Any, src: Any) -> None:
    """Copy every tensor of `src` into the matching tensor of `dst` (same
    structure: dicts, tuples, NamedTuples)."""
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


def _clone(tree: Any) -> Any:
    """A copy of a pytree of tensors (dicts, tuples, NamedTuples)."""
    return _map_tree(torch.clone, tree)


def _append_into(pool: Any, params: Params) -> None:
    """`pool.append(params)` written into `pool`: a stacked pool slot by
    slot, one leaf at a time (no second pool at once); the other forms
    through their `append` and a copy."""
    if not isinstance(pool, ModelPool):
        _copy_into(pool, pool.append(params))
        return
    _check_room(pool.count, pool.capacity)
    slot = pool.count.reshape(1).long()
    for k, s in pool.members.items():
        s.index_copy_(0, slot, params[k].detach().to(s.dtype).unsqueeze(0))
    pool.count.add_(1)


def _layout(tree: Any) -> Tuple:
    """Shapes and dtypes of a pytree's tensors: static buffers made for one
    layout serve every tree of it."""
    return tuple((tuple(t.shape), t.dtype) for t in _tensors(tree))


class ScannedPhase:
    """The scanned local phase of one `LocalTrainer` (one run).

    Static buffers — params `P`, optimizer state `O`, the pool `pool`,
    the step counter `step` (int32), the row pointer `ptr`, the visit's
    schedule rows `rows` and the client's arrays `arrays` — are made at
    first use and loaded at each visit (`_load`) and pool model. `_step`
    is the one step body: gather row `ptr`'s batch from `arrays`, take
    the (plain or pool) step at `P`, `O`, `step` with the update written
    into `P` and `O` in place, copy the task loss into `task`, advance
    `step` and `ptr`. A pool model's start and its append also write into
    the buffers (`_append_into`), so the phase holds one copy of the
    parameters, the optimizer state and the pool.

    On CUDA, a step kind's first step runs the body eagerly on the side
    stream `stream` (which makes every buffer a kernel wrapper keeps per
    stream), then the body is captured there into a CUDA graph; every
    later step of that kind in the run is a replay. The launches a
    capture makes count once per replay in the wrappers' counters
    (`build.capture_counts`). A new capture is made only when a visit
    needs more rows or larger arrays than the buffers hold (`captures`
    counts them, `replays` the replays; the class attributes
    `total_captures` / `total_replays` count over every instance, as the
    kernel wrappers count launches). The graphs of the step kinds share
    one memory pool: a step leaves nothing of its own alive, so one kind's
    replay may reuse what another's left free. A capture that fails
    raises; there is no per-step fallback. On the CPU the body runs in a
    plain loop."""

    total_captures = 0
    total_replays = 0

    def __init__(self, trainer: LocalTrainer):
        # the trainer's parts, not the trainer: no reference cycle keeps a
        # finished run's graphs and buffers for the garbage collector
        self.fed, self.opt, self.backend = (trainer.fed, trainer.opt,
                                            trainer.backend)
        self.plain_step, self.pool_step = (trainer.plain_step,
                                           trainer.pool_step)
        self.graphs: Dict[str, Any] = {}     # kind → (graph, counts)
        self.captures = 0
        self.replays = 0
        self.P = self.O = self.pool = None
        self.step = self.ptr = self.task = None
        self.rows = self.arrays = None
        self.stream = None
        self._client = None                  # the plan whose arrays are in
        self._n_max = 0

    # -- buffers -------------------------------------------------------------

    def reserve(self, plans: List[DataPlan]) -> None:
        """Size the arrays buffer for the largest of the run's `plans`, so
        that no visit outgrows it (and no step kind is captured twice)."""
        self._n_max = max([p.n for p in plans], default=0)

    def _buffers(self, params: Params, plan: DataPlan, n_rows: int) -> None:
        """Make (or grow) the static buffers for a visit of `plan` taking
        n_rows rows; growing drops the captured graphs."""
        fed = self.fed
        dev = next(iter(params.values())).device
        if self.P is None or _layout(self.P) != _layout(params):
            self.P = {k: torch.empty_like(v) for k, v in params.items()}
            self.O = self.opt.init(self.P)
            self.pool = None            # the pool's layout follows P's
            self.step = torch.zeros((), dtype=torch.int32, device=dev)
            self.ptr = torch.zeros((), dtype=torch.int64, device=dev)
            self.task = torch.zeros((), dtype=torch.float32, device=dev)
            self.graphs.clear()
        if self.rows is None or self.rows.shape[0] < n_rows or \
                self.rows.shape[1] != plan.batch_size:
            n_rows = max(n_rows, fed.pool_size * fed.e_local, fed.e_local,
                         fed.e_warmup)
            self.rows = torch.zeros((n_rows, plan.batch_size),
                                    dtype=torch.int32, device=dev)
            self.graphs.clear()
        fits = self.arrays is not None and \
            set(self.arrays) == set(plan.arrays) and all(
                a.shape[0] >= plan.n and a.shape[1:] == b.shape[1:] and
                a.dtype == b.dtype
                for a, b in ((self.arrays[k], plan.arrays[k])
                             for k in plan.arrays))
        if not fits:
            n = max(plan.n, self._n_max)
            self.arrays = {k: torch.zeros((n,) + tuple(a.shape[1:]),
                                          dtype=a.dtype, device=dev)
                           for k, a in plan.arrays.items()}
            self._client = None
            self.graphs.clear()

    def _load(self, params: Params, plan: DataPlan, rows: torch.Tensor
              ) -> None:
        """A visit's start: the client's arrays (when another client's are
        in), its rows and the pointer at row 0."""
        self._buffers(params, plan, rows.shape[0])
        if self._client is not plan:
            for k, a in plan.arrays.items():
                self.arrays[k][:plan.n].copy_(a)
            self._client = plan
        self.rows[:rows.shape[0]].copy_(rows)
        self.ptr.zero_()

    def _start_model(self, params: Params) -> None:
        """A model's start: params, a fresh optimizer state (zeros, as
        every optimizer's `init` makes it, written in place), step 0."""
        _copy_into(self.P, params)
        for t in _tensors(self.O):
            t.zero_()
        self.step.zero_()

    def _start_pool(self, m_in: Params) -> None:
        """A visit's start: `backend.create(m_in, fed)` in the pool buffer.
        A stacked pool is refilled in place (slot 0 the incoming model,
        the other slots zeros, count 1), so that no second pool exists at
        once; another form is created and copied in. Without a buffer (the
        first visit, or new parameter buffers) the created pool becomes
        it: a stacked pool's members are its own, the other forms keep
        `m_in` as their anchor or base and are copied."""
        if self.pool is None:
            first = self.backend.create(m_in, self.fed)
            self.pool = first if isinstance(first, ModelPool) \
                else _clone(first)
            self.graphs.pop("pool", None)
        elif isinstance(self.pool, ModelPool):
            for k, s in self.pool.members.items():
                s[0].copy_(m_in[k])
                s[1:].zero_()
            self.pool.count.fill_(1)
        else:
            _copy_into(self.pool, self.backend.create(m_in, self.fed))

    # -- the step ------------------------------------------------------------

    def _step(self, kind: str) -> None:
        row = self.rows.index_select(0, self.ptr.reshape(1))[0]
        batch = gather(self.arrays, row)
        if kind == "pool":
            _, _, task = self.pool_step(self.P, self.O, batch, self.pool,
                                        self.step, in_place=True)
        else:
            _, _, task = self.plain_step(self.P, self.O, batch, self.step,
                                         in_place=True)
        with torch.no_grad():
            self.task.copy_(task)
            self.step.add_(1)
            self.ptr.add_(1)

    def _advance(self, kind: str, n: int) -> None:
        """n steps of `kind` from the buffers' state."""
        if self.task.device.type != "cuda":
            for _ in range(n):
                self._step(kind)
            return
        if not n:
            return
        shared = next((g.pool() for g, _ in self.graphs.values()), None)
        self.graphs[kind], fresh, replays = build.graph_steps(
            self.graphs.get(kind), lambda: self._step(kind), n, pool=shared)
        if fresh:
            self.captures += 1
            ScannedPhase.total_captures += 1
        self.replays += replays
        ScannedPhase.total_replays += replays

    def _side_stream(self):
        """On CUDA, run the body on the side stream a capture needs
        (`build.side_stream`); on the CPU, run it as it is."""
        if self.task.device.type != "cuda":
            return contextlib.nullcontext()
        return build.side_stream(self)

    # -- the phases ----------------------------------------------------------

    def train(self, params: Params, plan: DataPlan, n_steps: int
              ) -> Tuple[Params, torch.Tensor]:
        """Plain steps over the plan's next n_steps rows; returns (params,
        last task loss), copies out of the buffers."""
        rows = plan.take(n_steps)
        self._buffers(params, plan, n_steps)
        with self._side_stream():
            self._load(params, plan, rows)
            self._start_model(params)
            self._advance("plain", n_steps)
        return (_clone(self.P),
                self.task.clone() if n_steps else torch.zeros(()))

    def local_client(self, m_in: Params, plan: DataPlan,
                     pool_out: Optional[str] = "copy"
                     ) -> Tuple[Params, Any, List[ModelRecord]]:
        """The pool procedure over the plan's next S·e_local rows; returns
        (pool average, pool, records), the average a copy out of the
        buffers. The pool comes back as `pool_out` says: "copy", a copy;
        None, not at all (a caller that keeps only a later visit's pool);
        "hand_over", the pool buffer itself, which the phase lets go of
        (and its pool graph with it: a later visit makes a new buffer and
        captures again), for a run's last visit, so that no second pool
        exists at once. The task losses come back in one sync."""
        fed = self.fed
        s_models, e = fed.pool_size, fed.e_local
        rows = plan.take(s_models * e)
        self._buffers(m_in, plan, s_models * e)
        tasks = torch.zeros((s_models,), dtype=torch.float32,
                            device=self.task.device)

        with self._side_stream():
            self._load(m_in, plan, rows)
            self._start_pool(m_in)
            for j in range(s_models):
                self._start_model(self.pool.average())   # Eq. 6 init
                self._advance("pool", e)
                tasks[j].copy_(self.task)
                _append_into(self.pool, self.P)
        records = [ModelRecord(index=j, task_loss=x)
                   for j, x in enumerate(tasks.tolist())]
        avg, pool = self.pool.average(), None
        if pool_out == "copy":
            pool = _clone(self.pool)
        elif pool_out == "hand_over":
            pool, self.pool = self.pool, None
            self.graphs.pop("pool", None)
        elif pool_out is not None:
            raise ValueError(f"pool_out {pool_out!r}: 'copy', "
                             "'hand_over' or None")
        return avg, pool, records


class BatchedScannedPhase(ScannedPhase):
    """The scanned local phase of a group of B runs on one trainer: the
    buffers of `ScannedPhase` with a leading run axis — params `P`,
    optimizer state `O` and pools stacked, the task losses (B,), per-run
    `alphas` and `betas`, the visit's rows (B, n, batch) and the B
    clients' arrays stacked and zero-padded to the longest shard the
    group visits (`reserve`; a schedule never indexes the padding) — and
    one CUDA graph a step kind for the whole group, captured and counted
    as `ScannedPhase` does. The step body gathers each run's batch from
    its own arrays and takes the batched step."""

    def __init__(self, trainer: LocalTrainer):
        super().__init__(trainer)
        self.plain_step = trainer.batched_plain_step
        self.pool_step = trainer.batched_pool_step
        self.create = trainer.batched_pool_create
        self.alphas = self.betas = None

    def _buffers(self, params: Params, plans: List[DataPlan],
                 n_rows: int) -> None:
        fed = self.fed
        b = len(plans)
        dev = next(iter(params.values())).device
        if self.P is None or _layout(self.P) != _layout(params):
            self.P = {k: torch.empty_like(v) for k, v in params.items()}
            self.O = self.opt.init(self.P)
            self.step = torch.zeros((), dtype=torch.int32, device=dev)
            self.ptr = torch.zeros((), dtype=torch.int64, device=dev)
            self.task = torch.zeros((b,), dtype=torch.float32, device=dev)
            self.alphas = torch.zeros((b,), dtype=torch.float32, device=dev)
            self.betas = torch.zeros((b,), dtype=torch.float32, device=dev)
            self.graphs.clear()
        bs = plans[0].batch_size
        if self.rows is None or self.rows.shape[1] < n_rows or \
                self.rows.shape[2] != bs:
            n_rows = max(n_rows, fed.pool_size * fed.e_local, fed.e_local,
                         fed.e_warmup)
            self.rows = torch.zeros((b, n_rows, bs), dtype=torch.int32,
                                    device=dev)
            self.graphs.clear()
        first = plans[0].arrays
        fits = self.arrays is not None and \
            list(self.arrays) == list(first) and all(
                self.arrays[k].shape[1] >= p.n and
                self.arrays[k].shape[2:] == p.arrays[k].shape[1:] and
                self.arrays[k].dtype == p.arrays[k].dtype
                for p in plans for k in first)
        if not fits:
            n = max([p.n for p in plans] + [self._n_max])
            self.arrays = {k: torch.zeros((b, n) + tuple(a.shape[1:]),
                                          dtype=a.dtype, device=dev)
                           for k, a in first.items()}
            self._client = None
            self.graphs.clear()

    def _load(self, params: Params, plans: List[DataPlan],
              rows: torch.Tensor) -> None:
        self._buffers(params, plans, rows.shape[1])
        # the plans themselves, not their ids: a trainer that outlives a
        # group (a fleet's rounds) would see a freed plan's id again
        if self._client is None or len(self._client) != len(plans) or \
                any(a is not b for a, b in zip(self._client, plans)):
            for i, p in enumerate(plans):
                if list(p.arrays) != list(self.arrays):
                    raise ValueError(
                        "batched scanned execution requires structurally "
                        "identical client shards across the run axis: the "
                        "plans' keys differ")
                for k, a in p.arrays.items():
                    self.arrays[k][i, :p.n].copy_(a)
            self._client = list(plans)
        self.rows[:, :rows.shape[1]].copy_(rows)
        self.ptr.zero_()

    def _step(self, kind: str) -> None:
        row = self.rows.index_select(1, self.ptr.reshape(1))[:, 0]
        batch = torch.func.vmap(gather)(self.arrays, row)
        if kind == "pool":
            p, o, task = self.pool_step(self.P, self.O, batch, self.pool,
                                        self.alphas, self.betas, self.step)
        else:
            p, o, task = self.plain_step(self.P, self.O, batch, self.step)
        with torch.no_grad():
            _copy_into(self.P, p)
            _copy_into(self.O, o)
            self.task.copy_(task)
            self.step.add_(1)
            self.ptr.add_(1)

    # -- the phases ----------------------------------------------------------

    def train(self, params: Params, plans: List[DataPlan], n_steps: int
              ) -> Tuple[Params, torch.Tensor]:
        """Plain batched steps over each plan's next n_steps rows; returns
        (stacked params, (B,) last task losses), copies of the buffers."""
        rows = stack_plan_indices(plans, n_steps)
        self._buffers(params, plans, n_steps)
        with self._side_stream():
            self._load(params, plans, rows)
            self._start_model(params)
            self._advance("plain", n_steps)
        return _clone(self.P), self.task.clone()

    def local_client(self, m_in: Params, plans: List[DataPlan],
                     alphas: torch.Tensor, betas: torch.Tensor
                     ) -> Tuple[Params, Any, List[List[ModelRecord]]]:
        """The pool procedure of B runs over each plan's next S·e_local
        rows; returns (stacked pool averages, stacked pools, per-run
        records), copies of the buffers; the losses come back in one
        sync."""
        fed = self.fed
        s_models, e = fed.pool_size, fed.e_local
        rows = stack_plan_indices(plans, s_models * e)
        self._buffers(m_in, plans, s_models * e)
        tasks = torch.zeros((s_models, len(plans)), dtype=torch.float32,
                            device=self.task.device)
        with self._side_stream():
            self._load(m_in, plans, rows)
            self.alphas.copy_(alphas)
            self.betas.copy_(betas)
            first = self.create(m_in)
            if self.pool is None or _layout(self.pool) != _layout(first):
                self.pool = _clone(first)
                self.graphs.pop("pool", None)
            else:
                _copy_into(self.pool, first)
            for j in range(s_models):
                self._start_model(batched_pool_average(self.pool))
                self._advance("pool", e)
                tasks[j].copy_(self.task)
                _copy_into(self.pool,
                           batched_pool_append(self.pool, self.P))
        return (batched_pool_average(self.pool), _clone(self.pool),
                _model_records(tasks, len(plans)))
