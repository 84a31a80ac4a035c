"""Sharpness-Aware Minimization — the DFedSAM baseline's step (port of
``repro/optim/sam.py``).

`sam_update` wraps any base Optimizer: it perturbs the parameters to the
loss-ascent point (ρ·g/‖g‖), takes the gradient there, and applies the
base update to the original parameters with that gradient.
`sam_update_batched` is the same step for B runs stacked along a leading
run axis: each run's loss under `torch.func.vmap`, each run's own norm
‖g‖, the base update on the stacked leaves."""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.optim.optimizers import Optimizer

Params = Dict[str, torch.Tensor]


def _grad(loss_fn: Callable, params: Params, batch) -> Params:
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(loss_fn(leaves, batch),
                                list(leaves.values()))
    return dict(zip(leaves, grads))


def _global_norm(tree: Params) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x² + 1e-12), summed leaf by leaf in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()) + 1e-12)


def sam_update(loss_fn: Callable, params: Params, batch, opt: Optimizer,
               opt_state, step: int, rho: float = 0.05):
    """One SAM step; returns the base optimizer's (params, opt_state)."""
    grads = _grad(loss_fn, params, batch)
    gn = _global_norm(grads)
    with torch.no_grad():
        p_adv = {k: p + (rho * grads[k].float() / gn).to(p.dtype)
                 for k, p in params.items()}
    g_adv = _grad(loss_fn, p_adv, batch)
    return opt.update(params, g_adv, opt_state, step)


def _batched_grad(loss_fn: Callable, params: Params, batch) -> Params:
    """Each run's gradient of its loss, stacked: the loss under
    `torch.func.vmap`, autograd of the runs' sum on the stacked leaves."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    losses = torch.func.vmap(loss_fn)(leaves, batch)
    grads = torch.autograd.grad(losses.sum(), list(leaves.values()))
    return dict(zip(leaves, grads))


def sam_update_batched(loss_fn: Callable, params: Params, batch,
                       opt: Optimizer, opt_state, step, rho: float = 0.05):
    """`sam_update` for B runs with a leading run axis on `params`,
    `batch` and `opt_state`; returns the base optimizer's (params,
    opt_state)."""
    grads = _batched_grad(loss_fn, params, batch)
    gn = torch.func.vmap(_global_norm)(grads)
    with torch.no_grad():
        p_adv = {k: p + (rho * grads[k].float() /
                         gn.reshape((-1,) + (1,) * (p.dim() - 1))).to(p.dtype)
                 for k, p in params.items()}
    g_adv = _batched_grad(loss_fn, p_adv, batch)
    return opt.update(params, g_adv, opt_state, step)
