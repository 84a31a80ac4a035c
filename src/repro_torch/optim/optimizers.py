"""Optimizers over name → tensor dicts (port of
``repro/optim/optimizers.py``).

Each optimizer is an ``Optimizer(name, init, update, update_into)``:
    state = init(params)
    new_params, new_state = update(params, grads, state, step)
    apply_in_place(opt, params, grads, state, step)   # the same, in place
`update` is functional, as in the reference: it returns new tensors and
leaves its inputs unchanged. In place, the same bits are written into
`params` and `state`: by Adam's own `update_into`, leaf by leaf, so that
no second copy of the parameters and moments exists at once; by the
others' `update` and a copy. The captured local phase, whose parameters
and state are static buffers, updates in place. All arithmetic is f32.
Adam is the reference's rule — coupled (L2) weight decay, bias
correction from the runtime `step` — and deliberately not
`torch.optim.Adam`; `sgd` and `momentum` round bitwise like the
reference's updates.

`step` is an int or an int32 tensor on the parameters' device. Adam forms
its bias correction on the device from it (`_bias_corrections`), so a
step captured in a CUDA graph reads the step of each replay, and the
per-step loop, which passes the same kind of tensor, computes the same
bits."""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.kernels.local_step import sgd_update_tree

Params = Dict[str, torch.Tensor]
F32 = torch.float32


class Optimizer(NamedTuple):
    name: str
    init: Callable[[Params], dict]
    update: Callable[[Params, Params, dict, int], tuple]
    update_into: Optional[Callable[[Params, Params, dict, int], None]] = None


def _leaves(tree: Any):
    """The tensors of a dict / tuple tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [t for v in tree for t in _leaves(v)]


@torch.no_grad()
def apply_in_place(opt: Optimizer, params: Params, grads: Params, state,
                   step) -> None:
    """`opt.update` written into `params` and `state`: the optimizer's
    own `update_into` where it has one, else `update` and a copy."""
    if opt.update_into is not None:
        opt.update_into(params, grads, state, step)
        return
    new_p, new_state = opt.update(params, grads, state, step)
    for dst, src in zip(_leaves((params, state)),
                        _leaves((new_p, new_state))):
        dst.copy_(src)


def sgd(lr: float, weight_decay: float = 0.0) -> Optimizer:
    """Plain SGD through the fused sweep `kernels.local_step.sgd_update_tree`
    (one kernel launch for all leaves on the card, the plain version on
    the CPU)."""
    def init(params):
        return ()

    @torch.no_grad()
    def update(params, grads, state, step):
        return sgd_update_tree(params, grads, lr=lr, wd=weight_decay), state

    return Optimizer("sgd", init, update)


def momentum(lr: float, beta: float = 0.9,
             weight_decay: float = 0.0) -> Optimizer:
    """Heavy-ball momentum (DFedAvgM's local optimizer). Each line is one
    `torch.add(…, alpha=)`, which rounds like the reference's contracted
    update: g + wd·p, then g + β·m, then p − lr·m."""
    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                      for k, p in params.items()}}

    @torch.no_grad()
    def update(params, grads, state, step):
        new_p, new_m = {}, {}
        for k, p in params.items():
            p32 = p.to(F32)
            g = torch.add(grads[k].to(F32), p32, alpha=weight_decay)
            m = torch.add(g, state["m"][k], alpha=beta)
            new_p[k] = torch.add(p32, m, alpha=-lr).to(p.dtype)
            new_m[k] = m
        return new_p, {"m": new_m}

    return Optimizer("momentum", init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0, name: str = "adam") -> Optimizer:
    """Adam with L2 (coupled) weight decay — the paper's setup (Adam,
    weight decay 1e-4); ``name="adamw"`` decouples the decay instead."""
    def init(params):
        return {"m": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                      for k, p in params.items()},
                "v": {k: torch.zeros(p.shape, dtype=F32, device=p.device)
                      for k, p in params.items()}}

    def leaf(p, g, m, v, c1, c2):
        g = g.to(F32)
        if name == "adam" and weight_decay:
            g = g + weight_decay * p.to(F32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        pn = p.to(F32) - lr * u
        if name == "adamw" and weight_decay:
            pn = pn - lr * weight_decay * p.to(F32)
        return pn.to(p.dtype), m, v

    @torch.no_grad()
    def update(params, grads, state, step):
        c1, c2 = _bias_corrections(step, b1, b2,
                                   next(iter(params.values())).device)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            new_p[k], new_m[k], new_v[k] = leaf(
                p, grads[k], state["m"][k], state["v"][k], c1, c2)
        return new_p, {"m": new_m, "v": new_v}

    @torch.no_grad()
    def update_into(params, grads, state, step):
        c1, c2 = _bias_corrections(step, b1, b2,
                                   next(iter(params.values())).device)
        for k, p in params.items():
            pn, m, v = leaf(p, grads[k], state["m"][k], state["v"][k], c1,
                            c2)
            p.copy_(pn)
            state["m"][k].copy_(m)
            state["v"][k].copy_(v)

    return Optimizer(name, init, update, update_into)


def _bias_corrections(step, b1: float, b2: float, device):
    """Adam's 1 − b1**t and 1 − b2**t, t = step + 1, as f32 tensors on
    `device`, from an int32 step tensor there (an int step is first made
    one, by a fill on the device, not a copy from the host)."""
    if not isinstance(step, torch.Tensor):
        step = torch.full((), step, dtype=torch.int32, device=device)
    t = step.to(F32) + 1.0
    return 1.0 - torch.pow(b1, t), 1.0 - torch.pow(b2, t)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay, name="adamw")


def make_optimizer(name: str, lr: float, weight_decay: float = 0.0,
                   **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adam": adam,
            "adamw": adamw}[name](lr, weight_decay=weight_decay, **kw)
