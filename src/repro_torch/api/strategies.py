"""The strategy registry (port of ``repro/api/strategies.py``): every
federated algorithm as a registered `StrategyPlan` (see
`repro_torch.api.plan`), executed by the plan interpreter;
``register_strategy`` still takes opaque callables for methods the IR
cannot express.

Registered here, copied field for field from the reference:

* ``fedelmy``          — paper Alg. 1: chain topology, pool block
* ``fedelmy_fewshot``  — paper Alg. 2: ring × ``Experiment.shots``
* ``fedelmy_pfl``      — paper Alg. 3: independent, per-client inits,
                          pool block, tree-mean aggregate
* ``fedseq``           — chain, plain block (SOTA baseline)
* ``dfedavgm``         — independent, shared init, momentum local opt
* ``dfedsam``          — dfedavgm with a custom SAM step block (SGD)
* ``metafed``          — chain × two phases; phase 2 anchored on the
                          phase-1 result (common-knowledge model)
* ``local_only``       — independent over one selected client

Plain and pool blocks train over the model's fused loss (the GEMM kernel
on the card). The SAM step and MetaFed's anchored step are built over the
model's native ``loss_fn`` (`F.conv2d` for the paper CNN), as the
reference builds them over its ``lax.conv`` forward; each has a batched
form over a leading run axis (`_sam_step_batched`,
`_metafed_anchor_step_batched`) for `plan.interpret_batched`. Each runs
whole, forward and `torch.autograd.grad`, under `cnn.native_conv_flags`
(`_repeatable`), so that cuDNN's backward algorithms are deterministic
too and a run repeats bit for bit on the card; on the CPU the flags
change nothing."""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

from repro_torch.api.plan import LocalBlock, StrategyPlan, Topology, interpret
from repro_torch.api.registry import Registry
from repro_torch.api.trainer import batched_grad_step, make_plain_step
from repro_torch.core.distances import d2_anchor_distance, log_scale
from repro_torch.models.cnn import native_conv_flags
from repro_torch.optim.sam import sam_update, sam_update_batched

STRATEGIES = Registry("strategy")


class StrategySpec(NamedTuple):
    """A registered strategy: the callable the engine invokes, the
    optional Experiment fields it honors ("init_params", "order",
    "shots"; the engine warns when a set field is not in `supports`), and
    — for plan strategies — the `StrategyPlan` itself (None for opaque
    callables)."""
    fn: Callable
    supports: frozenset
    plan: Optional[StrategyPlan] = None


def register_strategy(name: str, *, supports: tuple = ()) -> Callable:
    """Decorator: ``@register_strategy("mymethod", supports=("order",))``
    over an ``(Experiment) -> StrategyOutput`` callable, for methods the
    plan IR cannot express."""
    def deco(fn: Callable) -> Callable:
        STRATEGIES.register(name, StrategySpec(fn, frozenset(supports)))
        return fn
    return deco


def register_plan(name: str, plan: StrategyPlan) -> StrategyPlan:
    """Register a declarative strategy, executed through `interpret`."""
    STRATEGIES.register(name, StrategySpec(
        functools.partial(interpret, plan=plan), frozenset(plan.supports),
        plan))
    return plan


def get_strategy_spec(name: str) -> StrategySpec:
    return STRATEGIES.get(name)


def get_plan(name: str) -> Optional[StrategyPlan]:
    return STRATEGIES.get(name).plan


def list_strategies() -> List[str]:
    return STRATEGIES.names()


def describe_strategies() -> Dict[str, Dict[str, str]]:
    """name → plan metadata (topology / local block / aggregate /
    broadcast / batched / supports) for every registered strategy; opaque
    callables report a sequential-only row."""
    out: Dict[str, Dict[str, str]] = {}
    for name, spec in STRATEGIES.items():
        if spec.plan is None:
            out[name] = {"topology": "(opaque callable)",
                         "local_block": "—", "aggregate": "—",
                         "broadcast": "—", "batched": "no",
                         "supports": ",".join(sorted(spec.supports)) or "—"}
        else:
            out[name] = {**spec.plan.describe(), "batched": "yes"}
    return out


# ---------------------------------------------------------------------------
# Custom step factories (DFedSAM's SAM step, MetaFed's anchored penalty)
# ---------------------------------------------------------------------------

def _repeatable(factory):
    """A step factory whose steps run whole under `native_conv_flags`:
    the forward and the `torch.autograd.grad` that differentiates it."""
    @functools.wraps(factory)
    def make(*args):
        step = factory(*args)

        def step_fn(*step_args):
            with native_conv_flags():
                return step(*step_args)
        return step_fn
    return make


@_repeatable
def _sam_step(trainer, exp, anchor):
    rho = exp.strategy_options.get("rho", 0.05)
    loss_fn = exp.model.loss_fn

    def sam_step(params, opt_state, batch, s):
        params, opt_state = sam_update(loss_fn, params, batch, trainer.opt,
                                       opt_state, s, rho=rho)
        return params, opt_state, torch.zeros(())

    return sam_step


@_repeatable
def _sam_step_batched(trainer, exps, anchors):
    rho = exps[0].strategy_options.get("rho", 0.05)
    loss_fn = exps[0].model.loss_fn

    def sam_step(params, opt_state, batch, s):
        params, opt_state = sam_update_batched(loss_fn, params, batch,
                                               trainer.opt, opt_state, s,
                                               rho=rho)
        return params, opt_state, torch.zeros(())

    return sam_step


def _anchored_loss(loss_fn, anchor_beta):
    """MetaFed pass 2: task loss + β·(distance to the common model),
    log-calibrated like the paper's d2 term."""
    def loss(params, batch, anchor):
        task = loss_fn(params, batch)
        d = d2_anchor_distance(params, anchor, "l2")
        return task + anchor_beta * log_scale(d, task)
    return loss


@_repeatable
def _metafed_anchor_step(trainer, exp, anchor):
    anchored = _anchored_loss(exp.model.loss_fn,
                              exp.strategy_options.get("anchor_beta", 0.5))
    return make_plain_step(lambda p, b: anchored(p, b, anchor), trainer.opt)


@_repeatable
def _metafed_anchor_step_batched(trainer, exps, anchors):
    # `anchors`: the stacked phase-1 results, each run's its own anchor
    anchored = _anchored_loss(
        exps[0].model.loss_fn,
        exps[0].strategy_options.get("anchor_beta", 0.5))

    def objective(p, batch, anchor):
        task = anchored(p, batch, anchor)
        return task, task

    def step_fn(params, opt_state, batch, s):
        return batched_grad_step(objective, trainer.opt, params, opt_state,
                                 s, batch, anchors)

    return step_fn


# ---------------------------------------------------------------------------
# The eight registered plans (paper Algorithms 1–3 + §4.1 baselines)
# ---------------------------------------------------------------------------

register_plan("fedelmy", StrategyPlan(
    topology=Topology("chain", honors_order=True),
    phases=(LocalBlock("pool"),),
    aggregate="last", broadcast="handoff",
    init_from_experiment=True, warmup="first",
    records="clients", keep_final_pool=True,
    supports=("init_params", "order")))

register_plan("fedelmy_fewshot", StrategyPlan(
    topology=Topology("ring", cycles="shots"),
    phases=(LocalBlock("pool"),),
    aggregate="last", broadcast="handoff",
    init_from_experiment=True, warmup="first", init_skips_warmup=True,
    records="rounds", keep_final_pool=True,
    supports=("shots", "init_params")))

register_plan("fedelmy_pfl", StrategyPlan(
    topology=Topology("independent"),
    phases=(LocalBlock("pool"),),
    aggregate="tree_mean", broadcast="per_client_init",
    warmup="per_client", records="clients_noeval",
    keep_final_pool=True))

register_plan("fedseq", StrategyPlan(
    topology=Topology("chain", honors_order=True),
    phases=(LocalBlock("plain"),),
    aggregate="last", broadcast="handoff",
    init_from_experiment=True, records="clients",
    supports=("init_params", "order")))

register_plan("dfedavgm", StrategyPlan(
    topology=Topology("independent"),
    phases=(LocalBlock("plain"),),
    aggregate="tree_mean", broadcast="shared_init",
    init_from_experiment=True, supports=("init_params",),
    trainer_overrides=lambda fed: {"optimizer": "momentum",
                                   "learning_rate": fed.learning_rate * 10}))

register_plan("dfedsam", StrategyPlan(
    topology=Topology("independent"),
    phases=(LocalBlock("custom", step_factory=_sam_step,
                       batched_step_factory=_sam_step_batched,
                       label="sam"),),
    aggregate="tree_mean", broadcast="shared_init",
    init_from_experiment=True, supports=("init_params",),
    trainer_overrides=lambda fed: {"optimizer": "sgd",
                                   "learning_rate": fed.learning_rate * 10}))

register_plan("metafed", StrategyPlan(
    topology=Topology("chain"),
    phases=(LocalBlock("plain", epochs_div=2),
            LocalBlock("custom", epochs_div=2, anchored=True,
                       step_factory=_metafed_anchor_step,
                       batched_step_factory=_metafed_anchor_step_batched,
                       label="anchored")),
    aggregate="last", broadcast="handoff"))

register_plan("local_only", StrategyPlan(
    topology=Topology("independent"),
    phases=(LocalBlock("plain"),),
    aggregate="last", broadcast="shared_init",
    client_selector=lambda exp: [exp.strategy_options.get("client", 0)]))
