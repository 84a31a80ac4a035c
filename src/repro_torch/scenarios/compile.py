"""The scenario compiler: `ScenarioSpec` → materialized client data →
Experiments, and the fleet path (port of ``repro/scenarios/compile.py``).

    spec = get_scenario("pathological_shards")
    exps = build_experiments(spec, model, strategies=("fedelmy", "fedseq"),
                             seeds=(0, 1), fed=fed)

`materialize(spec, seed)` draws the synthetic dataset, runs the
registered partitioner, applies the population knobs (participation,
dropout, stragglers) and resolves the eval-split policy, in numpy,
bitwise as the reference does. `ScenarioData.streams()` mints fresh
stateful per-client streams per call: the client shards go to the device
once per materialization and are shared by every `DataPlan`, while each
plan's shuffle cursor is its own. `scan=` routes the captured local phase
or the per-step loop over the device arrays, `device=False` the host
`batch_iterator` streams; all three give bitwise the same batches.

`_run_scenario` (behind `repro_torch.api.launch`) runs the experiments
through the batched engine (`api.batch._run_batch`), as the reference
does: each strategy's seeds one group, one batched program.

Fleet-scale federations go through the same machinery per *cohort*: a
`FleetSpec`'s participation trace draws a cohort of clients each round,
`materialize_cohort` builds their shards (pure functions of client id —
the fleet itself never materializes), and `run_fleet` runs each cohort as
one batched group (`plan.interpret_batched`'s flattened run × client
axis) on one trainer for the whole sweep, so a captured step kind is
captured once and replayed every round; a round file after every round
makes the sweep preemptible.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.api.batch import _run_batch
from repro_torch.api.engine import Experiment
from repro_torch.api.plan import _make_trainer, interpret_batched
from repro_torch.api.results import BatchResult, CohortRecord, FleetResult
from repro_torch.api.strategies import get_strategy_spec
from repro_torch.checkpoint import latest_fleet_round, save_fleet_round
from repro_torch.configs.base import FedConfig
from repro_torch.data.partition import train_val_split
from repro_torch.data.pipeline import batch_iterator, image_batch
from repro_torch.data.plan import DataPlan
from repro_torch.data.synthetic import (SyntheticImageDataset,
                                        make_domain_datasets,
                                        make_fleet_client_dataset,
                                        make_image_dataset)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.scenarios.registry import get_partitioner
from repro_torch.scenarios.spec import FleetSpec, ScenarioSpec

Arrays = Dict[str, np.ndarray]


class _ClientStreams:
    """The stream-minting surface shared by `ScenarioData` and
    `CohortData`: one documented contract (`streams`), one device-upload
    cache, one tiling rule. Subclasses provide `client_data`, `seed` and
    `_batch_size`."""

    client_data: List[Arrays]
    seed: int

    @property
    def _batch_size(self) -> int:
        raise NotImplementedError

    def _tiled_client(self, i: int) -> Arrays:
        """Client `i`'s arrays, deterministically tiled up to one full
        batch when smaller than `batch_size` (quantity skew, stragglers):
        the batch shape is a pure function of the spec."""
        c = self.client_data[i]
        n = len(c["labels"])
        bs = self._batch_size
        if n < bs:
            idx = np.tile(np.arange(n), -(-bs // n))[:bs]
            c = {k: v[idx] for k, v in c.items()}
        return c

    def _device_clients(self, device: torch.device
                        ) -> List[Dict[str, torch.Tensor]]:
        """Per-client arrays on `device`, uploaded once per
        materialization and device, shared by every DataPlan minted from
        it."""
        cache = self.__dict__.setdefault("_device_cache", {})
        if device not in cache:
            cache[device] = [
                {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                 for k, v in self._tiled_client(i).items()}
                for i in range(len(self.client_data))]
        return cache[device]

    def streams(self, base_seed: Optional[int] = None, *,
                scan: bool = True, device: bool = True,
                to: DeviceLike = None) -> List[Any]:
        """Fresh per-client streams — THE stream contract. Call once per
        experiment: every stream's cursor is stateful; the device arrays
        underneath are shared (uploaded once).

        device=True (default) mints device-resident `DataPlan`s on `to`
        (the CUDA device unless named): `scan=True` routes the captured
        local phase, `scan=False` keeps per-step dispatch over the device
        arrays (an oracle/debug knob). device=False returns host-streaming
        `batch_iterator`s yielding on `to` — the per-step oracle. All
        three give bitwise the same batch sequences."""
        base = self.seed if base_seed is None else base_seed
        dev = resolve_device(to)
        if device:
            return [DataPlan(arr, self._batch_size, seed=base * 100 + i,
                             scan=scan, device=dev)
                    for i, arr in enumerate(self._device_clients(dev))]
        return [batch_iterator(self._tiled_client(i), self._batch_size,
                               seed=base * 100 + i, device=dev)
                for i in range(len(self.client_data))]


@dataclasses.dataclass
class ScenarioData(_ClientStreams):
    """One seed's materialization of a spec: per-active-client arrays plus
    the evaluation set."""
    spec: ScenarioSpec
    seed: int
    client_ids: List[int]            # original client indices (post
                                     # participation/dropout selection)
    client_data: List[Arrays]        # {"images", "labels"} per client
    client_val: List[Optional[Arrays]]   # val_frac carves (None if 0)
    eval_data: Arrays
    n_classes: int

    @property
    def _batch_size(self) -> int:
        return self.spec.batch_size

    def eval_dataset(self) -> SyntheticImageDataset:
        return SyntheticImageDataset(self.eval_data["images"],
                                     self.eval_data["labels"],
                                     self.n_classes)

    def sizes(self) -> List[int]:
        return [len(c["labels"]) for c in self.client_data]


@dataclasses.dataclass
class CohortData(_ClientStreams):
    """One fleet round's materialized cohort: the participation trace's
    client ids and their shards — pure functions of (FleetSpec, round),
    so a resumed sweep redraws the same bytes."""
    fleet: FleetSpec
    round: int
    seed: int                        # stream base seed (folded per round)
    client_ids: List[int]            # registered fleet ids, |cohort_size|
    client_data: List[Arrays]

    @property
    def _batch_size(self) -> int:
        return self.fleet.batch_size


def _index_family_clients(spec: ScenarioSpec, seed: int, fn: Callable):
    """Index partitioners run over one flat dataset; "holdout" eval carves
    the test split before partitioning."""
    ds = make_image_dataset(spec.n_samples, spec.n_classes, spec.side,
                            spec.noise, seed=seed)
    if spec.eval_split == "holdout":
        train_idx, hold_idx = train_val_split(len(ds.labels),
                                              spec.holdout_frac,
                                              seed=seed + 13)
        eval_arr = image_batch(ds, np.sort(hold_idx))
        train_idx = np.sort(train_idx)
        images, labels = ds.images[train_idx], ds.labels[train_idx]
    else:
        test = make_image_dataset(spec.n_test, spec.n_classes, spec.side,
                                  spec.noise, seed=seed + 91)
        eval_arr = image_batch(test)
        images, labels = ds.images, ds.labels
    parts = fn(labels, spec.n_clients, seed=seed, **spec.partitioner_params)
    clients = [{"images": images[p], "labels": labels[p]} for p in parts]
    return clients, eval_arr


def _dataset_family_clients(spec: ScenarioSpec, seed: int, fn: Callable):
    """Dataset partitioners (domain_shift / feature_shift) build their own
    per-client datasets; the global eval set spans every domain/severity
    rung, so the metric measures cross-shift transfer."""
    if spec.eval_split != "global":
        raise ValueError(
            f"scenario {spec.name!r}: eval_split='holdout' requires an "
            f"index partitioner; {spec.family} produces per-client "
            "datasets — use eval_split='global'")
    if spec.family == "domain_shift":
        doms = make_domain_datasets(spec.n_samples // 4, spec.n_classes,
                                    spec.side, spec.noise, seed=seed)
        clients = fn(doms, spec.n_clients, seed=seed,
                     **spec.partitioner_params)
        test = make_domain_datasets(max(1, spec.n_test // 4), spec.n_classes,
                                    spec.side, spec.noise, seed=seed + 91)
        eval_sets = list(test.values())
    else:                            # feature_shift ladder
        base = make_image_dataset(spec.n_samples, spec.n_classes, spec.side,
                                  spec.noise, seed=seed)
        clients = fn(base, spec.n_clients, seed=seed,
                     **spec.partitioner_params)
        test_base = make_image_dataset(spec.n_test, spec.n_classes,
                                       spec.side, spec.noise, seed=seed + 91)
        eval_sets = fn(test_base, spec.n_clients, seed=seed + 91,
                       **spec.partitioner_params)
    eval_arr = {"images": np.concatenate([d.images for d in eval_sets]),
                "labels": np.concatenate([d.labels for d in eval_sets])}
    return [image_batch(c) for c in clients], eval_arr


def materialize(spec: ScenarioSpec, seed: int = 0) -> ScenarioData:
    """Draw the scenario's dataset, partition it, and apply the population
    knobs. Deterministic in (spec, seed) — for `domain_shift`, within a
    process (its partitioner draws in the order of a set of domain
    names)."""
    pspec = get_partitioner(spec.partitioner)
    if pspec.kind == "indices":
        clients, eval_arr = _index_family_clients(spec, seed, pspec.fn)
    else:
        clients, eval_arr = _dataset_family_clients(spec, seed, pspec.fn)

    active = spec.active_clients(seed)
    client_data, client_val = [], []
    for c in active:
        arr = clients[c]
        if c in set(spec.stragglers) and spec.straggler_keep < 1.0:
            n = len(arr["labels"])
            keep = max(1, int(round(spec.straggler_keep * n)))
            idx = np.sort(np.random.default_rng(seed + 17 + c).choice(
                n, size=keep, replace=False))
            arr = {k: v[idx] for k, v in arr.items()}
        if spec.val_frac > 0.0:
            tr, va = train_val_split(len(arr["labels"]), spec.val_frac,
                                     seed=seed * 1000 + c)
            client_val.append({k: v[va] for k, v in arr.items()})
            arr = {k: v[tr] for k, v in arr.items()}
        else:
            client_val.append(None)
        client_data.append(arr)
    return ScenarioData(spec=spec, seed=seed, client_ids=active,
                        client_data=client_data, client_val=client_val,
                        eval_data=eval_arr, n_classes=spec.n_classes)


def accuracy_eval(model, data: ScenarioData) -> Callable:
    """Default eval_fn: full-batch argmax accuracy over the scenario's
    eval split, on the model's device (the split uploaded once); returns
    a device scalar (the engine's `float` is the sync)."""
    images = torch.from_numpy(data.eval_data["images"]).to(model.device)
    labels = torch.from_numpy(data.eval_data["labels"]).to(model.device)

    def acc(params):
        with torch.no_grad():
            logits = model.forward(params, {"images": images})
        return (logits.argmax(-1) == labels).float().mean()
    return acc


def build_experiments(spec: ScenarioSpec, model, *,
                      fed: FedConfig,
                      strategies: Sequence[str] = ("fedelmy",),
                      seeds: Sequence[int] = (0,),
                      shots: int = 1,
                      eval_builder: Optional[Callable] = None,
                      strategy_options: Optional[Dict[str, Dict]] = None,
                      scan: bool = True,
                      ) -> List[Experiment]:
    """Compile a scenario sweep into Experiments: one per (strategy, seed)
    in that order, sharing one materialization per seed but minting fresh
    streams (DataPlans on the model's device) per experiment; seed s is
    the Experiment's seed (`model.init(s)`). `fed.n_clients` becomes the
    spec's active count. `scan=False` keeps the per-step loop over the
    device-resident shards (an oracle/debug knob)."""
    fed = dataclasses.replace(fed, n_clients=spec.n_active)
    build_eval = eval_builder if eval_builder is not None else accuracy_eval
    datas = {seed: materialize(spec, seed) for seed in seeds}
    evals = {seed: build_eval(model, datas[seed]) for seed in seeds}
    opts = strategy_options or {}
    return [Experiment(model=model,
                       client_iters=datas[seed].streams(scan=scan,
                                                        to=model.device),
                       fed=fed, strategy=strategy, seed=seed,
                       eval_fn=evals[seed], shots=shots,
                       strategy_options=dict(opts.get(strategy, {})))
            for strategy in strategies for seed in seeds]


def _run_scenario(spec: ScenarioSpec, model, *, fed: FedConfig,
                  strategies: Sequence[str] = ("fedelmy",),
                  seeds: Sequence[int] = (0,), mesh=None,
                  **kw) -> BatchResult:
    """Compile a scenario sweep and run it through the batched engine
    (the implementation behind `repro_torch.api.launch`)."""
    exps = build_experiments(spec, model, fed=fed, strategies=strategies,
                             seeds=seeds, **kw)
    return _run_batch(experiments=exps, mesh=mesh)


# ---------------------------------------------------------------------------
# Fleet-scale execution: streaming cohorts
# ---------------------------------------------------------------------------

def materialize_cohort(fleet: FleetSpec, r: int) -> CohortData:
    """Round r's cohort: the participation trace's ids and each
    participant's shard. Pure in (fleet, r) — the fleet never
    materializes; memory is O(cohort_size)."""
    ids = fleet.cohort(r)
    client_data = [image_batch(make_fleet_client_dataset(
        int(c), n_samples=fleet.samples_per_client,
        n_classes=fleet.n_classes, side=fleet.side, noise=fleet.noise,
        label_beta=fleet.label_beta, seed=fleet.seed)) for c in ids]
    return CohortData(fleet=fleet, round=r,
                      seed=fleet.seed * 100003 + r * 131 + 7,
                      client_ids=[int(c) for c in ids],
                      client_data=client_data)


def fleet_eval(model, fleet: FleetSpec) -> Callable:
    """Global accuracy over a held-out draw from the fleet's generative
    process (balanced labels), on the model's device (uploaded once);
    returns a device scalar."""
    test = make_image_dataset(fleet.n_test, fleet.n_classes, fleet.side,
                              fleet.noise, seed=fleet.seed + 91)
    images = torch.from_numpy(test.images).to(model.device)
    labels = torch.from_numpy(test.labels).to(model.device)

    def acc(params):
        with torch.no_grad():
            logits = model.forward(params, {"images": images})
        return (logits.argmax(-1) == labels).float().mean()
    return acc


def _fleet_plan(fleet: FleetSpec):
    """The fleet strategy's plan, checked for cohort rounds: round r's
    aggregate is round r+1's shared init, so the plan must be
    independent-topology, shared_init, and honor Experiment.init_params."""
    plan = get_strategy_spec(fleet.strategy).plan
    if plan is None or plan.topology.kind != "independent" \
            or plan.broadcast != "shared_init" \
            or not plan.init_from_experiment:
        raise ValueError(
            f"fleet strategy {fleet.strategy!r} must be a registered plan "
            "with independent topology, shared_init broadcast, and "
            "init_from_experiment=True (dfedavgm / dfedsam qualify): "
            "cohort rounds thread the global aggregate through "
            "Experiment.init_params")
    return plan


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_fleet(fleet: FleetSpec, model, *, fed: FedConfig, mesh=None,
              checkpoint_dir: Optional[str] = None,
              eval_every: int = 0, scan: bool = True,
              rounds: Optional[int] = None) -> FleetResult:
    """Run a fleet sweep: each round draws the cohort, materializes its
    shards and runs the whole cohort as one batched group
    (`interpret_batched`'s flattened run × client axis); the round's
    aggregate is the next round's `Experiment.init_params`. Round r's
    Experiment seed is ``fleet.seed·100003 + r``, the round-0 init
    ``model.init(fleet.seed)``.

    One trainer serves every round, so on the card a step kind is
    captured once for the sweep and replayed in every round (the cohort's
    shapes are fixed by the spec). A round's wall time ends in a device
    sync and leaves out the cohort's draw and upload.

    `checkpoint_dir` makes the sweep preemptible: each round's aggregate
    is written there, and a restarted call resumes after the newest round
    file — bitwise the uninterrupted run. `eval_every=k` evaluates every
    k-th round (0: the final round only); `rounds` overrides
    `fleet.rounds` (e.g. to stop a sweep midway). No device mesh is
    ported: a `mesh` raises."""
    if mesh is not None:
        raise NotImplementedError(
            "run_fleet: mesh= (sharding a cohort over devices) is not "
            "ported yet")
    t0 = time.time()
    plan = _fleet_plan(fleet)
    fed = dataclasses.replace(fed, n_clients=fleet.cohort_size)
    n_rounds = fleet.rounds if rounds is None else rounds
    acc = fleet_eval(model, fleet)
    trainer = _make_trainer(model.loss_fn, fed, plan)

    params = model.init(fleet.seed)
    start, resumed_from = 0, None
    if checkpoint_dir is not None:
        r, saved = latest_fleet_round(checkpoint_dir, params)
        if r is not None:
            params, start, resumed_from = saved, r + 1, r

    cohorts: List[CohortRecord] = []
    for r in range(start, n_rounds):
        cohort = materialize_cohort(fleet, r)
        exp = Experiment(
            model=model, client_iters=cohort.streams(scan=scan,
                                                     to=model.device),
            fed=fed, strategy=fleet.strategy,
            seed=fleet.seed * 100003 + r, init_params=params)
        _sync(model.device)
        g0 = time.time()
        params = interpret_batched([exp], plan, _trainer=trainer)[0].params
        _sync(model.device)
        wall = time.time() - g0
        metric = None
        if (eval_every and (r + 1) % eval_every == 0) or r == n_rounds - 1:
            metric = float(acc(params))
        cohorts.append(CohortRecord(round=r, clients=cohort.client_ids,
                                    global_metric=metric, wall_time_s=wall))
        if checkpoint_dir is not None:
            save_fleet_round(checkpoint_dir, r, params)

    final = (cohorts[-1].global_metric if cohorts
             else float(acc(params)))
    return FleetResult(fleet=fleet, strategy=fleet.strategy, params=params,
                       fed=fed, cohorts=cohorts, final_metric=final,
                       wall_time_s=time.time() - t0,
                       resumed_from=resumed_from)
