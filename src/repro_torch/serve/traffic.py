"""Declarative request streams: `TrafficSpec` → `materialize_trace` (port
of ``repro/serve/traffic.py``; numpy, so traces are bitwise the
reference's).

A frozen `TrafficSpec` names an arrival process (steady / poisson / burst
/ ramp), the per-client query mix and the stream length;
`materialize_trace(spec, data, seed)` resolves it against per-client
shards into a `RequestTrace`: one query pool uploaded to the device once,
plus per-tick arrays of request indices into it. A skewed mix
Dirichlet-partitions the request slots across clients with the
training-side `dirichlet_partition`."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.registry import Registry
from repro_torch.data.partition import dirichlet_partition
from repro_torch.device import DeviceLike, resolve_device

Arrays = Dict[str, np.ndarray]

ARRIVALS = ("steady", "poisson", "burst", "ramp")
CLIENT_MIXES = ("uniform", "dirichlet")


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """One serving workload, declaratively."""
    name: str
    arrival: str = "steady"       # ARRIVALS
    n_requests: int = 512         # total stream length
    mean_batch: int = 8           # requests per tick (arrival-shaped)
    burst_factor: int = 8         # burst: mean_batch × factor spikes
    burst_every: int = 10         # burst: spike every k-th tick
    ramp_to: int = 32             # ramp: tick size grows 1 → ramp_to
    client_mix: str = "uniform"   # CLIENT_MIXES
    mix_beta: float = 0.3         # dirichlet mix concentration
    max_batch: int = 128          # hard per-tick cap

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival {self.arrival!r}; expected "
                             f"one of {ARRIVALS}")
        if self.client_mix not in CLIENT_MIXES:
            raise ValueError(f"unknown client_mix {self.client_mix!r}; "
                             f"expected one of {CLIENT_MIXES}")
        if self.n_requests < 1 or self.mean_batch < 1:
            raise ValueError("n_requests and mean_batch must be >= 1")
        if self.max_batch < self.mean_batch:
            raise ValueError(f"max_batch={self.max_batch} < "
                             f"mean_batch={self.mean_batch}")
        if self.arrival == "burst" and self.burst_every < 1:
            raise ValueError("burst_every must be >= 1")
        if self.arrival == "ramp" and self.ramp_to < 1:
            raise ValueError("ramp_to must be >= 1")

    def replace(self, **kw) -> "TrafficSpec":
        return dataclasses.replace(self, **kw)


TRAFFICS = Registry("traffic spec")


def register_traffic(spec: TrafficSpec) -> TrafficSpec:
    TRAFFICS.register(spec.name, spec)
    return spec


def get_traffic(name: str) -> TrafficSpec:
    return TRAFFICS.get(name)


def list_traffics() -> List[str]:
    return TRAFFICS.names()


@dataclasses.dataclass
class RequestTrace:
    """A materialized stream: the device-resident query pool, the source
    client of every request, and per-tick int32 arrays of query-pool
    indices (what `PoolServer.score` gathers on the device)."""
    spec: TrafficSpec
    seed: int
    arrays: Dict[str, Any]           # device query pool (no labels)
    labels: Optional[np.ndarray]     # host-side gold, for accuracy
    ticks: List[np.ndarray]
    request_client: np.ndarray       # (n_requests,) source client per slot

    @property
    def n_requests(self) -> int:
        return int(self.request_client.shape[0])

    def flat_index(self) -> np.ndarray:
        """All request indices in arrival order."""
        return np.concatenate(self.ticks)

    def tick_sizes(self) -> List[int]:
        return [len(t) for t in self.ticks]


def _tick_sizes(spec: TrafficSpec, rng: np.random.Generator) -> List[int]:
    """Per-tick request counts summing to exactly n_requests; empty ticks
    (a poisson draw of 0) are dropped."""
    sizes: List[int] = []
    remaining, t = spec.n_requests, 0
    while remaining > 0:
        if spec.arrival == "steady":
            b = spec.mean_batch
        elif spec.arrival == "poisson":
            b = int(rng.poisson(spec.mean_batch))
        elif spec.arrival == "burst":
            spike = (t % spec.burst_every) == spec.burst_every - 1
            b = spec.mean_batch * (spec.burst_factor if spike else 1)
        else:                          # ramp
            b = min(spec.ramp_to, 1 + t)
        t += 1
        b = min(b, spec.max_batch, remaining)
        if b > 0:
            sizes.append(b)
            remaining -= b
    return sizes


def _client_of_slot(spec: TrafficSpec, n_clients: int,
                    seed: int) -> np.ndarray:
    if spec.client_mix == "uniform":
        return np.arange(spec.n_requests, dtype=np.int64) % n_clients
    parts = dirichlet_partition(np.zeros(spec.n_requests, np.int64),
                                n_clients, beta=spec.mix_beta,
                                seed=seed, min_size=1)
    out = np.empty(spec.n_requests, np.int64)
    for c, slots in enumerate(parts):
        out[slots] = c
    return out


def materialize_trace(spec: TrafficSpec, data, seed: int = 0,
                      label_key: str = "labels",
                      device: DeviceLike = None) -> RequestTrace:
    """Resolve a spec against client data into a servable trace. `data`
    is a list of per-client array dicts (or an object whose
    `client_data` is one); feature arrays are concatenated into one pool
    and uploaded to `device` (the CUDA device by default) once; labels
    stay on the host for accuracy-under-traffic."""
    clients: List[Arrays] = getattr(data, "client_data", data)
    if not clients:
        raise ValueError("materialize_trace needs at least one client shard")
    dev = resolve_device(device)
    n_clients = len(clients)
    keys = [k for k in clients[0] if k != label_key]
    if not keys:
        raise ValueError(f"client shards contain only {label_key!r}; "
                         "nothing to serve")
    flat = {k: np.concatenate([np.asarray(c[k]) for c in clients])
            for k in keys}
    labels = (np.concatenate([np.asarray(c[label_key]) for c in clients])
              if label_key in clients[0] else None)
    sizes = np.array([len(next(iter(c.values()))) for c in clients])
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])

    rng = np.random.default_rng(seed)
    request_client = _client_of_slot(spec, n_clients, seed)
    within = rng.integers(0, sizes[request_client])
    flat_idx = (offsets[request_client] + within).astype(np.int32)

    ticks, start = [], 0
    for b in _tick_sizes(spec, rng):
        ticks.append(flat_idx[start:start + b])
        start += b

    arrays = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
              for k, v in flat.items()}
    req_labels = labels[flat_idx] if labels is not None else None
    return RequestTrace(spec=spec, seed=seed, arrays=arrays,
                        labels=req_labels, ticks=ticks,
                        request_client=request_client)


# -- built-in workloads ------------------------------------------------------

register_traffic(TrafficSpec("steady_uniform"))
register_traffic(TrafficSpec("poisson_skewed", arrival="poisson",
                             client_mix="dirichlet", mix_beta=0.3))
register_traffic(TrafficSpec("burst", arrival="burst", burst_factor=8,
                             burst_every=10))
register_traffic(TrafficSpec("ramp", arrival="ramp", ramp_to=32))
