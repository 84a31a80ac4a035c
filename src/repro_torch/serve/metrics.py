"""Serving measurement: `serve_trace` → `ServeReport` (port of
``repro/serve/metrics.py``).

Replays a `RequestTrace` against a `PoolServer` tick by tick on the host
clock. `PoolServer.score` returns host arrays, so each tick's time runs to
the card's completion; every request of a tick is attributed the tick's
latency. Every bucket the trace touches is warmed before the clock
starts."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np


@dataclasses.dataclass
class ServeReport:
    """Latency/throughput/accuracy of one (server, trace) replay."""
    traffic: str
    mode: str
    n_members: int
    n_requests: int
    n_ticks: int
    p50_ms: float
    p95_ms: float
    p99_ms: float
    qps: float
    accuracy: Optional[float] = None

    def row(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def serve_trace(server, trace, warm: bool = True) -> ServeReport:
    """Replay `trace` through `server` and measure it."""
    if warm:
        server.warmup(trace.arrays, trace.tick_sizes())
    latencies: list = []
    preds_all: list = []
    busy = 0.0
    for idx in trace.ticks:
        t0 = time.perf_counter()
        _, preds = server.score(trace.arrays, idx)   # host arrays: synced
        dt = time.perf_counter() - t0
        busy += dt
        latencies.extend([dt] * len(idx))
        preds_all.append(preds)
    lat = np.asarray(latencies)
    preds = np.concatenate(preds_all)
    acc = (float(np.mean(preds == trace.labels))
           if trace.labels is not None else None)
    return ServeReport(
        traffic=trace.spec.name, mode=server.mode,
        n_members=server.n_members,
        n_requests=int(lat.size), n_ticks=len(trace.ticks),
        p50_ms=float(np.percentile(lat, 50) * 1e3),
        p95_ms=float(np.percentile(lat, 95) * 1e3),
        p99_ms=float(np.percentile(lat, 99) * 1e3),
        qps=float(lat.size / busy) if busy > 0 else float("inf"),
        accuracy=acc)
