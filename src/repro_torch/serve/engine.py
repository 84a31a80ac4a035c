"""The pool scoring engine: `PoolServer` (port of
``repro/serve/engine.py``).

A trained pool is a stack of S member models; serving it answers "what
does the ensemble say about this batch of queries" at request latency:

* **members** — the densified path runs the model's own forward once per
  capacity slot (dead slots included, as the reference's vmap computes
  them) and stacks the logits (C, B, …); the factored path (a
  `LowRankDeltaPool` whose model carries the `models/factored.py` hook)
  runs one shared-base forward with per-member BGMV corrections. On the
  card both run attention through the flash-attention kernel and the
  factored path its corrections through the BGMV kernel.
* **a reduction head** — masked weighted mean of logits (default),
  weighted majority vote, or caller-supplied per-member weights /
  `weight_fn(members, mask)`.
* **bucketed request batching** — request counts round up to a ladder of
  bucket sizes (`DEFAULT_BUCKETS`); padding rows repeat the chunk's last
  real query and are dropped on the host.
* **device-resident queries** — the query pool is uploaded once
  (`serve/traffic.py`); a request is an index gather on the device.

A `ModelPool` serves all live members; a `MomentPool` only its running
mean (P = 1); a `LowRankDeltaPool` in factor form when the model has the
hook (`from_pool(..., factored=None|True|False)`), densified once
(`materialize_members`) otherwise — the densified path is the factored
one's oracle."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool
from repro_torch.models.factored import (FACTORED_FORWARD_ATTR,
                                         factored_forward_for)

F32 = torch.float32


class FactoredMembers(NamedTuple):
    """Factor-form serving stack: the shared base params plus the pool's
    deltas (``{name: LeafDelta}``, capacity on their stacks' leading axis,
    laid out by the hook's `prepare` where it has one). Stands in for the
    stacked members wherever the server passes `members`, `weight_fn`
    hooks included."""
    base: Any
    deltas: Any


# Power-of-~4 ladder: single requests don't pay a 128-wide forward, and a
# trace touches at most 4 batch shapes.
DEFAULT_BUCKETS = (1, 8, 32, 128)

MODES = ("mean_logits", "majority_vote")


def _reduce(mode: str, w: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """(P,) weights × (P, B, …, C) member logits → (B, …, C) scores. The
    mean_logits expression is the reference's pinned one; majority_vote
    normalizes by the same w.sum(), so each request's vote mass is 1."""
    wf = w.reshape((w.shape[0],) + (1,) * (logits.dim() - 1))
    if mode == "mean_logits":
        return (wf * logits).sum(0) / w.sum()
    votes = torch.nn.functional.one_hot(
        torch.argmax(logits, -1), logits.shape[-1]).to(logits.dtype)
    return (wf * votes).sum(0) / w.sum()


def _device_of(members) -> torch.device:
    tree = members.base if isinstance(members, FactoredMembers) else members
    return next(iter(tree.values())).device


class PoolServer:
    """One trained pool (or collapsed model) served for query scoring.

    `members` is a name → (P, …) stacked dict, or a `FactoredMembers`;
    `mask` is a (P,) float32 of live slots (dead slots score with weight
    0). Build it with `from_pool`, `from_params` or `from_result`."""

    def __init__(self, model, members, mask, *, mode: str = "mean_logits",
                 weights=None,
                 weight_fn: Optional[Callable[[Any, torch.Tensor],
                                              Any]] = None,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS):
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; expected one of "
                             f"{MODES}")
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"buckets must be positive ints; got {buckets}")
        self.model = model
        self.mode = mode
        self.buckets = buckets
        self.members = members
        self.device = _device_of(members)
        self.mask = torch.as_tensor(mask, dtype=F32).to(self.device)
        if weight_fn is not None:
            weights = weight_fn(members, self.mask)
        w = (torch.as_tensor(weights, dtype=F32).to(self.device)
             if weights is not None else self.mask)
        self.weights = w * self.mask          # dead slots never vote
        self.n_members = int(self.mask.sum())
        self.factored = isinstance(members, FactoredMembers)
        if self.factored:
            self._ffwd = factored_forward_for(model.forward)
            if self._ffwd is None:
                raise ValueError(
                    "FactoredMembers given but model.forward has no "
                    f"'{FACTORED_FORWARD_ATTR}' hook (models/factored.py)")

    def member_logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(P, B, …) logits of every slot. Factored: one shared-base
        forward (dead slots carry zero deltas, so they score as the base,
        like the densified stack's zero-padded slots). Densified: the
        model's forward per slot, stacked."""
        m = self.members
        with torch.no_grad():
            if self.factored:
                return self._ffwd(m.base, m.deltas, batch)
            slots = next(iter(m.values())).shape[0]
            return torch.stack([
                self.model.forward({k: v[c] for k, v in m.items()}, batch)
                for c in range(slots)])

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_pool(cls, model, pool, *, factored: Optional[bool] = None,
                  **kw) -> "PoolServer":
        """Serve a trained pool: every live `ModelPool` member; a
        `LowRankDeltaPool` in factor form when the model carries the
        `forward_factored` hook (its deltas laid out once by the hook's
        `prepare`), densified once otherwise; a `MomentPool`'s running
        mean (P = 1). `factored`: None auto-routes on the hook, True
        requires it, False forces the densified path (the oracle)."""
        if isinstance(pool, ModelPool):
            return cls(model, pool.members, pool.mask(), **kw)
        if isinstance(pool, LowRankDeltaPool):
            hook = factored_forward_for(model.forward)
            if factored is None:
                factored = hook is not None
            if factored:
                if hook is None:
                    raise ValueError(
                        "factored=True but model.forward has no "
                        f"'{FACTORED_FORWARD_ATTR}' hook; use "
                        "factored=False (or None) for the densified path")
                deltas = pool.delta_tree()
                prepare = getattr(hook, "prepare", None)
                if prepare is not None:
                    deltas = prepare(pool.base, deltas)
                return cls(model, FactoredMembers(pool.base, deltas),
                           pool.mask(), **kw)
            return cls(model, pool.materialize_members(), pool.mask(), **kw)
        if isinstance(pool, MomentPool):
            return cls.from_params(model, pool.average(), **kw)
        raise TypeError(
            f"expected a ModelPool, LowRankDeltaPool or MomentPool, got "
            f"{type(pool).__name__}; for a bare params dict use "
            "PoolServer.from_params")

    @classmethod
    def from_params(cls, model, params: Dict[str, torch.Tensor],
                    **kw) -> "PoolServer":
        """Serve a single aggregated model through the same path, P = 1."""
        members = {k: v[None] for k, v in params.items()}
        return cls(model, members, torch.ones((1,), dtype=F32), **kw)

    @classmethod
    def from_result(cls, model, result, source: str = "pool",
                    **kw) -> "PoolServer":
        """Serve a `RunResult`: its trained pool (`source="pool"`; raises
        `require_final_pool`'s diagnosis when the plan discarded it) or its
        aggregated params (`source="params"`)."""
        if source == "params":
            return cls.from_params(model, result.params, **kw)
        if source != "pool":
            raise ValueError(f"source must be 'pool' or 'params', "
                             f"got {source!r}")
        return cls.from_pool(model, result.require_final_pool(), **kw)

    @classmethod
    def from_checkpoint(cls, model, path: str, params_like,
                        **kw) -> "PoolServer":
        """Serve a pool saved with `repro_torch.checkpoint.save_pool` (or
        the reference's): train → save → load → serve is bitwise train →
        serve. `params_like` is one model's params (structure, dtypes and
        device; e.g. `model.init(seed)`)."""
        from repro_torch.checkpoint import load_pool
        return cls.from_pool(model, load_pool(path, params_like), **kw)

    # -- scoring ------------------------------------------------------------

    def bucket_for(self, n: int) -> int:
        """Smallest bucket ≥ n (larger ticks are served in max-bucket
        chunks)."""
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def chunk_plan(self, n: int) -> List[Tuple[int, int, int]]:
        """(start, length, bucket) chunks covering an n-request tick."""
        plan, start, cap = [], 0, self.buckets[-1]
        while start < n:
            m = min(cap, n - start)
            plan.append((start, m, self.bucket_for(m)))
            start += m
        return plan

    def score_batch(self, batch: Dict[str, torch.Tensor]):
        """Score one gathered batch (no bucketing): (ensemble scores
        (B, …, C), predictions) as tensors on the device."""
        scores = _reduce(self.mode, self.weights, self.member_logits(batch))
        return scores, torch.argmax(scores, -1)

    def score(self, arrays: Dict[str, torch.Tensor],
              idx) -> Tuple[np.ndarray, np.ndarray]:
        """Score requests `idx` (indices into the device-resident query
        pool `arrays`) through the buckets; padding repeats the chunk's
        last real index and is dropped on the host. Returns host arrays,
        as responses are."""
        idx = np.asarray(idx, np.int32)
        n = len(idx)
        if n == 0:
            raise ValueError("score() needs at least one request index")
        outs = []
        for start, m, bucket in self.chunk_plan(n):
            chunk = idx[start:start + m]
            if m < bucket:
                chunk = np.concatenate(
                    [chunk, np.full(bucket - m, chunk[-1], np.int32)])
            rows = torch.from_numpy(chunk).to(self.device).long()
            scores, preds = self.score_batch(
                {k: a[rows] for k, a in arrays.items()})
            outs.append((scores.cpu().numpy()[:m], preds.cpu().numpy()[:m]))
        if len(outs) == 1:
            return outs[0]
        return (np.concatenate([s for s, _ in outs]),
                np.concatenate([p for _, p in outs]))

    def warmup(self, arrays: Dict[str, torch.Tensor], sizes) -> None:
        """Score once at every bucket a trace will use before timing."""
        done = set()
        for n in sizes:
            for _, m, bucket in self.chunk_plan(int(n)):
                if bucket not in done:
                    done.add(bucket)
                    self.score(arrays, np.zeros(bucket, np.int32))
