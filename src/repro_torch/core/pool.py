"""The FedELMY model pools (paper §3.2; port of ``repro/core/pool.py``).
Functional like the reference — `append` returns a new pool and leaves
this one unchanged. Parameters are name → tensor dicts in the
reference's leaf order (`repro_torch.convert`). A pool's `count` is an
int32 scalar on its device, as the reference's is: `mask()`, the average's
weights mask/count and `append`'s slot read it there, so a training step
captured in a CUDA graph reads the count of each replay. Only `append`'s
fullness check reads it on the host, outside any step; `_append` is the
append without it, the form `torch.func.vmap` takes over a run axis of
pools (whose caller checks the room once for all runs). `create`,
`average` and `_append` make new tensors only, so they vmap too.

* `ModelPool` — paper-faithful: a fixed-capacity stack (S+1) of full
  member parameters per leaf plus a live-member count.
* `MomentPool` — only the running member mean μ, the mean squared member
  norm q and the count: exact for the squared-L2 regularizer,
  mean_t ‖w − w_t‖² = ‖w‖² − 2⟨w, μ⟩ + q.
* `LowRankDeltaPool` — member t is ``base + U_t·V_tᵀ`` per matrix leaf
  (dense deltas for the rest), appended through a randomized range
  finder whose projection Ω per leaf is the reference's own
  (``fold_in(PRNGKey(20240412), leaf)``, drawn by `core/prng`).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import prng

Params = Dict[str, torch.Tensor]
F32 = torch.float32


def _count(n: int, device) -> torch.Tensor:
    """A pool's live-member count: an int32 scalar on `device`."""
    return torch.full((), n, dtype=torch.int32, device=device)


def _check_room(count: torch.Tensor, capacity: int) -> None:
    """Raise when a pool of `capacity` slots holding `count` is full (the
    one host read of the count)."""
    if int(count) >= capacity:
        raise ValueError(f"pool is full ({capacity} members)")


def _put(stack: torch.Tensor, count: torch.Tensor,
         value: torch.Tensor) -> torch.Tensor:
    """A copy of `stack` with slot `count` (read on the device) set to
    `value`."""
    return stack.index_copy(0, count.reshape(1).long(),
                            value.detach().to(stack.dtype).unsqueeze(0))


def _weights(mask: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """The masked mean's weights mask/count, in f32 on the device."""
    return mask / count.to(F32)


class ModelPool(NamedTuple):
    """`members`: leaf name → (capacity, *leaf shape) tensor; `count`: the
    number of live members (the first `count` slots), an int32 scalar on
    the members' device."""
    members: Params
    count: torch.Tensor

    @classmethod
    def create(cls, m0: Params, capacity: int) -> "ModelPool":
        members = {k: torch.cat([p.detach().unsqueeze(0), torch.zeros(
            (capacity - 1,) + tuple(p.shape), dtype=p.dtype,
            device=p.device)]) for k, p in m0.items()}
        return cls(members, _count(1, next(iter(m0.values())).device))

    @property
    def capacity(self) -> int:
        return next(iter(self.members.values())).shape[0]

    def append(self, params: Params) -> "ModelPool":
        """A new pool with `params` in slot `count`."""
        _check_room(self.count, self.capacity)
        return self._append(params)

    def _append(self, params: Params) -> "ModelPool":
        return ModelPool({k: _put(s, self.count, params[k])
                          for k, s in self.members.items()},
                         self.count + 1)

    def mask(self) -> torch.Tensor:
        dev = next(iter(self.members.values())).device
        return (torch.arange(self.capacity, device=dev) < self.count).to(F32)

    def average(self) -> Params:
        """Eq. 5/6: masked mean over live members — weights mask/count,
        summed in f32 over the capacity axis."""
        w = _weights(self.mask(), self.count)
        out = {}
        for k, s in self.members.items():
            wf = w.reshape((self.capacity,) + (1,) * (s.dim() - 1))
            out[k] = torch.sum(s.to(F32) * wf, dim=0).to(s.dtype)
        return out

    def first(self) -> Params:
        """m_0^i — the d2 anchor."""
        return {k: s[0] for k, s in self.members.items()}


# ---------------------------------------------------------------------------
# Moment-form pool
# ---------------------------------------------------------------------------

def _sq_norm(params: Params) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.to(F32))) for x in params.values())


class MomentPool(NamedTuple):
    """Moment-form pool statistics (squared-L2 regularizer only)."""
    mean: Params                # μ, f32
    sq_norm_mean: torch.Tensor  # q = mean_t ‖w_t‖², f32 scalar
    count: torch.Tensor         # int32 scalar
    anchor: Params              # m_0^i, kept exactly (d2 needs it)

    @classmethod
    def create(cls, m0: Params) -> "MomentPool":
        m0 = {k: v.detach() for k, v in m0.items()}
        return cls({k: v.to(F32) for k, v in m0.items()}, _sq_norm(m0),
                   _count(1, next(iter(m0.values())).device), m0)

    def append(self, params: Params) -> "MomentPool":
        """Left-fold update μ ← (n·μ + w)/(n+1) in append order (agrees
        with the stacked pool's masked mean to rounding, not bitwise)."""
        n = self.count.to(F32)
        mean = {k: (m * n + params[k].detach().to(F32)) / (n + 1)
                for k, m in self.mean.items()}
        q = (self.sq_norm_mean * n +
             _sq_norm({k: v.detach() for k, v in params.items()})) / (n + 1)
        return MomentPool(mean, q, self.count + 1, self.anchor)

    _append = append           # never full: no check to leave out

    def average(self) -> Params:
        return {k: m.to(self.anchor[k].dtype) for k, m in self.mean.items()}

    def first(self) -> Params:
        return self.anchor

    def mean_sq_distance(self, params: Params) -> torch.Tensor:
        """mean_t ‖w − w_t‖² = ‖w‖² − 2⟨w, μ⟩ + q (exact). Each leaf is
        widened to f32 once for both sums, so the gradient 2w − 2μ of a
        bf16 leaf is formed in f32 and rounded once: rounded term by term,
        w's and μ's terms cancel to bf16 noise where w lies near μ."""
        wide = {k: p.to(F32) for k, p in params.items()}
        wsq = _sq_norm(wide)
        dot = sum(torch.sum(p * self.mean[k]) for k, p in wide.items())
        return torch.clamp_min(wsq - 2.0 * dot + self.sq_norm_mean, 0.0)


# ---------------------------------------------------------------------------
# Low-rank delta pool
# ---------------------------------------------------------------------------

# A leaf is factored when its trailing two dims form a real matrix; smaller
# trailing dims (biases, norm scales) stay dense deltas. Leading dims (the
# transformer's layer axis L on (L, d_in, d_out) leaves) batch matrices.
FACTOR_MIN = 8

# Seed of the range finder's projection Ω; folding in the leaf index makes
# each leaf's Ω a pure function of its position (the reference's).
_OMEGA_SEED = 20240412


def _leaf_key(i: int) -> str:
    """Dict key of base leaf i (zero-padded: sorted keys = leaf order)."""
    return f"{i:04d}"


def _is_factored(shape) -> bool:
    return len(shape) >= 2 and min(shape[-2:]) >= FACTOR_MIN


def omega(leaf_idx: int, d_out: int, r: int) -> np.ndarray:
    """The range finder's Gaussian projection (d_out, r) f32 of leaf
    `leaf_idx`: ``jax.random.normal(fold_in(PRNGKey(20240412), leaf_idx),
    (d_out, r))``."""
    key = prng.fold_in(prng.prng_key(_OMEGA_SEED), leaf_idx)
    return prng.normal(key, (d_out, r))


def _project_delta(delta: torch.Tensor, r: int, leaf_idx: int):
    """Randomized range finder: delta (…, d_in, d_out) ≈ U·Vᵀ with U
    (…, d_in, r) orthonormal. Y = Δ·Ω, Q = qr(Y), U = Q, V = ΔᵀQ; exact at
    full rank r = min(d_in, d_out). QR's signs may differ from the
    reference's; U·Vᵀ does not depend on them."""
    om = torch.from_numpy(omega(leaf_idx, delta.shape[-1], r)).to(
        delta.device)
    y = delta @ om
    q, _ = torch.linalg.qr(y)
    v = delta.transpose(-1, -2) @ q
    return q, v


class LeafDelta(NamedTuple):
    """One base leaf's per-member delta in pool-native form: factor stacks
    (u, v) for matrix leaves, a dense stack for the rest — exactly one side
    is set."""
    u: Optional[torch.Tensor]      # (C, *lead, d_in, r) f32
    v: Optional[torch.Tensor]      # (C, *lead, d_out, r) f32
    dense: Optional[torch.Tensor]  # (C, *shape) f32


class LowRankDeltaPool(NamedTuple):
    """Factor-form pool: member t is base + U_t·V_tᵀ per matrix leaf (dense
    delta elsewhere); member 0 is the base itself (zero factors). `u`,
    `v`, `dense` are keyed by `_leaf_key` of the base leaf's index, their
    leading axis the capacity; per-leaf rank is min(rank, d_in, d_out)."""
    base: Params
    u: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]
    dense: Dict[str, torch.Tensor]
    count: torch.Tensor              # int32 scalar

    @classmethod
    def create(cls, m0: Params, capacity: int,
               rank: int) -> "LowRankDeltaPool":
        u, v, dense = {}, {}, {}
        for i, p in enumerate(m0.values()):
            k, dev, shape = _leaf_key(i), p.device, tuple(p.shape)
            if _is_factored(shape):
                r = min(rank, shape[-2], shape[-1])
                u[k] = torch.zeros((capacity,) + shape[:-1] + (r,),
                                   dtype=F32, device=dev)
                v[k] = torch.zeros((capacity,) + shape[:-2] + (shape[-1], r),
                                   dtype=F32, device=dev)
            else:
                dense[k] = torch.zeros((capacity,) + shape, dtype=F32,
                                       device=dev)
        return cls({k: p.detach() for k, p in m0.items()}, u, v, dense,
                   _count(1, next(iter(m0.values())).device))

    @property
    def capacity(self) -> int:
        return next(iter({**self.u, **self.dense}.values())).shape[0]

    @property
    def rank(self) -> int:
        """The rank ceiling in use (the largest per-leaf factor rank)."""
        return max([a.shape[-1] for a in self.u.values()] or [0])

    def append(self, params: Params) -> "LowRankDeltaPool":
        """Truncated-rank append: Δ = params − base, each matrix leaf
        projected onto rank r by the range finder."""
        _check_room(self.count, self.capacity)
        return self._append(params)

    def _append(self, params: Params) -> "LowRankDeltaPool":
        u, v, dense = dict(self.u), dict(self.v), dict(self.dense)
        for i, (name, b) in enumerate(self.base.items()):
            k = _leaf_key(i)
            delta = params[name].detach().to(F32) - b.to(F32)
            if k in dense:
                dense[k] = _put(dense[k], self.count, delta)
            else:
                ui, vi = _project_delta(delta, u[k].shape[-1], i)
                u[k] = _put(u[k], self.count, ui)
                v[k] = _put(v[k], self.count, vi)
        return self._replace(u=u, v=v, dense=dense, count=self.count + 1)

    def mask(self) -> torch.Tensor:
        dev = next(iter(self.base.values())).device
        return (torch.arange(self.capacity, device=dev) < self.count).to(F32)

    def _delta(self, i: int, t: Optional[int] = None) -> torch.Tensor:
        """Leaf i's delta for member t, or for every slot (C, *shape)."""
        k = _leaf_key(i)
        if k in self.dense:
            return self.dense[k] if t is None else self.dense[k][t]
        u, v = ((self.u[k], self.v[k]) if t is None
                else (self.u[k][t], self.v[k][t]))
        return u @ v.transpose(-1, -2)

    def average(self) -> Params:
        """Eq. 5/6 masked mean: base + Σ_t w_t·U_tV_tᵀ (dense elsewhere),
        densified once per call."""
        w = _weights(self.mask(), self.count)
        out = {}
        for i, (name, b) in enumerate(self.base.items()):
            k = _leaf_key(i)
            if k in self.dense:
                d = torch.einsum("c,c...->...", w, self.dense[k])
            else:
                d = torch.einsum("c,c...ir,c...jr->...ij", w, self.u[k],
                                 self.v[k])
            out[name] = (b.to(F32) + d).to(b.dtype)
        return out

    def first(self) -> Params:
        """m_0^i — the d2 anchor: the base, exactly."""
        return self.base

    def member(self, t: int) -> Params:
        """Densify member t: base + U_tV_tᵀ (dense delta elsewhere)."""
        return {name: (b.to(F32) + self._delta(i, t)).to(b.dtype)
                for i, (name, b) in enumerate(self.base.items())}

    def delta_tree(self) -> Dict[str, LeafDelta]:
        """The deltas re-hung on the base's names: ``{name: LeafDelta}`` —
        the factored-serving handoff (`serve.PoolServer.from_pool`)."""
        out = {}
        for i, name in enumerate(self.base):
            k = _leaf_key(i)
            out[name] = (LeafDelta(None, None, self.dense[k])
                         if k in self.dense
                         else LeafDelta(self.u[k], self.v[k], None))
        return out

    def materialize_members(self) -> Params:
        """Every slot densified, stacked (C leading) — the densified
        serving handoff and the factored path's oracle."""
        return {name: (b[None].to(F32) + self._delta(i)).to(b.dtype)
                for i, (name, b) in enumerate(self.base.items())}


def _tensors(obj: Any):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for x in obj.values():
            yield from _tensors(x)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            yield from _tensors(x)


def pool_nbytes(pool: Any) -> int:
    """Total bytes of the tensors a pool (or a server's members) holds —
    the serving-memory metric (a pool's int32 count counts 4 bytes, as
    the reference's does)."""
    return sum(t.numel() * t.element_size() for t in _tensors(pool))
