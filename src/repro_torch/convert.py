"""Parameter conversion between the JAX reference's pytrees and the port's
name → tensor dicts.

A reference pytree of nested dicts (``{"c1": {"b": ..., "w": ...}, ...}``)
flattens to dotted names in the reference's leaf order (sorted keys at
every level: ``c1.b, c1.w, …, fc2.w``). Layouts are shared (NHWC, HWIO),
so values copy unchanged in both directions. The language models' layer
leaves carry a leading L axis (``layers.mixer.w_in``, …) and the hybrid's
shared block sits under ``shared_attn.``; bf16 leaves (numpy's
``ml_dtypes.bfloat16``, as ``np.asarray`` gives them from a bf16 jax
array) copy bit for bit. Stacked pools convert the same way: their leaves
just carry a leading capacity axis; `from_jax_pool` carries any reference
pool across (stacked, moment-form or low-rank)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool
from repro_torch.device import DeviceLike, resolve_device


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], f"{prefix}{key}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def _from_numpy(x: np.ndarray) -> torch.Tensor:
    """A tensor holding `x`'s values; numpy has no bfloat16 of its own, so
    a bf16 array (ml_dtypes) crosses as its 16-bit patterns."""
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(x, copy=True))


def from_jax_params(tree: Any, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy-convertible leaves → ``{"c1.b": tensor, …}`` on
    `device` (the CUDA device by default), in the reference's leaf order."""
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: _from_numpy(v).to(dev) for k, v in flat.items()}


def to_jax_params(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of `from_jax_params`: nested dict of numpy arrays, ready for
    ``jax.tree.map(jnp.asarray, …)``."""
    tree: Dict[str, Any] = {}
    for name, value in params.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value.detach().cpu().numpy().copy()
    return tree


def _tensor(x: Any, dev: torch.device) -> torch.Tensor:
    return _from_numpy(np.asarray(x)).to(dev)


def _count(count: Any, dev: torch.device) -> torch.Tensor:
    """A reference pool's count as the port's: an int32 scalar on `dev`."""
    return torch.full((), int(count), dtype=torch.int32, device=dev)


def from_jax_lowrank_pool(pool: Any, device: DeviceLike = None):
    """A reference `LowRankDeltaPool` (jax or numpy leaves) → the port's,
    on `device`: the same base, factor stacks, dense stacks and count, so
    both packages serve the same factors."""
    dev = resolve_device(device)
    return LowRankDeltaPool(
        base=from_jax_params(pool.base, dev),
        u={k: _tensor(a, dev) for k, a in sorted(pool.u.items())},
        v={k: _tensor(a, dev) for k, a in sorted(pool.v.items())},
        dense={k: _tensor(a, dev) for k, a in sorted(pool.dense.items())},
        count=_count(pool.count, dev))


def from_jax_pool(pool: Any, device: DeviceLike = None):
    """Any reference pool (`ModelPool`, `MomentPool`, `LowRankDeltaPool`;
    recognised by its class name, jax or numpy leaves) → the port's
    counterpart on `device`."""
    dev = resolve_device(device)
    kind = type(pool).__name__
    if kind == "LowRankDeltaPool":
        return from_jax_lowrank_pool(pool, dev)
    if kind == "ModelPool":
        return ModelPool(from_jax_params(pool.members, dev),
                         _count(pool.count, dev))
    if kind == "MomentPool":
        return MomentPool(from_jax_params(pool.mean, dev),
                          _tensor(pool.sq_norm_mean, dev),
                          _count(pool.count, dev),
                          from_jax_params(pool.anchor, dev))
    raise TypeError(f"from_jax_pool: no conversion for a {kind}")
