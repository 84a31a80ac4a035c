"""Pytree checkpoints in the reference's npz format (port of
``repro/checkpoint/checkpoint.py``), so that a file written by either
package loads in the other.

A file is one ``np.savez`` archive, one array a leaf, keyed by the leaf's
path with ``::`` between its parts: a parameter ``c1.b`` is ``c1::b``; a
pool field is ``.<field>`` (``.members::c1::b``, ``.count``, ``.u::0000``),
as the reference's key paths print a NamedTuple's attribute. bf16 leaves
are stored as their 16-bit patterns, a ``V2`` array, as the reference's
``np.savez`` stores an ``ml_dtypes.bfloat16`` leaf; a ``V2`` array loads
back into a bf16 tensor bit for bit (and only into one). Loading returns tensors on the
device of the ``like`` leaves.

This is the client→client transfer format too: `launch.train`'s
``--handoff-dir`` saves and reloads the final params through it.
"""
from __future__ import annotations

import glob
import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

SEP = "::"
# numpy has no bfloat16: a bf16 leaf crosses as its bit patterns
_BF16_BITS = np.dtype("V2")


def _is_record(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _parts(name: Any) -> Tuple[str, ...]:
    """The key parts of a dict key: a dotted parameter name, split."""
    return tuple(str(name).split("."))


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in order: a dict's names split at the dots, a
    NamedTuple's fields as ``.field``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + _parts(k))
    elif _is_record(tree):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), prefix + (f".{f}",))
    else:
        yield SEP.join(prefix), tree


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_BITS)
        return x.numpy()
    return np.asarray(x)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def _from_numpy(key: str, arr: np.ndarray,
                like: torch.Tensor) -> torch.Tensor:
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {key!r} has shape {arr.shape}; "
                         f"expected {tuple(like.shape)}")
    # `_read`'s arrays are fresh and writable: the tensor takes them over
    if arr.dtype == _BF16_BITS:
        if like.dtype != torch.bfloat16:
            raise ValueError(
                f"checkpoint leaf {key!r} holds bf16 bit patterns (|V2); "
                f"the template's leaf is {like.dtype}, and bf16 is not "
                "cast on load")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _unflatten_like(flat: Dict[str, np.ndarray], like: Any,
                    prefix: Tuple[str, ...] = ()) -> Any:
    """`like`'s structure with its leaves read from `flat`, each cast to
    the template leaf's dtype, on its device."""
    if isinstance(like, dict):
        return {k: _unflatten_like(flat, v, prefix + _parts(k))
                for k, v in like.items()}
    if _is_record(like):
        return type(like)(*(_unflatten_like(flat, getattr(like, f),
                                            prefix + (f".{f}",))
                            for f in like._fields))
    key = SEP.join(prefix)
    return _from_numpy(key, flat[key], like)


def _read(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return dict(data)


def save_pytree(path: str, tree: Any) -> None:
    """Write `tree` (a params dict, nested dicts or NamedTuples of
    tensors) to the npz file `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_pytree(path: str, like: Any) -> Any:
    """Read a `save_pytree` file into `like`'s structure, dtypes and
    devices (`like`'s values are not read)."""
    return _unflatten_like(_read(path), like)


# -- fleet round checkpoints (the elastic-resume protocol) -------------------
#
# A fleet sweep writes the post-aggregate global params after each cohort
# round; a preempted sweep restarts from the newest round file. Every fleet
# quantity (cohort draw, client shards, round seeds) is a pure function of
# (FleetSpec, round) and the npz round trip is bit-exact, so the resumed
# run's remaining rounds are the uninterrupted run's.

_ROUND_RE = re.compile(r"round_(\d+)\.npz$")


def fleet_round_path(ckpt_dir: str, r: int) -> str:
    return os.path.join(ckpt_dir, f"round_{r:05d}.npz")


def save_fleet_round(ckpt_dir: str, r: int, params: Any) -> None:
    """Write round r's post-aggregate global params."""
    save_pytree(fleet_round_path(ckpt_dir, r), params)


def latest_fleet_round(ckpt_dir: str,
                       like: Any) -> Tuple[Optional[int], Any]:
    """(newest checkpointed round, its params), or (None, None) when the
    directory holds no round file (a fresh start). `like` gives the
    params' structure, dtypes and devices (e.g. `model.init(seed)`)."""
    rounds = []
    for path in glob.glob(os.path.join(ckpt_dir, "round_*.npz")):
        m = _ROUND_RE.search(path)
        if m:
            rounds.append((int(m.group(1)), path))
    if not rounds:
        return None, None
    r, path = max(rounds)
    return r, load_pytree(path, like)


# -- trained-pool round trip (the serving handoff) ---------------------------
#
# Loading a pool needs a template the caller cannot easily build (the
# capacity, the backend and the low-rank factors' rank are properties of
# the saved pool), so the file carries them: the backend kind and, for the
# stacked and low-rank forms, the capacity (and the rank). `load_pool`
# builds the template from one model's params and reads the leaves into it:
# train → save → load → serve is bitwise train → serve.

_KIND_KEY = "__pool_kind__"
_CAPACITY_KEY = "__capacity__"
_RANK_KEY = "__rank__"


def save_pool(path: str, pool: Any) -> None:
    """Write a `ModelPool`, `MomentPool` or `LowRankDeltaPool` with its
    kind (and capacity, rank) to the npz file `path`."""
    from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool
    if isinstance(pool, ModelPool):
        meta = {_KIND_KEY: "stacked", _CAPACITY_KEY: pool.capacity}
    elif isinstance(pool, MomentPool):
        meta = {_KIND_KEY: "moment"}
    elif isinstance(pool, LowRankDeltaPool):
        meta = {_KIND_KEY: "lowrank", _CAPACITY_KEY: pool.capacity,
                _RANK_KEY: pool.rank}
    else:
        raise TypeError(
            f"save_pool expects a ModelPool, MomentPool or "
            f"LowRankDeltaPool, got {type(pool).__name__}; bare pytrees "
            "go through save_pytree")
    flat = _flatten(pool)
    flat.update({k: np.asarray(v) for k, v in meta.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **flat)


def load_pool(path: str, params_like: Dict[str, torch.Tensor]) -> Any:
    """Restore a pool saved by `save_pool` (by either package).
    `params_like` is one model's params (e.g. `model.init(seed)`): the
    template, built from it by the pool's own `create` as the reference
    builds it, gives the structure, dtypes and device; the pool's kind,
    capacity and rank come from the file. The template is freed on return
    (a stacked pool's allocates the pool once more meanwhile; a factor
    pool's holds `params_like` and zeros of the factors' shapes)."""
    from repro_torch.core.pool import LowRankDeltaPool, ModelPool, MomentPool
    flat = _read(path)
    kind = str(flat.pop(_KIND_KEY, ""))
    if kind == "stacked":
        like = ModelPool.create(params_like, int(flat.pop(_CAPACITY_KEY)))
    elif kind == "moment":
        like = MomentPool.create(params_like)
    elif kind == "lowrank":
        capacity = int(flat.pop(_CAPACITY_KEY))
        like = LowRankDeltaPool.create(params_like, capacity,
                                       int(flat.pop(_RANK_KEY)))
    else:
        raise ValueError(
            f"{path} is not a save_pool checkpoint (missing/unknown "
            f"{_KIND_KEY}={kind!r}); plain pytrees load via load_pytree")
    return _unflatten_like(flat, like)
