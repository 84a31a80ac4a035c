"""Parameter conversion between the JAX reference's pytrees and the port's
name → tensor dicts.

A reference pytree of nested dicts (``{"c1": {"b": ..., "w": ...}, ...}``)
flattens to dotted names in the reference's leaf order (sorted keys at
every level: ``c1.b, c1.w, …, fc2.w``). Layouts are shared (NHWC, HWIO),
so values copy unchanged in both directions. Stacked pools convert the
same way: their leaves just carry a leading capacity axis."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], f"{prefix}{key}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def from_jax_params(tree: Any, device: DeviceLike = None
                    ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy-convertible leaves → ``{"c1.b": tensor, …}`` on
    `device` (the CUDA device by default), in the reference's leaf order."""
    dev = resolve_device(device)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, copy=True)).to(dev)
            for k, v in flat.items()}


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
