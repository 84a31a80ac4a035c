"""Batching and device placement (port of ``repro/data/pipeline.py``).
Deterministic, epoch-reshuffled; the index stream is the reference's
numpy stream, so batches are bitwise equal to it."""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _ragged_error(n: int, bs: int) -> ValueError:
    return ValueError(
        f"drop_remainder=False with n={n} not divisible by batch_size={bs} "
        "would yield a ragged final batch each epoch; a per-epoch shape "
        "change silently retriggers compilation of every cached step and "
        "is incompatible with the scan-compiled local phase's fixed-shape "
        "contract. Pad the arrays to a multiple of batch_size or use "
        "drop_remainder=True.")


def batch_iterator(arrays: Dict[str, np.ndarray], batch_size: int,
                   seed: int = 0, drop_remainder: bool = True, *,
                   device: DeviceLike = None
                   ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite shuffled batch stream over a dict of equal-length numpy
    arrays, yielded as tensors on `device` (the CUDA device by default).
    A ragged final batch (``drop_remainder=False`` with ``n % batch_size``)
    raises, as in the reference."""
    dev = resolve_device(device)
    n = len(next(iter(arrays.values())))
    if any(len(a) != n for a in arrays.values()):
        raise ValueError("batch_iterator: arrays differ in length")
    rng = np.random.default_rng(seed)
    bs = min(batch_size, n)
    if not drop_remainder and n % bs:
        raise _ragged_error(n, bs)
    while True:
        perm = rng.permutation(n)
        for s in range(0, n - bs + 1, bs):
            idx = perm[s:s + bs]
            yield {k: torch.from_numpy(a[idx]).to(dev)
                   for k, a in arrays.items()}


def image_batch(ds, idx=None) -> Dict[str, np.ndarray]:
    """A `SyntheticImageDataset`'s arrays as a batch dict, all of it or the
    rows `idx`."""
    if idx is None:
        return {"images": ds.images, "labels": ds.labels}
    return {"images": ds.images[idx], "labels": ds.labels[idx]}
