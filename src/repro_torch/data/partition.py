"""Client partitioning (port of ``dirichlet_partition`` and
``domain_shift_partition`` from ``repro/data/partition.py``). Pure numpy,
bitwise equal to the reference."""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset

# Bounded resampling for the min_size constraint: an unsatisfiable request
# raises instead of spinning forever.
MAX_RETRIES = 100


def _check_feasible(n_samples: int, n_clients: int, min_size: int,
                    what: str) -> None:
    if n_clients < 1:
        raise ValueError(f"{what}: n_clients must be >= 1, got {n_clients}")
    if n_clients * min_size > n_samples:
        raise ValueError(
            f"{what}: min_size={min_size} is unsatisfiable — "
            f"{n_clients} clients need at least {n_clients * min_size} "
            f"samples, got {n_samples}")


def _retries_exhausted(what: str, min_size: int) -> ValueError:
    return ValueError(
        f"{what}: could not satisfy min_size={min_size} after "
        f"{MAX_RETRIES} resampling attempts; lower min_size, raise beta, "
        f"or reduce n_clients")


def dirichlet_partition(labels: np.ndarray, n_clients: int, beta: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Per-class Dirichlet(beta) allocation over clients; returns sorted
    per-client index arrays, every sample assigned exactly once."""
    _check_feasible(len(labels), n_clients, min_size, "dirichlet_partition")
    n_classes = int(labels.max()) + 1
    for attempt in range(MAX_RETRIES):
        rng = np.random.default_rng(seed + attempt)
        idx_per_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, beta))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].append(part)
        parts = [np.concatenate(p) if p else np.empty(0, np.int64)
                 for p in idx_per_client]
        if min(len(p) for p in parts) >= min_size:
            return [np.sort(p) for p in parts]
    raise _retries_exhausted("dirichlet_partition", min_size)


def domain_shift_partition(domains: Dict[str, SyntheticImageDataset],
                           n_clients: int,
                           order: Sequence[str] = ("photo", "art", "cartoon",
                                                   "sketch"),
                           seed: int = 0) -> List[SyntheticImageDataset]:
    """One (sub-)domain per client, round-robin in `order` (paper Table 6).
    Within a domain the split is disjoint (a permutation split). The
    domains draw their permutations in the iteration order of a set of
    their names, as the reference does, so the draw follows the process's
    string hashing: equal to the reference within one process."""
    rng = np.random.default_rng(seed)
    n_dom = len(order)
    reps = [order[i % n_dom] for i in range(n_clients)]
    counts = {d: reps.count(d) for d in set(reps)}
    splits: Dict[str, List[np.ndarray]] = {}
    for d, k in counts.items():
        n = len(domains[d].labels)
        perm = rng.permutation(n)
        splits[d] = np.array_split(perm, k)
    taken = {d: 0 for d in counts}
    out = []
    for d in reps:
        idx = splits[d][taken[d]]
        taken[d] += 1
        ds = domains[d]
        out.append(SyntheticImageDataset(ds.images[idx], ds.labels[idx],
                                         ds.n_classes))
    return out
