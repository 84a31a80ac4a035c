"""Non-IID client partitioners (port of ``repro/data/partition.py``).
Pure numpy, bitwise equal to the reference:

dirichlet_partition:     label skew — per-class Dirichlet(beta)
                         allocation over clients.
shard_partition:         pathological label skew — sort-by-label shards,
                         k classes per client.
quantity_skew_partition: Dirichlet(beta) over per-client sample counts.
mixed_skew_partition:    label × quantity skew jointly.
domain_shift_partition:  one domain per client, round-robin.
feature_shift_partition: an even split of one dataset with per-client
                         domain transforms of increasing strength.

Every index partitioner returns per-client sorted index arrays that
cover the input exactly once and enforces a per-client `min_size`."""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset, apply_domain

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


def shard_partition(labels: np.ndarray, n_clients: int,
                    classes_per_client: int = 2,
                    seed: int = 0, min_size: int = 1) -> List[np.ndarray]:
    """Pathological label skew: sort indices by label, cut into
    ``n_clients * classes_per_client`` contiguous shards, deal each client
    `classes_per_client` shards at random."""
    n = len(labels)
    n_shards = n_clients * classes_per_client
    if n_shards > n:
        raise ValueError(
            f"shard_partition: {n_shards} shards "
            f"({n_clients} clients × {classes_per_client} classes) is "
            f"unsatisfiable with {n} samples")
    _check_feasible(n, n_clients, min_size, "shard_partition")
    rng = np.random.default_rng(seed)
    pre = rng.permutation(n)
    by_label = pre[np.argsort(labels[pre], kind="stable")]
    shards = np.array_split(by_label, n_shards)
    shard_order = rng.permutation(n_shards)
    parts = [np.sort(np.concatenate(
                [shards[s] for s in shard_order[i * classes_per_client:
                                                (i + 1) * classes_per_client]]
             ).astype(np.int64))
             for i in range(n_clients)]
    if min(len(p) for p in parts) < min_size:
        raise ValueError(
            f"shard_partition: min_size={min_size} is unsatisfiable with "
            f"{n_shards} shards over {n} samples; lower min_size or "
            f"classes_per_client")
    return parts


def quantity_skew_partition(labels: np.ndarray, n_clients: int,
                            beta: float = 0.5, seed: int = 0,
                            min_size: int = 2) -> List[np.ndarray]:
    """Quantity skew: per-client dataset sizes follow Dirichlet(beta)
    while label marginals stay ~uniform (samples dealt from one global
    shuffle)."""
    n = len(labels)
    _check_feasible(n, n_clients, min_size, "quantity_skew_partition")
    for attempt in range(MAX_RETRIES):
        rng = np.random.default_rng(seed + attempt)
        perm = rng.permutation(n)
        props = rng.dirichlet(np.full(n_clients, beta))
        cuts = (np.cumsum(props) * n).astype(int)[:-1]
        parts = np.split(perm, cuts)
        if min(len(p) for p in parts) >= min_size:
            return [np.sort(p.astype(np.int64)) for p in parts]
    raise _retries_exhausted("quantity_skew_partition", min_size)


def mixed_skew_partition(labels: np.ndarray, n_clients: int,
                         beta_label: float = 0.3, beta_quantity: float = 0.5,
                         seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    """Label × quantity skew: per-class Dirichlet(beta_label) proportions
    re-weighted by a per-client Dirichlet(beta_quantity) size budget."""
    n = len(labels)
    _check_feasible(n, n_clients, min_size, "mixed_skew_partition")
    n_classes = int(labels.max()) + 1
    for attempt in range(MAX_RETRIES):
        rng = np.random.default_rng(seed + attempt)
        budget = rng.dirichlet(np.full(n_clients, beta_quantity))
        idx_per_client = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, beta_label)) * budget
            props = props / props.sum()
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].append(part)
        parts = [np.concatenate(p) if p else np.empty(0, np.int64)
                 for p in idx_per_client]
        if min(len(p) for p in parts) >= min_size:
            return [np.sort(p) for p in parts]
    raise _retries_exhausted("mixed_skew_partition", min_size)


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


def severity_ladder(n_clients: int, max_severity: float = 1.0,
                    ) -> List[float]:
    """Per-client transform strengths, 0 → max_severity linearly (client 0
    keeps the source distribution)."""
    if n_clients == 1:
        return [max_severity]
    return [max_severity * i / (n_clients - 1) for i in range(n_clients)]


def feature_shift_partition(dataset: SyntheticImageDataset, n_clients: int,
                            max_severity: float = 1.0,
                            domains: Sequence[str] = ("art", "cartoon",
                                                      "sketch"),
                            seed: int = 0,
                            severities: Optional[Sequence[float]] = None,
                            ) -> List[SyntheticImageDataset]:
    """Feature-shift severity ladder: split one dataset evenly (a disjoint
    permutation split), then give client i domain ``domains[i %
    len(domains)]`` at severity ``severities[i]`` (default: a linear 0 →
    max_severity ramp)."""
    rng = np.random.default_rng(seed)
    n = len(dataset.labels)
    _check_feasible(n, n_clients, 1, "feature_shift_partition")
    sev = (list(severities) if severities is not None
           else severity_ladder(n_clients, max_severity))
    if len(sev) != n_clients:
        raise ValueError(f"severities has {len(sev)} entries for "
                         f"{n_clients} clients")
    parts = np.array_split(rng.permutation(n), n_clients)
    out = []
    for i, p in enumerate(parts):
        imgs = apply_domain(dataset.images[p], domains[i % len(domains)],
                            severity=sev[i])
        out.append(SyntheticImageDataset(imgs.astype(np.float32),
                                         dataset.labels[p],
                                         dataset.n_classes))
    return out


def train_val_split(n: int, val_frac: float = 0.1, seed: int = 0):
    """The paper's 90% train / 10% validation split of n samples:
    (train indices, validation indices)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    return perm[n_val:], perm[:n_val]
