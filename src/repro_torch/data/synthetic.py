"""Synthetic data (port of ``repro/data/synthetic.py``):
class-conditional Gaussian images over low-frequency class means, for
label skew; four feature-shifted domains over the same classes, for
domain shift (the paper's PACS stand-in); a fleet client's shard by
client id; and Markov-chain token streams, one transition matrix a
domain, for the language-model clients. Pure numpy, bitwise equal to
the reference for the same seeds."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    images: np.ndarray   # (N, H, W, 3) float32
    labels: np.ndarray   # (N,) int32
    n_classes: int


@dataclasses.dataclass
class SyntheticTextDataset:
    tokens: np.ndarray   # (N, T+1) int32 — shifted for next-token prediction
    vocab: int


def _class_means(rng, n_classes, side=32, scale=1.0):
    """Low-frequency class-mean patterns (so conv nets can learn them)."""
    base = rng.normal(size=(n_classes, 8, 8, 3))
    means = np.repeat(np.repeat(base, side // 8, 1), side // 8, 2)
    return (scale * means).astype(np.float32)


def make_image_dataset(n_samples=20000, n_classes=10, side=32, noise=1.0,
                       seed=0, means_seed=0) -> SyntheticImageDataset:
    """`means_seed` fixes the class-conditional structure; `seed` draws the
    samples — so train/test splits share classes (use different `seed`)."""
    means = _class_means(np.random.default_rng(means_seed), n_classes, side)
    rng = np.random.default_rng(seed + 1000003 * means_seed + 1)
    labels = rng.integers(0, n_classes, size=n_samples).astype(np.int32)
    images = means[labels] + noise * rng.normal(
        size=(n_samples, side, side, 3)).astype(np.float32)
    return SyntheticImageDataset(images.astype(np.float32), labels, n_classes)


def make_fleet_client_dataset(client_id: int, n_samples=64, n_classes=10,
                              side=32, noise=2.5, label_beta=0.3, seed=0,
                              means_seed=0) -> SyntheticImageDataset:
    """One registered fleet client's local shard, a pure function of
    (client_id, seed): its label marginal is its own Dirichlet(label_beta)
    draw, its samples class means + noise under that marginal. A fleet
    never materializes as a whole — only a round's cohort — and a resumed
    sweep redraws the same bytes."""
    means = _class_means(np.random.default_rng(means_seed), n_classes, side)
    rng = np.random.default_rng((seed, 0xF1EE7, int(client_id)))
    marginal = rng.dirichlet(np.full(n_classes, label_beta))
    labels = rng.choice(n_classes, size=n_samples,
                        p=marginal).astype(np.int32)
    images = means[labels] + noise * rng.normal(
        size=(n_samples, side, side, 3)).astype(np.float32)
    return SyntheticImageDataset(images.astype(np.float32), labels,
                                 n_classes)


_DOMAIN_TRANSFORMS = ("photo", "art", "cartoon", "sketch")


def _full_domain_transform(images: np.ndarray, domain: str) -> np.ndarray:
    if domain == "photo":
        return images
    if domain == "art":                      # partial channel rotation + tint
        return 0.6 * images + 0.4 * images[..., [2, 0, 1]] + 0.3
    if domain == "cartoon":                  # quantize (flat regions)
        return np.round(images * 2.0) / 2.0
    if domain == "sketch":                   # desaturate toward grayscale
        g = images.mean(-1, keepdims=True)
        return 0.4 * images + 0.6 * np.repeat(g, 3, axis=-1)
    raise ValueError(domain)


def apply_domain(images: np.ndarray, domain: str,
                 severity: float = 1.0) -> np.ndarray:
    """Feature shift of `domain`, blended with the source images by
    `severity` (0.0 returns the source images unchanged, 1.0 the full
    transform)."""
    if severity == 0.0:
        return images
    shifted = _full_domain_transform(images, domain)
    if severity == 1.0:
        return shifted
    return (1.0 - severity) * images + severity * shifted


def make_domain_datasets(n_per_domain=4000, n_classes=10, side=32, noise=0.8,
                         seed=0, means_seed=0
                         ) -> Dict[str, SyntheticImageDataset]:
    """Four feature-skewed domains over shared classes (PACS analogue)."""
    means = _class_means(np.random.default_rng(means_seed), n_classes, side)
    rng = np.random.default_rng(seed + 1000003 * means_seed + 1)
    out = {}
    for d in _DOMAIN_TRANSFORMS:
        labels = rng.integers(0, n_classes, size=n_per_domain).astype(np.int32)
        imgs = means[labels] + noise * rng.normal(
            size=(n_per_domain, side, side, 3)).astype(np.float32)
        out[d] = SyntheticImageDataset(
            apply_domain(imgs, d).astype(np.float32), labels, n_classes)
    return out


def make_lm_dataset(n_seqs=2048, seq_len=256, vocab=1024, n_domains=1,
                    seed=0) -> List[SyntheticTextDataset]:
    """Markov-chain token streams; each domain gets its own transition
    matrix (feature shift for the LLM FL examples): a sparse row of 32
    successors a token, Dirichlet(0.5) weights. Two calls with different
    seeds share no transition matrix, so a held-out set that is to
    measure what training learned comes from the training domains' own
    streams (sequences set aside), not from another seed."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_domains):
        trans = rng.dirichlet(np.full(32, 0.5), size=vocab)
        cols = rng.integers(0, vocab, size=(vocab, 32))
        seqs = np.empty((n_seqs // n_domains, seq_len + 1), np.int32)
        state = rng.integers(0, vocab, size=n_seqs // n_domains)
        seqs[:, 0] = state
        for t in range(1, seq_len + 1):
            choice = (rng.random(state.shape[0])[:, None] <
                      np.cumsum(trans[state], -1)).argmax(-1)
            state = cols[state, choice].astype(np.int32)
            seqs[:, t] = state
        out.append(SyntheticTextDataset(seqs, vocab))
    return out
