"""Synthetic label-skew image data (port of ``repro/data/synthetic.py``):
class-conditional Gaussian images over low-frequency class means. Pure
numpy, bitwise equal to the reference for the same seeds."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    images: np.ndarray   # (N, H, W, 3) float32
    labels: np.ndarray   # (N,) int32
    n_classes: int


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
