"""The parts of `jax.random` the port must reproduce bit for bit (port of
``jax/_src/prng.py`` and ``jax/_src/random.py`` as jax 0.9 computes them,
with the partitionable threefry layout that is jax's default there).

The low-rank pool's range-finder draws its projection Ω from
``normal(fold_in(PRNGKey(seed), leaf_idx), shape)``; an append below full
rank agrees with the reference's only with the same Ω. Everything here is
numpy uint32 arithmetic, which wraps as the hash requires:

* `threefry2x32` — the Threefry-2x32 hash, 20 rounds, on arrays of
  counters;
* `prng_key`, `fold_in` — raw (2,) uint32 keys as `jax.random.PRNGKey`
  and `jax.random.fold_in` build them;
* `random_bits` — 32-bit words: the hash of the (hi, lo) halves of a
  64-bit iota over the output shape, the two results xor-ed;
* `uniform`, `normal` — f32 samples; `normal` is √2·erfinv(u) on
  u ~ U(nextafter(−1, 0), 1). The bits and the uniforms are exact.
  erfinv is XLA's single-precision polynomial (Giles' approximation,
  XLA's ``ErfInv32``) with its steps rounded as XLA's CPU code rounds
  them (fused multiply-adds); only ``log1p`` is numpy's, so a normal may
  differ from jax's in its last bits (tests/test_torch_lowrank.py states
  the bound).
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np

U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = U32(0x1BD11BDA)


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << U32(d)) | (x >> U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash of counter pairs (x0, x1) under `key`
    ((2,) uint32); returns the two hashed uint32 arrays."""
    k0, k1 = U32(key[0]), U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, U32) + ks[0], np.asarray(x1, U32) + ks[1]]
        for i in range(5):
            for rot in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], rot) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` for a 32-bit seed: [0, seed]."""
    return np.array([0, seed & 0xFFFFFFFF], U32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: the hash of the counter pair
    (0, data) is the new key."""
    y0, y1 = threefry2x32(key, np.array([0], U32),
                          np.array([data & 0xFFFFFFFF], U32))
    return np.array([y0[0], y1[0]], U32)


def random_bits(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.bits(key, shape, uint32)` (partitionable layout)."""
    n = math.prod(shape)
    iota = np.arange(n, dtype=np.uint64)
    hi = (iota >> np.uint64(32)).astype(U32)
    lo = (iota & np.uint64(0xFFFFFFFF)).astype(U32)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(tuple(shape))


def uniform(key: np.ndarray, shape: Sequence[int], minval: float,
            maxval: float) -> np.ndarray:
    """`jax.random.uniform` in f32: 23 random mantissa bits under the
    exponent of 1.0, shifted into [minval, maxval)."""
    bits = random_bits(key, shape)
    floats = ((bits >> U32(9)) | U32(0x3F800000)).view(np.float32)
    floats = floats - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, floats * (hi - lo) + lo)


# Giles' single-precision erfinv coefficients (w < 5 and w >= 5 branches)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 erfinv on |x| < 1. Each Horner step c + p·w is one
    rounding (p·w is exact in f64, so f64 add then f32 round is the
    fused multiply-add up to a rare double rounding)."""
    f32, f64 = np.float32, np.float64
    x = np.asarray(x, f32)
    w = (-np.log1p(-(x * x).astype(f64))).astype(f32)
    small = w < f32(5.0)
    w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0)).astype(f32)
    p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
    for a, b in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = np.where(small, f32(a), f32(b)).astype(f64)
        p = (c + p.astype(f64) * w.astype(f64)).astype(f32)
    return (p * x).astype(f32)


def normal(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """`jax.random.normal` in f32 (see the module docstring for its last
    bits)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return (np.float32(math.sqrt(2)) * erfinv_f32(u)).astype(np.float32)
