"""Public wrappers of the port's kernels, under the reference's names and
arguments (port of ``repro/kernels/ops.py``). Each routes by its tensors'
device: the hand-written kernel on CUDA, its plain version on the CPU.
Tile arguments of the Pallas kernels that the port's kernels do not take
(`bq`, `bk`) accept only the reference's default and raise otherwise.
The model-level routes are imported where they are called: the models
import this package."""
from __future__ import annotations

import torch

from repro_torch.kernels import bgmv as _bgmv
from repro_torch.kernels.local_step import (conv2d_gemm, maxpool2x2,
                                            sgd_update_tree)
from repro_torch.kernels.pool_distance import (distances_from_stats,
                                               factor_gram,
                                               pool_distance_stats,
                                               tree_pool_distance_stats)

_ATTN_TILE = 128        # the reference's default bq and bk


def flash_attention(q, k, v, *, causal=True, window=0, bq=_ATTN_TILE,
                    bk=_ATTN_TILE):
    """Causal / sliding-window GQA attention, q (B, Tq, H, hd), k and v
    (B, Tk, KV, hd). CUDA: the flash-attention kernel (its own tiles);
    CPU: the chunked formulation."""
    if bq != _ATTN_TILE or bk != _ATTN_TILE:
        raise ValueError(f"flash_attention: the port's kernel sets its own "
                         f"tiles; bq and bk take only {_ATTN_TILE}, got "
                         f"{bq} and {bk}")
    from repro_torch.models.layers import flash_attention as attention
    return attention(q, k, v, causal=causal, window=window)


def pool_distances(w_flat, pool_flat, *, measure="l2"):
    """Fused per-member distances (the FedELMY d1/d2 hot path). Accepts a
    single run — w (P,), pool (C, P) → (C,) — or a stack of runs — w
    (B, P), pool (B, C, P) → (B, C) in one sweep."""
    stats = pool_distance_stats(w_flat, pool_flat)
    w_sq = w_flat.float().square().sum(-1)
    return distances_from_stats(stats, w_sq, measure)


def factor_grams(a):
    """A·Aᵀ over the trailing axis ((…, M, P) → (…, M, M)), the Gram
    building block of the factor-form pool statistics."""
    return factor_gram(a)


def lowrank_pool_sq(pool):
    """Pairwise ‖m_i − m_j‖² (C, C) of a `LowRankDeltaPool` through the
    factor Gram (every stack in one launch on CUDA), never materializing
    a member's delta."""
    from repro_torch.core.distances import lowrank_pairwise_sq
    return lowrank_pairwise_sq(pool)


def tree_pool_distances(params, pool_members, *, measure="l2"):
    """Name → tensor front-end: the model's leaves against a stacked pool
    (name → (C, *shape)), read in place by one sweep."""
    stats, w_sq = tree_pool_distance_stats(params, pool_members)
    return distances_from_stats(stats, w_sq, measure)


def gla_chunked(q, k, v, log_decay, *, chunk: int, pre=False, bonus=None,
                initial_state=None):
    """Chunked gated linear attention, the reference's layouts: q, k
    (B, T, H, K); v (B, T, H, V); log_decay (B, T, H[, K]); T a multiple
    of `chunk`. `pre` reads the state before the current token, plus the
    current-token `bonus` (H, K) when given; without `pre` the bonus is
    not read, as in the reference."""
    if q.shape[1] % chunk:
        raise ValueError(f"gla_chunked: T = {q.shape[1]} is not a multiple "
                         f"of chunk = {chunk}")
    from repro_torch.models.ssm import gla_chunked as chunked
    if not pre:
        bonus = None
    elif bonus is None:
        bonus = torch.zeros(q.shape[2:], dtype=torch.float32,
                            device=q.device)
    return chunked(q, k, v, log_decay, chunk=chunk, bonus=bonus,
                   initial_state=initial_state)


def bgmv(x, u, v):
    """Batched low-rank serving correction y_s = (x_s·u_s)·v_sᵀ over the
    pool-member axis; x (S, N, d_in) or shared (N, d_in), u (S, d_in, r),
    v (S, d_out, r) → (S, N, d_out) f32."""
    return _bgmv.bgmv(x, u, v)


def fused_conv2d(x, w, b):
    """SAME stride-1 NHWC conv as im2col + GEMM, forward and backward
    through the GEMM."""
    return conv2d_gemm(x, w, b)


def fused_maxpool2x2(x):
    """Non-overlapping 2×2 max pool (reshape + max; the gradient splits
    over ties)."""
    return maxpool2x2(x)


def fused_sgd(params, grads, *, lr, wd=0.0):
    """SGD update p ← p − lr·(g + wd·p) of every leaf: one sweep over all
    leaves on CUDA, per leaf on the CPU; both bitwise to `optimizers.sgd`'s
    rule."""
    return sgd_update_tree(params, grads, lr=lr, wd=wd)
