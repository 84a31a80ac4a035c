"""The pool-distance sweep's backward for bf16 leaves
(`kernels/pool_distance.py`, `csrc/pool_distance_f32.cu`).

On the card the backward kernel reads bf16 w and members, sums ∂w in f32
and rounds it once to bf16; its CPU route is the f32 plain backward
(`ref.pool_distance_stats_bwd_ref`) rounded once to the leaves' dtype.
Here, on the CPU, bf16 leaves under grad through
`tree_pool_distance_stats` (the autograd Function the Eq. 9 step and the
train step use) give exactly that: ∂w bit for bit the f32 plain
backward of the widened leaves, rounded once, at C = 1 (the one-member
sweep of d2), 4 and 6 (stacked pools with empty slots, whose ḡ is 0 as
d1's mask gives it). The kernel itself runs only on the card
(`chip_smoke.py` phases 15 and 25)."""
import numpy as np
import pytest
import torch

from repro_torch.core import distances as D
from repro_torch.core.pool import ModelPool
from repro_torch.kernels import pool_distance as PD
from repro_torch.kernels.ref import pool_distance_stats_bwd_ref

torch.set_num_threads(2)

# ragged leaves: a vector, a matrix, a 3-d stack, a scalar-like leaf
SHAPES = {"b": (7,), "w": (13, 9), "layers.w": (2, 5, 11), "s": (1,)}


def _leaves(rng, scale=1.0):
    return {k: torch.from_numpy(scale * rng.standard_normal(s).astype(
        np.float32)).bfloat16() for k, s in SHAPES.items()}


def _pool(rng, capacity, count):
    pool = ModelPool.create(_leaves(rng), capacity)
    for _ in range(count - 1):
        pool = pool.append(_leaves(rng))
    return pool


def _grads_through_sweep(params, members, g_stats, g_wsq):
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    stats, wsq = PD.tree_pool_distance_stats(leaves, members)
    total = sum((g_stats[i] * stats[k]).sum()
                for i, k in enumerate(PD.STATS)) + g_wsq * wsq
    return dict(zip(leaves, torch.autograd.grad(total, list(
        leaves.values()))))


@pytest.mark.parametrize("capacity,count", [(1, 1), (4, 3), (6, 3)])
def test_bf16_backward_is_f32_plain_rounded_once(capacity, count):
    rng = np.random.default_rng(capacity)
    params = _leaves(rng)
    pool = _pool(rng, capacity, count)
    mask = pool.mask()
    g_stats = torch.from_numpy(rng.standard_normal(
        (4, capacity)).astype(np.float32)) * mask
    g_wsq = torch.tensor(float(rng.standard_normal()))
    grads = _grads_through_sweep(params, pool.members, g_stats, g_wsq)
    for k, w in params.items():
        want = pool_distance_stats_bwd_ref(
            w.float().reshape(-1), pool.members[k].float().reshape(
                capacity, -1), g_stats[0], g_stats[1], g_stats[2],
            g_wsq=g_wsq).to(torch.bfloat16).reshape(w.shape)
        assert grads[k].dtype == torch.bfloat16
        assert torch.equal(grads[k], want), k


def test_bf16_eq9_distances_through_the_sweep_route():
    """d1 and d2 of a bf16 stacked pool through `d1_d2_pool_sweep` (the
    CUDA route, here on CPU tensors) and d2 alone through the one-member
    `d2_anchor_sweep`: bf16 gradients equal to the plain backward of
    their ḡ, rounded once."""
    rng = np.random.default_rng(9)
    params = _leaves(rng)
    pool = _pool(rng, 4, 3)
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    d1, d2 = D.d1_d2_pool_sweep(leaves, pool, "l2")
    (-0.06 * d1 + d2).backward()
    dist = {}
    for i in range(4):
        sq = sum(float(((params[k].double() - pool.members[k][i].double())
                        ** 2).sum()) for k in params)
        dist[i] = np.sqrt(sq + 1e-12)
    count = float(pool.count)
    g_sq = torch.tensor([(-0.06 / count * float(pool.mask()[i]) +
                          (1.0 if i == 0 else 0.0)) / (2 * dist[i])
                         for i in range(4)], dtype=torch.float64)
    for k, w in params.items():
        want = pool_distance_stats_bwd_ref(
            w.float().reshape(-1), pool.members[k].float().reshape(4, -1),
            g_sq.float(), torch.zeros(4), torch.zeros(4))
        got = leaves[k].grad.float().reshape(-1)
        # ḡ here is formed in f64, autograd's in f32: one bf16 rounding
        tol = 2.0 ** -8 * want.abs() + 1e-6 * float(want.abs().max())
        assert leaves[k].grad.dtype == torch.bfloat16
        assert bool(((got - want).abs() <= tol).all()), k
    anchor = pool.first()
    leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    D.d2_anchor_sweep(leaves, anchor, "l2").backward()
    d = np.sqrt(sum(float(((params[k].double() - anchor[k].double()) ** 2)
                          .sum()) for k in params) + 1e-12)
    for k, w in params.items():
        want = pool_distance_stats_bwd_ref(
            w.float().reshape(-1), anchor[k].float().reshape(1, -1),
            torch.tensor([1.0 / (2 * d)]), torch.zeros(1),
            torch.zeros(1)).to(torch.bfloat16)
        got = leaves[k].grad.reshape(-1)
        assert got.dtype == torch.bfloat16
        assert bool(((got.float() - want.float()).abs() <=
                     2.0 ** -7 * want.float().abs() + 1e-30).all()), k


def test_backward_launcher_takes_bf16_leaves():
    """The backward launcher no longer refuses bf16 leaves: a bf16 table
    on the CPU fails only its device check (it launches nothing), and a
    vmapped one is refused as every launcher refuses it."""
    w = torch.ones(1, 8, dtype=torch.bfloat16)
    m = torch.ones(1, 2, 8, dtype=torch.bfloat16)
    g = torch.zeros(1, 4, 2)
    before = PD.pool_distance_bwd_f32.launches
    with pytest.raises(ValueError, match="on cpu"):
        PD.pool_distance_bwd_f32([w], [m], g, torch.zeros(1))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        torch.func.vmap(lambda x: PD.pool_distance_bwd_f32(
            [x], [m], g, torch.zeros(1)))(w[None])
    assert PD.pool_distance_bwd_f32.launches == before


@pytest.mark.parametrize("capacity,count", [(1, 1), (4, 3)])
def test_mixed_dtype_table_takes_one_launch_a_dtype(monkeypatch, capacity,
                                                    count):
    """A bf16 SSM model keeps some leaves in f32 (A_log, dt_bias, D;
    w_decay_base, bonus_u), and the sweep's kernels read one leaf dtype a
    launch: on the CUDA route `PoolStatsFunction` splits such a table by
    dtype, one forward and one backward launch each, the stats summed.
    With the route forced on CPU tensors (the launchers replaced by
    plain stand-ins that refuse a mixed table), stats and ∂w match the
    per-leaf plain route."""
    rng = np.random.default_rng(29 + capacity)
    f32 = {"A_log", "s"}

    def mixed(scale=1.0):
        return {k: (v.float() if k in f32 else v)
                for k, v in _leaves(rng, scale).items()} | {
            "A_log": torch.from_numpy(rng.standard_normal(3).astype(
                np.float32))}
    params = mixed()
    pool = ModelPool.create(mixed(), capacity)
    for _ in range(count - 1):
        pool = pool.append(mixed())
    g_stats = torch.from_numpy(rng.standard_normal(
        (4, capacity)).astype(np.float32)) * pool.mask()
    g_wsq = torch.tensor(float(rng.standard_normal()))
    want_stats = PD.tree_pool_distance_stats(params, pool.members)
    want = _grads_through_sweep(params, pool.members, g_stats, g_wsq)

    calls = {"forward": [], "backward": []}

    def one_dtype(ws, what):
        dtypes = {w.dtype for w in ws}
        assert len(dtypes) == 1, f"{what}: a launch over {dtypes}"
        calls[what].append(dtypes.pop())

    def forward(ws, ms):
        one_dtype(ws, "forward")
        parts = [PD.pool_distance_stats_ref(x, m) for x, m in zip(ws, ms)]
        return (torch.stack([sum(p[k] for p in parts) for k in PD.STATS],
                            dim=1),
                sum(x.float().square().sum(-1) for x in ws))

    def backward(ws, ms, gs, gw):
        one_dtype(ws, "backward")
        return [pool_distance_stats_bwd_ref(x, m, gs[:, 0], gs[:, 1],
                                            gs[:, 2], g_wsq=gw)
                for x, m in zip(ws, ms)]
    monkeypatch.setattr(PD, "_device_type", lambda *a: "cuda")
    monkeypatch.setattr(PD, "pool_distance_f32", forward)
    monkeypatch.setattr(PD, "pool_distance_bwd_f32", backward)
    stats, wsq = PD.tree_pool_distance_stats(params, pool.members)
    got = _grads_through_sweep(params, pool.members, g_stats, g_wsq)
    # the leaves' order puts a bf16 leaf first, then f32
    assert calls["forward"] == [torch.bfloat16, torch.float32] * 2
    assert calls["backward"] == [torch.bfloat16, torch.float32]
    for k in PD.STATS:
        torch.testing.assert_close(stats[k], want_stats[0][k], rtol=1e-6,
                                   atol=1e-6)
    torch.testing.assert_close(wsq, want_stats[1], rtol=1e-6, atol=1e-6)
    for k, g in want.items():
        assert got[k].dtype == params[k].dtype
        torch.testing.assert_close(got[k].float(), g.float(), rtol=1e-6,
                                   atol=1e-6)
