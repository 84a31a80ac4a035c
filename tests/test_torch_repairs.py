"""Two repairs of the port, on the CPU.

* SGD on bf16 leaves: `optim.sgd` (the route of `kernels.local_step.
  sgd_update_tree`) on bf16 and on mixed f32/bf16 leaves is bitwise the
  JAX package's jitted `sgd_update_tree` (f32 arithmetic, a bf16 store),
  and `sgd_plan` lays mixed leaves into one launch as it lays f32 ones.
* The factor Gram beyond M = 256 rows: `gram_tiling` covers a tall
  stack's upper triangle of tile pairs exactly once, with tiles the
  kernel takes; `gram_substacks` / `gram_launches` put every stack of a
  call, tiled or whole, into one launch while `GRAM_MAX_STACKS` allows;
  `tiled_grams` puts the blocks back together with a bitwise mirror and
  agrees with `ref.factor_gram_ref` within phase 10's bounds; and
  `lowrank_pairwise_sq`'s CPU route at M = 320 (a pool of 5 at rank 64)
  agrees with the JAX package's."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import distances as JD
from repro.core.pool import LowRankDeltaPool as JaxLowRankPool
from repro.kernels.local_step import sgd_update_tree as jax_sgd_update_tree
from repro_torch.convert import from_jax_pool
from repro_torch.core import distances as TD
from repro_torch.kernels import local_step as TL
from repro_torch.kernels import pool_distance as TPD
from repro_torch.kernels.ref import factor_gram_ref
from repro_torch.optim import optimizers as TO

torch.set_num_threads(2)

LR, WD = 1e-2, 1e-4
SHAPES = {"c1.w": (3, 3, 3, 8), "c1.b": (8,), "fc.w": (128, 16),
          "fc.b": (16,), "odd": (1001,)}


def _leaves(rng, dtypes):
    return {k: rng.normal(0, 0.5, s).astype(dtypes[k])
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v).view(np.uint16)).view(
                torch.bfloat16)
            if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


BF16 = {k: ml_dtypes.bfloat16 for k in SHAPES}
MIXED = {k: ml_dtypes.bfloat16 if i % 2 else np.float32
         for i, k in enumerate(SHAPES)}


@pytest.mark.parametrize("dtypes", [BF16, MIXED], ids=["bf16", "mixed"])
@pytest.mark.parametrize("wd", [0.0, WD])
def test_sgd_on_bf16_leaves_bitwise_to_reference(dtypes, wd):
    rng = np.random.default_rng(1)
    p, g = _leaves(rng, dtypes), _leaves(rng, dtypes)
    update = jax.jit(functools.partial(jax_sgd_update_tree, lr=LR, wd=wd))
    want = update({k: jnp.asarray(v) for k, v in p.items()},
                  {k: jnp.asarray(v) for k, v in g.items()})
    got = TO.sgd(LR, weight_decay=wd).update(_torch(p), _torch(g), (), 0)[0]
    for k in SHAPES:
        w = np.asarray(want[k])
        assert got[k].dtype == (torch.bfloat16 if w.dtype ==
                                ml_dtypes.bfloat16 else torch.float32), k
        wt = _torch({k: w})[k]
        assert np.array_equal(_bits(got[k]), _bits(wt)), k


def test_sgd_plan_takes_mixed_leaves_in_one_launch():
    """The plan is a function of the leaves' element counts, whatever their
    dtypes: the mixed set's five leaves make one table, one launch."""
    sizes = tuple(int(np.prod(s)) for s in SHAPES.values())
    plans = TL.sgd_plan(sizes)
    assert len(plans) == 1 and plans[0].leaves == tuple(range(len(sizes)))
    assert set(TL.SGD_DTYPES) == {torch.float32, torch.bfloat16}


# ---------------------------------------------------------------------------
# the Gram beyond MAX_M rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [257, 300, 320, 384, 512, 777, 1024])
def test_tiling_covers_the_triangle_once(m):
    t = TPD.gram_tiling(m)
    assert t.tiles[0][0] == 0 and t.tiles[-1][1] == m
    assert all(a[1] == b[0] for a, b in zip(t.tiles, t.tiles[1:]))
    assert all(0 < hi - lo <= TPD.GRAM_TILE_ROWS for lo, hi in t.tiles)
    n = len(t.tiles)
    assert sorted(t.pairs) == [(i, j) for i in range(n)
                               for j in range(i + 1, n)]
    assert all(rows <= TPD.MAX_M for _, _, (_, rows, _) in
               TPD.gram_substacks([(1, m, 10)]))
    # every element (r, c), r ≤ c, read from exactly one sub-stack's Gram
    tile_of = np.repeat(np.arange(n), [hi - lo for lo, hi in t.tiles])
    owner = {}
    for p, (i, j) in enumerate(t.pairs):
        owner[(i, j)] = owner.get((i, j), 0) + 1
        for d in (i, j):
            if t.diag[d] == p:
                owner[(d, d)] = owner.get((d, d), 0) + 1
    for r in range(0, m, 7):
        for c in range(r, m, 5):
            key = (tile_of[r], tile_of[c])
            assert owner[key] == 1, (r, c)


def test_gram_kernel_plan_still_refuses_tall_stacks():
    """The kernel's own plan stays at M ≤ MAX_M; taller stacks reach it
    only as tiles."""
    with pytest.raises(ValueError, match="gram_plan"):
        TPD.gram_plan(((1, TPD.MAX_M + 1, 5),))
    with pytest.raises(ValueError, match="needs no tiles"):
        TPD.gram_tiling(TPD.MAX_M)
    for _, _, shape in TPD.gram_substacks([(2, 320, 64), (1, 40, 9)]):
        TPD.gram_plan((shape,))


@pytest.mark.parametrize("shapes,launches", [
    ([(1, 320, 100)], 1),                              # 3 tile pairs
    ([(1, 512, 100)] * 5 + [(16, 40, 9)] * 2, 1),      # 30 + 2 sub-stacks
    ([(1, 512, 100)] * 5 + [(16, 40, 9)] * 3, 2),      # 33
    ([(1, 1024, 10)], 1),                              # 8 tiles: 28 pairs
    ([(1, 40, 9)] * 33, 2)])
def test_launches_counted(shapes, launches):
    subs = TPD.gram_substacks(shapes)
    assert TPD.gram_launches(shapes) == launches == \
        -(-len(subs) // TPD.GRAM_MAX_STACKS)
    assert [i for i, _, _ in subs] == sorted(i for i, _, _ in subs)


def _within_phase10_bounds(a, got):
    want = factor_gram_ref(torch.from_numpy(a)).double().numpy()
    aa = np.abs(a.astype(np.float64))
    bound = a.shape[-1] * 2.0 ** -23 * np.einsum("bmp,bnp->bmn", aa, aa)
    err = np.abs(got.astype(np.float64) - want)
    return (bool(np.all(err <= bound)),
            float(np.linalg.norm(err) / np.linalg.norm(want)))


@pytest.mark.parametrize("shape", [(1, 257, 300), (2, 320, 777),
                                   (1, 512, 1000), (3, 40, 50)])
def test_tiled_grams_within_phase10_bounds(shape):
    a = np.random.default_rng(sum(shape)).normal(
        0, 0.05, shape).astype(np.float32)
    calls = []

    def gram_fn(subs):
        calls.append([tuple(s.shape) for s in subs])
        return [factor_gram_ref(s) for s in subs]

    out = TPD.tiled_grams([torch.from_numpy(a)], gram_fn)[0]
    assert len(calls) == 1
    assert all(s[1] <= TPD.MAX_M for s in calls[0])
    assert torch.equal(out, out.transpose(1, 2))
    within, rel = _within_phase10_bounds(a, out.numpy())
    assert within and rel <= 1e-5


@pytest.fixture(scope="module")
def rank64_pool():
    """A low-rank pool of 5 members at rank 64 over a (96, 80) matrix leaf
    (C·r = 320 rows), a lead-axis leaf and a vector leaf."""
    rng = np.random.default_rng(21)
    base = {"w": rng.normal(size=(96, 80)).astype(np.float32),
            "layers": rng.normal(size=(2, 72, 66)).astype(np.float32),
            "b": rng.normal(size=(80,)).astype(np.float32)}
    jpool = JaxLowRankPool.create({k: jnp.asarray(v) for k, v in
                                   base.items()}, capacity=5, rank=64)
    for s in range(1, 5):
        jpool = jpool.append({k: jnp.asarray(
            v + 0.1 * np.random.default_rng(s).normal(size=v.shape)
            .astype(np.float32)) for k, v in base.items()})
    return jpool


def test_pairwise_distances_at_m320_match_reference(rank64_pool):
    tpool = from_jax_pool(rank64_pool, "cpu")
    assert max(5 * u.shape[-1] for u in tpool.u.values()) == 320
    want = np.asarray(JD.lowrank_pairwise_sq(rank64_pool))
    tol = dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(TD.lowrank_pairwise_sq(tpool).numpy(), want,
                               **tol)

    def tiled(a):
        return TPD.tiled_grams(
            [a], lambda subs: [factor_gram_ref(s) for s in subs])[0]
    np.testing.assert_allclose(
        TD.lowrank_pairwise_sq(tpool, gram_fn=tiled).numpy(), want, **tol)
