"""The f32 GEMM kernel's plan (`repro_torch.kernels.local_step.gemm_plan`)
and the summation order it gives ``csrc/gemm_f32.cu``, on the CPU.

The kernel itself runs only on the card (chip_smoke.py phase 3 holds it
against its plain version there). What is checked here is the plan —
block tile, split-K slices, grid and workspace — and, by a plain f32
emulation of the kernel's three-level summation (FMA within each 128-wide
chunk of K, chunks added in order within a slice, slices added in index
order), that the order the plan gives meets phase 3's two tolerances
against the reference's Pallas GEMM (interpret mode) and the f64 product:
elementwise K·2⁻²³·(|A|·|B|), the worst-case difference of two f32 sums of
K products in different orders, and 1e-5 normwise against f64."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import local_step as JL
from repro_torch.kernels import local_step as TL

torch.set_num_threads(2)

# the paper CNN's products at batch 64, (M, K, N) of op(A) @ op(B):
# forward, dA = G·Bᵀ and dB = Aᵀ·G of its three convs
CNN_PRODUCTS = {
    "c1.fwd": (65536, 27, 64), "c1.dB": (27, 65536, 64),
    "c2.fwd": (16384, 576, 128), "c2.dA": (16384, 128, 576),
    "c2.dB": (576, 16384, 128),
    "c3.fwd": (4096, 1152, 256), "c3.dA": (4096, 256, 1152),
    "c3.dB": (1152, 4096, 256),
}
# ragged against the tiles and the 128-wide chunks, and the extremes
OTHER = [(1, 1, 1), (1000, 77, 45), (77, 1000, 45), (45, 1000, 77),
         (3, 129, 5), (64, 128, 64), (65, 257, 63), (27, 200_000, 64),
         (2 ** 20, 9, 8)]


@pytest.mark.parametrize("m,k,n", list(CNN_PRODUCTS.values()) + OTHER)
def test_plan_slices_cover_k_once(m, k, n):
    plan = TL.gemm_plan(m, n, k)
    bm, bn = TL.GEMM_TILES[plan.tile]
    assert plan.block == (bm, bn)
    gx, gy, gz = plan.grid(m, n)
    assert (gx, gy, gz) == (-(-n // bn), -(-m // bm), plan.splits)
    assert gx <= 2 ** 31 - 1 and gy <= 65535 and gz <= 65535
    if plan.splits == 1:
        assert plan.slice_k >= k and plan.workspace(m, n) == 0
        return
    # slices on multiples of 128, covering [0, K) once each, none empty
    assert plan.slice_k % TL.CHUNK_K == 0
    bounds = [(z * plan.slice_k, min(k, (z + 1) * plan.slice_k))
              for z in range(plan.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    # one partial tile a (tile, slice); one counter a tile
    assert plan.workspace(m, n) == gx * gy * gz * bm * bn
    assert gx * gy <= TL._COUNTERS


def test_plan_splits_the_weight_gradients_only():
    """Every dB product has few output tiles and a long K: it is split
    into blocks enough to (nearly) fill the card's 132 SMs. The forward
    and dA products have tiles enough and are not split."""
    for name, (m, k, n) in CNN_PRODUCTS.items():
        plan = TL.gemm_plan(m, n, k)
        gx, gy, gz = plan.grid(m, n)
        if name.endswith("dB"):
            assert plan.splits > 1, name
            assert gx * gy < TL._FILL <= gx * gy * gz, name
        else:
            assert plan.splits == 1, name
            assert gx * gy >= TL._FILL, name


def test_plan_rejects_what_the_grid_cannot_hold():
    with pytest.raises(ValueError):
        TL.gemm_plan(0, 4, 4)
    with pytest.raises(ValueError):
        TL.gemm_plan(65536 * 128 + 1, 4, 4)


def _emulate(a: np.ndarray, b: np.ndarray, plan) -> np.ndarray:
    """The kernel's summation order in plain f32: within a 128-wide chunk
    one FMA per k (exact product, one rounding: f64 sum then f32), each
    chunk's partial added to its slice's accumulator, slices added in
    index order."""
    m, k = a.shape
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    out = None
    for z in range(plan.splits):
        lo, hi = z * plan.slice_k, min(k, (z + 1) * plan.slice_k)
        acc = np.zeros((m, b.shape[1]), np.float32)
        for c0 in range(lo, hi, TL.CHUNK_K):
            part = np.zeros_like(acc)
            for kk in range(c0, min(c0 + TL.CHUNK_K, hi)):
                part = (part + np.outer(a64[:, kk], b64[kk])).astype(
                    np.float32)
            acc = acc + part
        out = acc if out is None else out + acc
    return out


# reduced weight gradients: c1's (27 rows, 64 outputs, K 8192 instead of
# 65,536), c2's and c3's at narrow width, and a ragged K
@pytest.mark.parametrize("m,k,n", [(27, 8192, 64), (72, 4096, 32),
                                   (40, 3000, 24)])
def test_emulated_split_order_meets_phase3_tolerances(m, k, n):
    rng = np.random.default_rng(m * k + n)
    # a cancelling weight gradient: Aᵀ·G with G of mean ~0
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    plan = TL.gemm_plan(m, n, k)
    assert plan.splits > 1
    got = _emulate(a, b, plan)
    want = np.asarray(JL.matmul_blocked(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True))
    bound = k * 2.0 ** -23 * (np.abs(a).astype(np.float64)
                              @ np.abs(b).astype(np.float64))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= bound).all(), float((err / bound).max())
    truth = a.astype(np.float64) @ b.astype(np.float64)
    rel = np.linalg.norm(got - truth) / np.linalg.norm(truth)
    assert rel <= 1e-5, rel
    # and the plain version the wrapper takes on the CPU
    plain = TL.gemm(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    err = np.abs(got.astype(np.float64) - plain.astype(np.float64))
    assert (err <= bound).all()

