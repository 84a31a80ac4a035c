"""The BGMV kernel's launch plan (`kernels/bgmv.bgmv_plan`) and its summation
order, on the CPU.

csrc/bgmv_f32.cu runs a call as a shrink (t = x·u, split over d_in) and an
expand (y = t·vᵀ); the wrapper chooses the split width and the expand tile.
Here: the plan at the full-width serving sites (every shrink grid fills the
card's 132 SMs), ragged N and d_in, rank 64, the grid limits, the
workspace sizes; and a plain emulation of the kernel's fixed summation
order (each lane's FMAs over its columns, the 8 lanes of a row added by a
3-level xor tree, the splits added in index order, then the expand's FMAs
over the rank in order), held to `ref.bgmv_ref` within phase 10's bound
(d_in + r)·2⁻²³·((|x|·|u|)·|v|ᵀ), elementwise."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import bgmv as B
from repro_torch.kernels import build
from repro_torch.kernels.ref import bgmv_ref

torch.set_num_threads(2)

N_SMS = 132
LANES, LANE_COLS = 8, 8          # csrc/bgmv_f32.cu ROW_LANES, LANE_COLS
PASS = LANES * LANE_COLS
# full-width llama3.2-1b factored serving: (site, d_in, d_out)
SITES = [("q", 2048, 2048), ("k", 2048, 512), ("v", 2048, 512),
         ("o", 2048, 2048), ("gate", 2048, 8192), ("up", 2048, 8192),
         ("down", 8192, 2048), ("unembed", 2048, 128256)]
SERVE_S, SERVE_N, SERVE_R = 5, 32, 8


def _check_plan(s, n, d_in, d_out, r):
    plan = B.bgmv_plan(s, n, d_in, d_out, r)
    rb = -(-n // B.ROWS_PER_BLOCK)
    assert plan.row_blocks == rb
    assert plan.split_cols in B.SPLIT_COLS and plan.split_cols % PASS == 0
    assert plan.split_cols * r <= B.MAX_U_STAGED
    # the splits cover d_in once, none empty
    assert plan.splits == -(-d_in // plan.split_cols)
    assert (plan.splits - 1) * plan.split_cols < d_in
    assert plan.out_cols in B.OUT_COLS
    gx, gy, gz = plan.expand_grid(s, d_out)
    assert gx * plan.out_cols >= d_out > (gx - 1) * plan.out_cols
    assert (gy, gz) == (rb, s)
    assert plan.shrink_grid(s) == (plan.splits, rb, s)
    part, t = plan.workspace(s, r)
    assert t == s * rb * B.ROWS_PER_BLOCK * r
    assert part == (t * plan.splits if plan.splits > 1 else 0)
    return plan


@pytest.mark.parametrize("site,d_in,d_out", SITES, ids=[x[0] for x in SITES])
def test_serving_sites_fill_the_card(site, d_in, d_out):
    """Every site's shrink puts at least one block on each of the 132 SMs;
    the expand too wherever its narrowest tile can."""
    s, n, r = SERVE_S, SERVE_N, SERVE_R
    plan = _check_plan(s, n, d_in, d_out, r)
    assert s * plan.row_blocks * plan.splits >= N_SMS
    gx, gy, gz = plan.expand_grid(s, d_out)
    if s * gy * -(-d_out // min(B.OUT_COLS)) >= N_SMS:
        assert gx * gy * gz >= N_SMS
    else:
        assert plan.out_cols == min(B.OUT_COLS)


@pytest.mark.parametrize("n,d_in,d_out,r", [(17, 2000, 1000, 5),
                                            (33, 2000, 1000, 5),
                                            (17, 1999, 999, 5),
                                            (1, 64, 1, 1),
                                            (1024, 2048, 2048, 8)])
def test_ragged_shapes(n, d_in, d_out, r):
    """Ragged N and d_in: the row blocks and splits cover them once."""
    _check_plan(SERVE_S, n, d_in, d_out, r)


def test_rank_64_stages_at_most_its_share_of_u():
    """At rank 64 a split stages at most MAX_U_STAGED floats of u, so the
    split is at most 128 columns wide."""
    plan = _check_plan(1, 32, 8192, 2048, 64)
    assert plan.split_cols * 64 <= B.MAX_U_STAGED
    assert plan.split_cols <= 128


@pytest.mark.parametrize("s,n,d_in,d_out,r", [
    (65536, 1, 64, 64, 8),                 # members past gridDim.z
    (1, 32 * 65535 + 1, 64, 64, 8),        # row blocks past gridDim.y
    (3, 32 * 30000, 64, 64, 8),            # more groups than counters
    (0, 32, 64, 64, 8)])                   # empty
def test_grid_limits_raise(s, n, d_in, d_out, r):
    with pytest.raises(ValueError):
        B.bgmv_plan(s, n, d_in, d_out, r)


def _fma(acc, a, b):
    """f32 fused multiply-add (the product exact in f64, one rounding)."""
    return (acc.double() + a.double() * b.double()).float()


def emulate(x, u, v):
    """y = (x·u)·vᵀ in the kernel's summation order and f32 roundings, with
    the split width the wrapper's plan gives."""
    s, d_in, r = u.shape
    d_out = v.shape[1]
    shared = x.dim() == 2
    n = x.shape[-2]
    xf = (x.float().expand(s, n, d_in) if shared else x.float())
    plan = B.bgmv_plan(s, n, d_in, d_out, r)
    sc, splits = plan.split_cols, plan.splits
    t = torch.zeros(s, n, r)
    for k in range(splits):
        c0, c1 = k * sc, min(d_in, (k + 1) * sc)
        lanes = torch.zeros(LANES, s, n, r)
        for c in range(LANES):
            acc = torch.zeros(s, n, r)
            for p in range(0, sc, PASS):
                for i in range(LANE_COLS):
                    d = c0 + p + c * LANE_COLS + i
                    if d >= c1:
                        break
                    acc = _fma(acc, xf[:, :, d:d + 1], u[:, d][:, None, :])
            lanes[c] = acc
        for off in (4, 2, 1):               # xor tree: lane c + lane c ^ off
            lanes = lanes + lanes[[c ^ off for c in range(LANES)]]
        t = lanes[0] if k == 0 else t + lanes[0]
    y = torch.zeros(s, n, d_out)
    for j in range(r):
        y = _fma(y, t[:, :, j:j + 1], v[:, :, j][:, None, :])
    return y


@pytest.mark.parametrize("s,n,d_in,d_out,r,dtype,shared", [
    (3, 17, 200, 50, 5, torch.bfloat16, False),
    (2, 33, 300, 70, 8, torch.float32, True),
    (5, 32, 512, 64, 8, torch.bfloat16, False),
    (1, 5, 130, 9, 64, torch.float32, False)])
def test_summation_order_within_phase10_bound(s, n, d_in, d_out, r, dtype,
                                              shared):
    """The emulated kernel against the plain version, elementwise within
    (d_in + r)·2⁻²³·((|x|·|u|)·|v|ᵀ), and exactly repeatable."""
    rng = np.random.default_rng(s * 1000 + n)
    xs = (n, d_in) if shared else (s, n, d_in)
    x = torch.from_numpy(rng.normal(size=xs).astype(np.float32)).to(dtype)
    u = torch.from_numpy(0.05 * rng.normal(size=(s, d_in, r))
                         .astype(np.float32))
    v = torch.from_numpy(0.05 * rng.normal(size=(s, d_out, r))
                         .astype(np.float32))
    y = emulate(x, u, v)
    want = bgmv_ref(x, u, v)
    bound = (d_in + r) * 2.0 ** -23 * ((x.double().abs() @ u.double().abs())
                                       @ v.double().abs().mT)
    assert ((y.double() - want.double()).abs() <= bound).all()
    assert torch.equal(y, emulate(x, u, v))


def test_cpu_route_builds_nothing(monkeypatch):
    """CPU tensors take the plain version: no plan, no build, no library."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU route must not build a kernel")
    monkeypatch.setattr(build, "load", refuse)
    monkeypatch.setattr(B, "bgmv_plan", refuse)
    x = torch.randn(2, 3, 16)
    u, v = torch.randn(2, 16, 4), torch.randn(2, 8, 4)
    assert torch.equal(B.bgmv(x, u, v), bgmv_ref(x, u, v))
