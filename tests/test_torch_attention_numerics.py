"""The numerics of the bf16 flash-attention kernel (``csrc/flash_attn_f32.cu``)
emulated on the CPU: why P·V takes P in three bf16 terms.

On the tensor cores both factors of a product are bf16. Q, K and V are
bf16 already, and bf16·bf16 products are exact in f32, so Q·Kᵀ is an f32
sum in another order (scale multiplies the f32 scores after the product).
P is not: it is an f32 softmax weight. FlashAttention-2 rounds it to bf16,
~2⁻⁹ relative to each weight; the kernel instead splits it exactly into
P = hi + mid + lo, each term the bf16 rounding of what the earlier ones
leave, and multiplies all three against the same V.

The emulation below follows the kernel: f32 scores, the online softmax
over 64-key tiles, each tile's P·V from 0 with P in `terms` bf16 terms,
acc = acc·corr + tile, out = acc / max(l, 1e-30) rounded to bf16. It is
held to chip_smoke.py phase 10's bf16 tolerance against the kernel's
plain version `ref.attention_ref` — one bf16 rounding of the output,
|out − want| ≤ 2⁻⁷·|want| + 1e-6 elementwise — on phase 10's shape
families at small size (the serving shape, long causal, windowed, ragged,
head dims 32, 64, 112 and 128, GQA groups 1–7, and MLA's q/k 192 with v
128). Three terms meet it; one
term (P rounded to bf16) does not: where cancellation leaves |out| ~1e-5,
its error is far above 1e-6."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ref import NEG_INF, attention_ref

torch.set_num_threads(2)

TILE = 64   # keys per tile, the kernel's TC_BK

# (B, Tq = Tk, H, KV, hd, window[, dv]): phase 10's families at small
# size; dv = hd unless given
CASES = {
    "serve": (10, 16, 32, 8, 64, 8192),
    "causal": (1, 512, 8, 2, 64, 0),
    "window": (1, 512, 8, 2, 64, 128),
    "ragged": (1, 500, 8, 2, 64, 0),
    "hd112": (1, 256, 4, 4, 112, 0),
    "hd32": (2, 300, 8, 1, 32, 96),
    "hd128": (1, 256, 7, 1, 128, 0),
    "mla": (1, 300, 4, 4, 192, 0, 128),
}


def _inputs(b, t, h, kv, hd, seed, dv=None):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=(b, t, n, d)).astype(
        np.float32)).bfloat16()
        for n, d in ((h, hd), (kv, hd), (kv, dv or hd)))


def _emulate(q, k, v, *, window, terms):
    """The bf16 kernel's arithmetic with P·V's P in `terms` bf16 terms
    (causal, Tq = Tk)."""
    b, t, h, hd = q.shape
    g = h // k.shape[2]
    scale = float(np.float32(hd ** -0.5))
    qf = q.float().transpose(1, 2)                       # (B, H, T, hd)
    kf = k.float().repeat_interleave(g, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(g, 2).transpose(1, 2)
    pos = torch.arange(t)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    s = torch.where(mask, (qf @ kf.transpose(-1, -2)) * scale,
                    torch.tensor(NEG_INF))
    m = torch.full((b, h, t), NEG_INF)
    l = torch.zeros((b, h, t))
    acc = torch.zeros((b, h, t, v.shape[-1]))
    for k0 in range(0, t, TILE):
        st = s[..., k0:k0 + TILE]
        m_new = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(st > 0.5 * NEG_INF, torch.exp(st - m_new[..., None]),
                        torch.zeros(()))
        l = l * corr + p.sum(-1)
        tile = torch.zeros_like(acc)
        rest = p
        for _ in range(terms):
            term = rest.bfloat16().float()
            tile = tile + term @ vf[:, :, k0:k0 + TILE]
            rest = rest - term
        acc = acc * corr[..., None] + tile
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.transpose(1, 2).bfloat16()


def _violations(out, want):
    err = (out.float() - want.float()).abs()
    return int((err > 2.0 ** -7 * want.float().abs() + 1e-6).sum())


@pytest.mark.parametrize("name", list(CASES))
def test_three_term_p_meets_phase10_tolerance(name):
    b, t, h, kv, hd, window, *dv = CASES[name]
    q, k, v = _inputs(b, t, h, kv, hd, len(name) * 1000 + t, *dv)
    want = attention_ref(q, k, v, causal=True, window=window)
    got = _emulate(q, k, v, window=window, terms=3)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert _violations(got, want) == 0


@pytest.mark.parametrize("name", ["causal", "window", "ragged", "hd112",
                                  "mla"])
def test_p_rounded_to_bf16_fails_phase10_tolerance(name):
    """The FlashAttention-2 rounding of P misses the tolerance on the long
    sequences (and a two-term split only just: it is not used)."""
    b, t, h, kv, hd, window, *dv = CASES[name]
    q, k, v = _inputs(b, t, h, kv, hd, len(name) * 1000 + t, *dv)
    want = attention_ref(q, k, v, causal=True, window=window)
    one = _violations(_emulate(q, k, v, window=window, terms=1), want)
    three = _violations(_emulate(q, k, v, window=window, terms=3), want)
    assert one > 100 and three == 0, (one, three)
