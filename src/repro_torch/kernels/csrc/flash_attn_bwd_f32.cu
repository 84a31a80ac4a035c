// Flash attention, backward, for Hopper (sm_90a): the gradients of the
// causal, sliding-window or non-causal GQA softmax attention that
// flash_attn_f32.cu computes forward, Tq = Tk or not, inputs and outputs
// in bf16 (tensor cores) or f32 (FFMA), f32 arithmetic.
//
//   q (B, Tq, H, hd); k (B, Tk, KV, hd); v (B, Tk, KV, dv); out, dout
//   (B, Tq, H, dv); lse (B, H, Tq) f32 from the forward (+inf on a row
//   with no valid key)
//   → dq (B, Tq, H, hd), dk (B, Tk, KV, hd), dv (B, Tk, KV, dv) in the
//   inputs' dtype
//
// Instances (HD, DV): (32, 32), (64, 64), (112, 112), (128, 128), and
// MLA's (192, 128) (deepseek-v2-lite-16b: q/k = nope 128 + rope 64, v
// 128) and (48, 32) (its `reduced()` heads, which the training CLI runs),
// the forward's. Δ, dP = dO·Vᵀ and dV = Pᵀ·dO run over DV columns;
// S, dQ and dK over HD; scale = hd^-1/2 of the q/k head dim.
//
// Replaces no TPU kernel: the reference has no Pallas backward. Its LM
// training differentiates the jnp chunked attention
// (src/repro/models/layers.py:flash_attention) with jax.grad; this kernel
// computes that gradient from the forward kernel's log-sum-exp, by the
// formulas of ref.attention_bwd_ref:
//
//   D = rowsum(dO∘O),  P = exp(S − lse) on valid keys (0 elsewhere),
//   dV = Σ_group Pᵀ·dO,  dP = dO·Vᵀ,  dS = P∘(dP − D),
//   dQ = scale·dS·K,  dK = scale·Σ_group dSᵀ·Q,
//
// S the scaled scores as the forward computes them ((scale·q)·kᵀ by the
// same FFMA chain for f32 inputs, scale·(q·kᵀ) for bf16), and the masks
// the forward's: a key at or past Tk, after the query (causal), or `window` or
// more positions before it is invalid; query and key positions both count
// from 0, so non-causal attention with Tq ≠ Tk (the encoder-decoder's
// cross-attention, T target queries over T_src source keys) masks only
// the keys past Tk. A row with lse = +inf gets P = 0: its dq is 0 and it
// adds nothing to dk and dv (ROADMAP C7). Rows past the last of a tile
// (tq·g rows need not fill one: 16 target queries a head over 1,000
// keys) read 0 and are masked; keys past Tk likewise.
//
// Three passes, each deterministic: no atomics; every sum is taken by one
// thread (or one warp's tensor-core fragment) in a fixed order.
//  * Δ: D[b, h, t] = Σ_d dO·O, one warp a row, a fixed shuffle tree.
//  * dK/dV: a block owns (batch, kv head, 64 keys) and walks the row
//    tiles that can see them. A row is a (position, query head) pair of
//    the kv head's group, position-major, as the forward's bf16 path
//    orders them, so the sum over the group's heads happens inside the
//    block, in row order, and dK, dV are written once. Query positions
//    before the tile (causal) or `window` or more past its last key are
//    skipped: they add exactly nothing. Non-causal, a block walks every
//    row of its batch row and kv head (all Tq·g of them), still in one
//    block and in row order: no float atomics.
//  * dQ: a block owns (batch, kv head, 64 rows) and walks the key tiles
//    the forward walks for them (the same skipping rule); it recomputes S
//    and dP, the price of writing dQ without atomics (a fused dQ would
//    add it up with atomics, in an order that changes from run to run).
//
// Bound on an H100 SXM: 2·(3·hd + 2·dv) FLOP per valid (query, key) pair
// (S twice and dQ, dK at 2·hd each; dP twice and dV at 2·dv each: 10·hd
// at dv = hd) at 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32),
// against the bytes of q, k, v, out, dout, lse, D, dq, dk and dv at 3.35
// TB/s. Long sequences are bound by operations.
//
// bf16: tensor cores, the FlashAttention-2 backward's shape, with the
// forward's building blocks (flash_attn_f32.cu: ldmatrix, mma.sync,
// split3). Blocks of 4 warps; the grid is one-dimensional with the (kv
// head, batch) pair fastest, so that the tiles with the longest walks
// (causal: dK/dV's first key tiles, dQ's last row tiles) launch first
// and the short ones fill the tail; non-causal, every block of a pass
// walks as far as every other, and the order does not matter.
//  * dK/dV: each warp owns 16 of the block's 64 keys. K and V load once;
//    the row tiles' Q and dO are copied as bf16 with 16-byte cp.async
//    into padded shared rows (ldmatrix reads them without bank
//    conflicts), lse and D with 4-byte cp.async, double-buffered: the
//    next row tile's copy is in flight while this one computes. Sᵀ = K·Qᵀ
//    and dPᵀ = V·dOᵀ by mma.sync.m16n8k16 (bf16 in, f32 out); bf16·bf16
//    products are exact, and their sums are taken as "Sums" says.
//    `scale` multiplies the f32 scores after the product (scale·q is no
//    bf16 value), P = exp(S − lse) and dS = P∘(dP − D) are formed in
//    registers, masked as the forward masks (only tiles that cross the
//    diagonal, the window's edge, Tk or the last row compute the mask),
//    and the accumulator fragment of Pᵀ (dSᵀ) is the A fragment of
//    dV += Pᵀ·dO (dK += dSᵀ·Q), with dO (Q) as B through ldmatrix.trans.
//    A row tile is 64 rows at hd 32 and 64 and 32 rows at hd 112, 128
//    and 192, where the running dK and dV (hd + dv f32 a thread) leave
//    too few registers for 64 (ptxas still spills 20–180 bytes a thread
//    at 112 and 128, more at (192, 128): a simple instance first).
//  * dQ: each warp owns 16 of the block's 64 rows; Q, dO, lse and D load
//    once, K and V tiles are double-buffered as above. S = Q·Kᵀ and
//    dP = dO·Vᵀ on mma.sync, then dQ += dS·K with K as B through
//    ldmatrix.trans.
//  * P and dS: FlashAttention-2 rounds them to bf16 before the products,
//    ~2⁻⁹ relative to each term, where one bf16 rounding of the gradient
//    is all the tolerance there is (chip_smoke.py phase 10; the forward
//    learned the same for P·V). Each is split exactly into three bf16
//    terms, x = hi + mid + lo (split3), and all three multiply the same
//    B fragment: P and dS carry ~24 bits, as f32 values would.
//  * Sums. The tensor cores add a product's 16 terms and the accumulator
//    they are given with their significands aligned to the largest and
//    truncated, not as f32 round-to-nearest additions. S accumulates its
//    hd/16 chunks on them as the forward's S does (in the dQ pass by the
//    same instructions, so S is the forward's bit for bit). dP takes each
//    k16 chunk from 0 and adds the chunks by f32 adds: dS = P∘(dP − D)
//    cancels where a row sees few keys (with one key dP = D exactly), and
//    dP accumulated on the tensor cores left up to 1.8e-6 in dq there
//    (H100, phase 10's shapes), where the f32 plain version reads 0 and
//    phase 10's limit allows 1e-6. The gradient products take each row
//    (key) tile from 0, its three terms and its 16-row (16-key) steps in
//    one accumulator, and add it to f32 running sums in registers; dK and
//    dQ are multiplied by `scale` once at the end, and each gradient is
//    rounded to bf16 once.
//  Error model: S within hd truncated terms (2⁻²³ of the largest term or
//  partial sum each) of the exact sum, dP within 16 such terms a chunk
//  and hd/16 f32 roundings; P within 2⁻²⁴ relative (3 terms) and expf's
//  1 ulp, dS the same on top of one f32 subtraction and product; a tile's
//  product within ~3·(tile rows) truncated terms of Σ|terms| over the
//  tile, then one f32 rounding a tile in the running sum: over n rows
//  (keys), ~⌈n/64⌉ roundings at the running sum's magnitude. No f64: the
//  bf16 gradient's own rounding (2⁻⁹ relative) is far above this.
//
// f32: FFMA (phase 10's 1e-5 gate against f64; TF32 would miss it).
// Per tile, each block stages its operands in shared memory as f32 (Q
// and K rows HD wide, dO and V rows DV wide: 194 KB a dK/dV block at
// (192, 128)),
// computes S and dP for 64 × 64 (row, key) pairs (each of 256 threads a
// 4 × 4 set: rows a + 16i, keys b + 16j, so that a warp reads 16
// different rows of the K/V tile, on 16 banks), writes P and dS to
// shared memory and takes the tile's products into registers from 0,
// ≤ 64 FFMA terms in f32; each tile's sum is then added to a running sum
// kept in f64, rounded to f32 once at the end. So a gradient element
// carries the rounding of one 64-term f32 sum a tile, whatever the number
// n of rows (or keys) it sums over: at T = 2,048 and a group of 4, dK and
// dV sum 8,192 rows, and an f32 running sum over their 128 tiles would
// add the rounding of 128 more additions at the running sum's magnitude
// (the early keys' columns, which every query sees, are the largest).
// The f64 adds are 4·hd/16 a thread a tile. The FFMA kernels keep their
// element-type template; they run for f32 inputs alone.
//
// Plain C interface for ctypes; returns cudaGetLastError(). `delta` is an
// f32 (B, H, Tq) workspace the wrapper allocates; q, k, v, dout (and dq,
// dk, dv) start on 16-byte boundaries (the wrapper checks the inputs).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;        // rows a tile: (position, head) pairs
constexpr int BK = 64;        // keys a tile
constexpr int PS = BK + 1;    // f32 per shared row of the P and dS tiles
constexpr int DELTA_ROWS = THREADS / 32;  // rows a block of the Δ pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

// ---------------------------------------------------------------------------
// Δ = rowsum(dO∘O)
// ---------------------------------------------------------------------------

template <typename T, int DV>
__global__ void __launch_bounds__(THREADS)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int tq, int h,
                      int64_t n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * DELTA_ROWS + warp;  // (b, t, h)
  if (row >= n_rows) return;
  float acc = 0.f;
  for (int c = lane; c < DV; c += 32)
    acc = fmaf(to_f32(dout[row * DV + c]), to_f32(o[row * DV + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int hh = (int)(row % h);
    const int64_t bt = row / h;
    delta[(bt / tq * h + hh) * tq + bt % tq] = acc;
  }
}

// ---------------------------------------------------------------------------
// f32, FFMA: shared tiles and the (S, dP) → (P, dS) step both kernels share
// ---------------------------------------------------------------------------

template <int HD, int DV>
struct Tiles {
  static constexpr int LD = HD + 1;   // f32 per shared row of a Q or K tile
  static constexpr int LDV = DV + 1;  // of a dO or V tile
  static constexpr int NC = HD / 16;  // dQ, dK columns a thread: b + 16j
  static constexpr int NCV = DV / 16;  // dV columns a thread
  static constexpr size_t bytes(int n_ps) {
    // Q (scaled), dO, K, V; n_ps tiles of (row, key); lse, D, position
    return sizeof(float) * ((size_t)(BQ + BK) * (LD + LDV) +
                            (size_t)n_ps * BQ * PS + 3 * BQ);
  }
};

// rows [r0, r0 + BQ) of kv head `kvh`'s group: row r is position r / g of
// query head kvh·g + r % g. Q is stored scaled, dO as it is; rows past the
// last read 0 and are marked invalid (position −1).
template <typename T, int HD, int DV>
__device__ void load_rows(float* qs, float* dos, float* lse_s, float* d_s,
                          int* pos_s, const T* __restrict__ q,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int b, int kvh,
                          int g, int h, int tq, int r0, float scale) {
  constexpr int LD = Tiles<HD, DV>::LD, LDV = Tiles<HD, DV>::LDV;
  const int rows = tq * g;
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int row = i / HD, c = i % HD, r = r0 + row;
    qs[row * LD + c] =
        r < rows ? to_f32(q[(((size_t)b * tq + r / g) * h + kvh * g + r % g) *
                                HD + c]) * scale
                 : 0.f;
  }
  for (int i = threadIdx.x; i < BQ * DV; i += THREADS) {
    const int row = i / DV, c = i % DV, r = r0 + row;
    dos[row * LDV + c] =
        r < rows ? to_f32(dout[(((size_t)b * tq + r / g) * h + kvh * g +
                                 r % g) * DV + c])
                 : 0.f;
  }
  for (int row = threadIdx.x; row < BQ; row += THREADS) {
    const int r = r0 + row;
    if (r < rows) {
      const size_t at = ((size_t)b * h + kvh * g + r % g) * tq + r / g;
      lse_s[row] = lse[at];
      d_s[row] = delta[at];
      pos_s[row] = r / g;
    } else {
      lse_s[row] = 0.f;
      d_s[row] = 0.f;
      pos_s[row] = -1;
    }
  }
}

// keys [k0, k0 + BK) of kv head `kvh`; keys at or past Tk read 0
template <typename T, int HD, int DV>
__device__ void load_keys(float* ks, float* vs, const T* __restrict__ k,
                          const T* __restrict__ v, int b, int kvh, int kv,
                          int tk, int k0) {
  constexpr int LD = Tiles<HD, DV>::LD, LDV = Tiles<HD, DV>::LDV;
  for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
    const int key = i / HD, c = i % HD, kpos = k0 + key;
    ks[key * LD + c] =
        kpos < tk ? to_f32(k[(((size_t)b * tk + kpos) * kv + kvh) * HD + c])
                  : 0.f;
  }
  for (int i = threadIdx.x; i < BK * DV; i += THREADS) {
    const int key = i / DV, c = i % DV, kpos = k0 + key;
    vs[key * LDV + c] =
        kpos < tk ? to_f32(v[(((size_t)b * tk + kpos) * kv + kvh) * DV + c])
                  : 0.f;
  }
}

// This thread's 4 × 4 (row, key) pairs of the staged tiles, rows a + 16i
// and keys b + 16j: P = exp(S − lse) (0 on an invalid pair) into p and
// dS = P∘(dP − D) into ds. S sums over HD columns, dP over DV, each in
// column order (in one loop at HD = DV).
template <int HD, int DV>
__device__ __forceinline__ void p_and_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* d_s, const int* pos_s, int a, int bc,
    int k0, int tk, int causal, int window, float (&p)[4][4],
    float (&ds)[4][4]) {
  constexpr int LD = Tiles<HD, DV>::LD, LDV = Tiles<HD, DV>::LDV;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
  if constexpr (HD == DV) {
#pragma unroll 4
    for (int c = 0; c < HD; ++c) {
      float qv[4], dov[4], kv_[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(a + 16 * i) * LD + c];
        dov[i] = dos[(a + 16 * i) * LD + c];
        kv_[i] = ks[(bc + 16 * i) * LD + c];
        vv[i] = vs[(bc + 16 * i) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }
  } else {
#pragma unroll 4
    for (int c = 0; c < HD; ++c) {
      float qv[4], kv_[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(a + 16 * i) * LD + c];
        kv_[i] = ks[(bc + 16 * i) * LD + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv_[j], s[i][j]);
    }
#pragma unroll 4
    for (int c = 0; c < DV; ++c) {
      float dov[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        dov[i] = dos[(a + 16 * i) * LDV + c];
        vv[i] = vs[(bc + 16 * i) * LDV + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = a + 16 * i, qp = pos_s[row];
    const float l = lse_s[row], d = d_s[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k0 + bc + 16 * j;
      bool valid = qp >= 0 && kp < tk;
      if (causal) valid = valid && qp >= kp;
      if (window > 0) valid = valid && qp - kp < window;
      // lse = +inf (a row with no valid key) gives exp(−inf) = 0
      p[i][j] = valid ? expf(s[i][j] - l) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - d);
    }
  }
}

// ---------------------------------------------------------------------------
// dK, dV: a block a (key tile, kv head, batch)
// ---------------------------------------------------------------------------

template <typename T, int HD, int DV>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int tq, int tk, int h, int kv,
                    int causal, int window, float scale) {
  using TL = Tiles<HD, DV>;
  constexpr int LD = TL::LD, LDV = TL::LDV, NC = TL::NC, NCV = TL::NCV;
  static_assert(HD % 16 == 0 && DV % 16 == 0,
                "head dims in steps of 16 columns");
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LDV;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LDV;  // [BQ][PS]
  float* dss = ps + BQ * PS;  // [BQ][PS]
  float* lse_s = dss + BQ * PS;
  float* d_s = lse_s + BQ;
  int* pos_s = reinterpret_cast<int*>(d_s + BQ);

  const int tid = threadIdx.x, a = tid / 16, bc = tid % 16;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = h / kv, rows = tq * g;
  const int k0 = blockIdx.x * BK;
  const int k_last = min(k0 + BK, tk) - 1;
  // the query positions that see a key of this tile, as rows
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(tq - 1, k_last + window - 1) : tq - 1;
  const int r_begin = q_lo * g, r_end = min(rows, (q_hi + 1) * g);

  load_keys<T, HD, DV>(ks, vs, k, v, b, kvh, kv, tk, k0);
  double acc_k[4][NC], acc_v[4][NCV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_k[i][j] = 0.0;
#pragma unroll
    for (int j = 0; j < NCV; ++j) acc_v[i][j] = 0.0;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += BQ) {
    __syncthreads();  // the last tile's Q, dO, P and dS are read
    load_rows<T, HD, DV>(qs, dos, lse_s, d_s, pos_s, q, dout, lse, delta, b,
                         kvh, g, h, tq, r0, scale);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HD, DV>(qs, dos, ks, vs, lse_s, d_s, pos_s, a, bc, k0, tk,
                     causal, window, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(a + 16 * i) * PS + bc + 16 * j] = p[i][j];
        dss[(a + 16 * i) * PS + bc + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // the tile's Pᵀ·dO (DV columns) and dSᵀ·(scale·Q) (HD columns) for
    // keys a + 16i, columns bc + 16j, from 0, then into the running sums
    float tv[4][NCV], tk_[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NCV; ++j) tv[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < NC; ++j) tk_[i][j] = 0.f;
    }
    for (int row = 0; row < BQ; ++row) {
      float pk[4], dsk[4], dov[NCV], qv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = ps[row * PS + a + 16 * i];
        dsk[i] = dss[row * PS + a + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NCV; ++j) dov[j] = dos[row * LDV + bc + 16 * j];
#pragma unroll
      for (int j = 0; j < NC; ++j) qv[j] = qs[row * LD + bc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < NCV; ++j) tv[i][j] = fmaf(pk[i], dov[j], tv[i][j]);
#pragma unroll
        for (int j = 0; j < NC; ++j)
          tk_[i][j] = fmaf(dsk[i], qv[j], tk_[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < NCV; ++j) acc_v[i][j] += (double)tv[i][j];
#pragma unroll
      for (int j = 0; j < NC; ++j) acc_k[i][j] += (double)tk_[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + a + 16 * i;
    if (kpos >= tk) continue;
    const size_t row = ((size_t)b * tk + kpos) * kv + kvh;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dk[row * HD + bc + 16 * j] = from_f32<T>((float)acc_k[i][j]);
#pragma unroll
    for (int j = 0; j < NCV; ++j)
      dv[row * DV + bc + 16 * j] = from_f32<T>((float)acc_v[i][j]);
  }
}

// ---------------------------------------------------------------------------
// dQ: a block a (row tile, kv head, batch)
// ---------------------------------------------------------------------------

template <typename T, int HD, int DV>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int tq, int tk, int h, int kv, int causal, int window,
                   float scale) {
  using TL = Tiles<HD, DV>;
  constexpr int LD = TL::LD, LDV = TL::LDV, NC = TL::NC;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LDV;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LDV;  // [BQ][PS]
  float* lse_s = dss + BQ * PS;
  float* d_s = lse_s + BQ;
  int* pos_s = reinterpret_cast<int*>(d_s + BQ);

  const int tid = threadIdx.x, a = tid / 16, bc = tid % 16;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = h / kv, rows = tq * g;
  const int r0 = blockIdx.x * BQ;
  const int q_first = r0 / g, q_last = (min(r0 + BQ, rows) - 1) / g;
  // the forward's key tiles for these positions
  const int n_kt = (tk + BK - 1) / BK;
  const int kt_end = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  const int kt_begin = window > 0 ? max(0, q_first - window + 1) / BK : 0;

  load_rows<T, HD, DV>(qs, dos, lse_s, d_s, pos_s, q, dout, lse, delta, b,
                       kvh, g, h, tq, r0, scale);
  double acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's K and dS are read
    load_keys<T, HD, DV>(ks, vs, k, v, b, kvh, kv, tk, k0);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HD, DV>(qs, dos, ks, vs, lse_s, d_s, pos_s, a, bc, k0, tk,
                     causal, window, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(a + 16 * i) * PS + bc + 16 * j] = ds[i][j];
    __syncthreads();
    // the tile's dS·K for rows a + 16i, columns bc + 16j, from 0
    float t[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) t[i][j] = 0.f;
    for (int key = 0; key < BK; ++key) {
      float dsv[4], kv_[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(a + 16 * i) * PS + key];
#pragma unroll
      for (int j = 0; j < NC; ++j) kv_[j] = ks[key * LD + bc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) t[i][j] = fmaf(dsv[i], kv_[j], t[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] += (double)t[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + a + 16 * i;
    if (r >= rows) continue;
    const size_t base =
        (((size_t)b * tq + r / g) * h + kvh * (h / kv) + r % g) * HD + bc;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      dq[base + 16 * j] = from_f32<T>((float)((double)scale * acc[i][j]));
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16_t = __nv_bfloat16;

constexpr int TC_THREADS = 128;  // 4 warps
constexpr int TC_KEYS = 64;      // keys: a dK/dV block's, a dQ block's tile
constexpr int TC_ROWS = 64;      // rows of a dQ block, 16 a warp
constexpr int TC_PAD = 8;        // bf16 a shared row is padded by: 16 bytes

// rows of a dK/dV block's row tile (see the header)
template <int HD>
constexpr int DKV_ROWS = HD > 64 ? 32 : 64;

template <int HD, int DV>
constexpr size_t dkv_smem_bytes() {
  // K, V; 2 stages of Q and dO; 2 stages of lse and D (Q and K rows HD
  // wide, dO and V rows DV wide: 86,528 bytes at (192, 128))
  return sizeof(bf16_t) * (size_t)(TC_KEYS + 2 * DKV_ROWS<HD>) *
             (HD + DV + 2 * TC_PAD) +
         sizeof(float) * 4 * DKV_ROWS<HD>;
}

template <int HD, int DV>
constexpr size_t dq_smem_bytes() {
  // Q, dO; 2 stages of K and of V (129,024 bytes at (192, 128))
  return sizeof(bf16_t) * (size_t)(TC_ROWS + 2 * TC_KEYS) *
         (HD + DV + 2 * TC_PAD);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a·b: a 16×16 (row), b 16×8 (col), bf16; d 16×8 f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// (x0, x1) = hi + mid + lo exactly up to the last term's rounding: each
// term the bf16 rounding of what the earlier ones leave (the differences
// are exact in f32). Packed as bf16x2, x0 in the low half.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m));
  hi = bits(h);
  mid = bits(m);
  lo = bits(l);
}

// A warp's two score-shaped products, s = A_s·B_sᵀ and d = A_d·B_dᵀ: A the
// warp's 16 rows at a_s, a_d, B the tile's 8·N8 rows at b_s, b_d,
// row-major in shared memory, A_s and B_s HD wide, A_d and B_d DV wide;
// s and d are 16 × 8·N8 accumulator fragments. s accumulates on the
// tensor cores, as the forward's S does; each k16 chunk of d is summed
// from 0 and added by an f32 add (see the header: dP − D).
template <int HD, int DV, int N8>
__device__ __forceinline__ void two_products(
    float (&s)[N8][4], float (&d)[N8][4], const bf16_t* a_s, const bf16_t* a_d,
    const bf16_t* b_s, const bf16_t* b_d, int lane) {
  constexpr int SS = HD + TC_PAD, SD = DV + TC_PAD;
  constexpr int KS = HD / 16, KD = DV / 16, KM = KS > KD ? KS : KD;
#pragma unroll
  for (int j = 0; j < N8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = d[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < KM; ++kk) {
    uint32_t as[4], ad[4];
    const int a_row = lane % 16, a_col = kk * 16 + lane / 16 * 8;
    if (kk < KS) ldmatrix_x4(as, a_s + a_row * SS + a_col);
    if (kk < KD) ldmatrix_x4(ad, a_d + a_row * SD + a_col);
#pragma unroll
    for (int jp = 0; jp < N8 / 2; ++jp) {
      const int b_row = jp * 16 + lane / 16 * 8 + lane % 8;
      const int b_col = kk * 16 + (lane / 8) % 2 * 8;
      if (kk < KS) {
        uint32_t bs[4];
        ldmatrix_x4(bs, b_s + b_row * SS + b_col);
        mma_bf16(s[2 * jp], as, bs[0], bs[1]);
        mma_bf16(s[2 * jp + 1], as, bs[2], bs[3]);
      }
      if (kk >= KD) continue;
      uint32_t bd[4];
      ldmatrix_x4(bd, b_d + b_row * SD + b_col);
      if (kk == 0) {
        mma_bf16(d[2 * jp], ad, bd[0], bd[1]);
        mma_bf16(d[2 * jp + 1], ad, bd[2], bd[3]);
        continue;
      }
      float t[2][4] = {};
      mma_bf16(t[0], ad, bd[0], bd[1]);
      mma_bf16(t[1], ad, bd[2], bd[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[2 * jp][e] += t[0][e];
        d[2 * jp + 1][e] += t[1][e];
      }
    }
  }
}

// acc (16 × W, the warp's rows of a gradient) += x·B: x the accumulator
// fragments of a 16 × (8·N8) tile, contracted over its 8·N8 columns, split
// into three bf16 terms; B the (8·N8) × W row-major shared tile at `b`
// (ldmatrix.trans; W = HD for dK and dQ, DV for dV). Each pair of W's n8
// blocks takes the tile's product from 0, then adds it to acc.
template <int W, int N8>
__device__ __forceinline__ void add_product(float (&acc)[W / 8][4],
                                            const float (&x)[N8][4],
                                            const bf16_t* b, int lane) {
  constexpr int S = W + TC_PAD;
  uint32_t hi[N8 / 2][4], mid[N8 / 2][4], lo[N8 / 2][4];
#pragma unroll
  for (int kk = 0; kk < N8 / 2; ++kk) {
    split3(x[2 * kk][0], x[2 * kk][1], hi[kk][0], mid[kk][0], lo[kk][0]);
    split3(x[2 * kk][2], x[2 * kk][3], hi[kk][1], mid[kk][1], lo[kk][1]);
    split3(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[kk][2], mid[kk][2],
           lo[kk][2]);
    split3(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[kk][3], mid[kk][3],
           lo[kk][3]);
  }
#pragma unroll
  for (int np = 0; np < W / 16; ++np) {
    float t[2][4];
#pragma unroll
    for (int e = 0; e < 4; ++e) t[0][e] = t[1][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N8 / 2; ++kk) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, b + (kk * 16 + (lane / 8) % 2 * 8 + lane % 8) * S +
                                np * 16 + lane / 16 * 8);
      mma_bf16(t[0], hi[kk], bv[0], bv[1]);
      mma_bf16(t[0], mid[kk], bv[0], bv[1]);
      mma_bf16(t[0], lo[kk], bv[0], bv[1]);
      mma_bf16(t[1], hi[kk], bv[2], bv[3]);
      mma_bf16(t[1], mid[kk], bv[2], bv[3]);
      mma_bf16(t[1], lo[kk], bv[2], bv[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[2 * np][e] += t[0][e];
      acc[2 * np + 1][e] += t[1][e];
    }
  }
}

// P = exp(scale·s − lse) on a valid pair (0 elsewhere, and 0 where lse is
// +inf) into s, dS = P∘(dP − D) into d
__device__ __forceinline__ void p_and_ds_tc(float& s, float& d, float l,
                                            float dd, float scale,
                                            bool valid) {
  const float p = valid ? expf(s * scale - l) : 0.f;
  s = p;
  d = p * (d - dd);
}

// rows [r0, r0 + n) of kv head `kvh`'s group of the (B, Tq, H, W) tensor
// `src` into shared rows of stride W + TC_PAD (bf16, 16-byte cp.async;
// rows past the last read 0): row r is position r / g of query head
// kvh·g + r % g
template <int W>
__device__ __forceinline__ void copy_rows(bf16_t* dst,
                                          const bf16_t* __restrict__ src,
                                          int n, int b, int kvh, int g,
                                          int h, int tq, int r0) {
  constexpr int S = W + TC_PAD, C = W / 8;
  const int rows = tq * g;
  for (int c = threadIdx.x; c < n * C; c += TC_THREADS) {
    const int row = c / C, col = c % C * 8, r = r0 + row;
    const bool ok = r < rows;
    const size_t off =
        ok ? (((size_t)b * tq + r / g) * h + kvh * g + r % g) * W + col : 0;
    cp_async16(dst + row * S + col, src + off, ok);
  }
}

// keys [k0, k0 + TC_KEYS) of kv head `kvh` of the (B, Tk, KV, W) tensor
// `src`; keys at or past Tk read 0
template <int W>
__device__ __forceinline__ void copy_keys(bf16_t* dst,
                                          const bf16_t* __restrict__ src,
                                          int b, int kvh, int kv, int tk,
                                          int k0) {
  constexpr int S = W + TC_PAD, C = W / 8;
  for (int c = threadIdx.x; c < TC_KEYS * C; c += TC_THREADS) {
    const int row = c / C, col = c % C * 8, kpos = k0 + row;
    const bool ok = kpos < tk;
    const size_t off =
        (((size_t)b * tk + (ok ? kpos : 0)) * kv + kvh) * W + col;
    cp_async16(dst + row * S + col, src + off, ok);
  }
}

template <int HD, int DV>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_dkv_bf16_kernel(const bf16_t* __restrict__ q,
                         const bf16_t* __restrict__ k,
                         const bf16_t* __restrict__ v,
                         const bf16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16_t* __restrict__ dk, bf16_t* __restrict__ dv,
                         int tq, int tk, int h, int kv, int nb, int causal,
                         int window, float scale) {
  static_assert(HD % 16 == 0 && DV % 16 == 0,
                "head dims in k16 steps and pairs of n8 blocks");
  constexpr int R = DKV_ROWS<HD>;  // rows a tile
  constexpr int SQ = HD + TC_PAD;    // bf16 per shared row of Q and K
  constexpr int SV = DV + TC_PAD;    // of dO and V
  constexpr int NR = R / 8;          // n8 blocks of a tile's rows
  constexpr int NB = HD / 8;         // n8 blocks of dK's columns
  constexpr int NBV = DV / 8;        // of dV's
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* ks = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* vs = ks + TC_KEYS * SQ;
  bf16_t* qs = vs + TC_KEYS * SV;  // 2 stages of R rows
  bf16_t* dos = qs + 2 * R * SQ;   // 2 stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * R * SV);  // 2 stages
  float* d_s = lse_s + 2 * R;                                // 2 stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int pairs = kv * nb;
  const int kvh = blockIdx.x % pairs % kv, b = blockIdx.x % pairs / kv;
  const int k0 = blockIdx.x / pairs * TC_KEYS;  // key tile 0 first
  const int g = h / kv, rows = tq * g;
  const int k_last = min(k0 + TC_KEYS, tk) - 1;
  // the query positions that see a key of this tile, as rows
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(tq - 1, k_last + window - 1) : tq - 1;
  const int r_begin = q_lo * g, r_end = min(rows, (q_hi + 1) * g);
  const int n_rt = r_begin < r_end ? (r_end - r_begin + R - 1) / R : 0;

  auto copy_tile = [&](int i, int stage) {
    const int r0 = r_begin + i * R;
    copy_rows<HD>(qs + stage * R * SQ, q, R, b, kvh, g, h, tq, r0);
    copy_rows<DV>(dos + stage * R * SV, dout, R, b, kvh, g, h, tq, r0);
    for (int row = tid; row < R; row += TC_THREADS) {
      const int r = r0 + row;
      const bool ok = r < rows;
      const size_t at =
          ok ? ((size_t)b * h + kvh * g + r % g) * tq + r / g : 0;
      cp_async4(lse_s + stage * R + row, lse + at, ok);
      cp_async4(d_s + stage * R + row, delta + at, ok);
    }
  };

  copy_keys<HD>(ks, k, b, kvh, kv, tk, k0);
  copy_keys<DV>(vs, v, b, kvh, kv, tk, k0);
  if (n_rt > 0) copy_tile(0, 0);
  cp_async_commit();  // with K and V

  // this thread's keys of the warp's 16: lane/4 and lane/4 + 8
  const int key0 = k0 + warp * 16 + lane / 4;
  float acc_k[NB][4], acc_v[NBV][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int n = 0; n < NB; ++n) acc_k[n][e] = 0.f;
#pragma unroll
    for (int n = 0; n < NBV; ++n) acc_v[n][e] = 0.f;
  }

  for (int i = 0; i < n_rt; ++i) {
    const int stage = i & 1;
    if (i + 1 < n_rt) copy_tile(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and K, V) landed, the next in flight
    __syncthreads();
    const bf16_t* qst = qs + stage * R * SQ;
    const bf16_t* dost = dos + stage * R * SV;
    const float* ls = lse_s + stage * R;
    const float* dls = d_s + stage * R;
    const int r0 = r_begin + i * R;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: the warp's 16 keys × R rows
    float s[NR][4], dp[NR][4];
    two_products<HD, DV, NR>(s, dp, ks + warp * 16 * SQ, vs + warp * 16 * SV,
                             qst, dost, lane);

    // element e of block j: key key0 + 8·(e/2), row r0 + 8j + 2·(lane%4)
    // + e%2. A tile whose every pair is valid skips the mask.
    const int q_first = r0 / g, q_last = (min(r0 + R, rows) - 1) / g;
    const int kt_last = k0 + TC_KEYS - 1;
    const bool all_valid = r0 + R <= rows && kt_last < tk &&
                           (!causal || kt_last <= q_first) &&
                           (window <= 0 || q_last - k0 < window);
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
      const float2 d2 = *reinterpret_cast<const float2*>(dls + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool valid = true;
        if (!all_valid) {
          const int r = r0 + col + e % 2, kpos = key0 + 8 * (e / 2);
          const int qp = r / g;
          valid = r < rows && kpos < tk;
          if (causal) valid = valid && qp >= kpos;
          if (window > 0) valid = valid && qp - kpos < window;
        }
        p_and_ds_tc(s[j][e], dp[j][e], e % 2 ? l2.y : l2.x,
                    e % 2 ? d2.y : d2.x, scale, valid);
      }
    }

    // dV += Pᵀ·dO, dK += dSᵀ·Q (scaled at the end)
    add_product<DV, NR>(acc_v, s, dost, lane);
    add_product<HD, NR>(acc_k, dp, qst, lane);
    __syncthreads();  // this stage is read; the next prefetch may land here
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kpos = key0 + 8 * i;
    if (kpos >= tk) continue;
    const size_t row = ((size_t)b * tk + kpos) * kv + kvh;
    const int col = 2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dk + row * HD + col + 8 * n) =
          __floats2bfloat162_rn(scale * acc_k[n][2 * i],
                                scale * acc_k[n][2 * i + 1]);
#pragma unroll
    for (int n = 0; n < NBV; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dv + row * DV + col + 8 * n) =
          __floats2bfloat162_rn(acc_v[n][2 * i], acc_v[n][2 * i + 1]);
  }
}

template <int HD, int DV>
__global__ void __launch_bounds__(TC_THREADS)
attn_bwd_dq_bf16_kernel(const bf16_t* __restrict__ q,
                        const bf16_t* __restrict__ k,
                        const bf16_t* __restrict__ v,
                        const bf16_t* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        bf16_t* __restrict__ dq, int tq, int tk, int h, int kv,
                        int nb, int causal, int window, float scale) {
  static_assert(HD % 16 == 0 && DV % 16 == 0,
                "head dims in k16 steps and pairs of n8 blocks");
  constexpr int SQ = HD + TC_PAD;      // bf16 per shared row of Q and K
  constexpr int SV = DV + TC_PAD;      // of dO and V
  constexpr int NK = TC_KEYS / 8;      // n8 blocks of a tile's keys
  constexpr int NB = HD / 8;           // n8 blocks of the gradient's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16_t* qs = reinterpret_cast<bf16_t*>(smem_raw);
  bf16_t* dos = qs + TC_ROWS * SQ;
  bf16_t* ks = dos + TC_ROWS * SV;     // 2 stages
  bf16_t* vs = ks + 2 * TC_KEYS * SQ;  // 2 stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / kv, rows = tq * g;
  const int pairs = kv * nb, n_rt = (rows + TC_ROWS - 1) / TC_ROWS;
  const int kvh = blockIdx.x % pairs % kv, b = blockIdx.x % pairs / kv;
  const int r0 = (n_rt - 1 - blockIdx.x / pairs) * TC_ROWS;  // last rows first
  const int q_first = r0 / g;
  const int q_last = (min(r0 + TC_ROWS, rows) - 1) / g;
  // the forward's key tiles for these positions
  const int n_kt = (tk + TC_KEYS - 1) / TC_KEYS;
  const int kt_end = causal ? min(n_kt, q_last / TC_KEYS + 1) : n_kt;
  const int kt_begin =
      window > 0 ? max(0, q_first - window + 1) / TC_KEYS : 0;

  copy_rows<HD>(qs, q, TC_ROWS, b, kvh, g, h, tq, r0);
  copy_rows<DV>(dos, dout, TC_ROWS, b, kvh, g, h, tq, r0);
  if (kt_begin < kt_end) {
    copy_keys<HD>(ks, k, b, kvh, kv, tk, kt_begin * TC_KEYS);
    copy_keys<DV>(vs, v, b, kvh, kv, tk, kt_begin * TC_KEYS);
  }
  cp_async_commit();  // with Q and dO

  // this thread's two rows of the warp's 16: lane/4 and lane/4 + 8; lse
  // +inf past the last row, so that its P is 0
  int qpos[2];
  float l[2], dd[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + lane / 4 + 8 * i;
    qpos[i] = r < rows ? r / g : -1;
    const size_t at =
        r < rows ? ((size_t)b * h + kvh * g + r % g) * tq + r / g : 0;
    l[i] = r < rows ? lse[at] : __int_as_float(0x7f800000);
    dd[i] = r < rows ? delta[at] : 0.f;
  }
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) {
      copy_keys<HD>(ks + (stage ^ 1) * TC_KEYS * SQ, k, b, kvh, kv, tk,
                    (kt + 1) * TC_KEYS);
      copy_keys<DV>(vs + (stage ^ 1) * TC_KEYS * SV, v, b, kvh, kv, tk,
                    (kt + 1) * TC_KEYS);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q, dO) landed, the next in flight
    __syncthreads();
    const bf16_t* kst = ks + stage * TC_KEYS * SQ;
    const bf16_t* vst = vs + stage * TC_KEYS * SV;

    // S = Q·Kᵀ and dP = dO·Vᵀ: the warp's 16 rows × 64 keys
    float s[NK][4], dp[NK][4];
    two_products<HD, DV, NK>(s, dp, qs + warp * 16 * SQ, dos + warp * 16 * SV,
                             kst, vst, lane);

    // element e of block j: row lane/4 + 8·(e/2), key k0 + 8j +
    // 2·(lane%4) + e%2
    const int k_first = kt * TC_KEYS, kt_last = k_first + TC_KEYS - 1;
    const bool all_valid = r0 + TC_ROWS <= rows && kt_last < tk &&
                           (!causal || kt_last <= q_first) &&
                           (window <= 0 || q_last - k_first < window);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool valid = true;
        if (!all_valid) {
          const int kpos = k_first + 8 * j + 2 * (lane % 4) + e % 2;
          const int qp = qpos[e / 2];
          valid = qp >= 0 && kpos < tk;
          if (causal) valid = valid && qp >= kpos;
          if (window > 0) valid = valid && qp - kpos < window;
        }
        p_and_ds_tc(s[j][e], dp[j][e], l[e / 2], dd[e / 2], scale, valid);
      }

    // dQ += dS·K (scaled at the end)
    add_product<HD, NK>(acc, dp, kst, lane);
    __syncthreads();  // this stage is read; the next prefetch may land here
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + lane / 4 + 8 * i;
    if (r >= rows) continue;
    bf16_t* row = dq + (((size_t)b * tq + r / g) * h + kvh * g + r % g) * HD +
                2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * n) = __floats2bfloat162_rn(
          scale * acc[n][2 * i], scale * acc[n][2 * i + 1]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// cudaFuncSetAttribute once per device (a bit per device it was set on)
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, uint64_t& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (configured & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) configured |= bit;
  return err;
}

template <typename T, int HD, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int64_t b, int64_t tq, int64_t tk, int64_t h,
           int64_t kv, int causal, int64_t window, float scale,
           cudaStream_t st) {
  static uint64_t dkv_configured = 0, dq_configured = 0;
  const size_t dkv_smem = Tiles<HD, DV>::bytes(2),
               dq_smem = Tiles<HD, DV>::bytes(1);
  cudaError_t err = allow_smem(attn_bwd_dkv_kernel<T, HD, DV>, dkv_smem,
                               dkv_configured);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attn_bwd_dq_kernel<T, HD, DV>, dq_smem, dq_configured);
  if (err != cudaSuccess) return (int)err;

  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t n_rows = b * tq * h;
  attn_bwd_delta_kernel<T, DV>
      <<<(unsigned)((n_rows + DELTA_ROWS - 1) / DELTA_ROWS), THREADS, 0, st>>>(
          static_cast<const T*>(o), dot, delta, (int)tq, (int)h, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 dkv_grid((unsigned)((tk + BK - 1) / BK), (unsigned)kv,
                      (unsigned)b);
  attn_bwd_dkv_kernel<T, HD, DV><<<dkv_grid, THREADS, dkv_smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      (int)tq, (int)tk, (int)h, (int)kv, causal, (int)window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t rows = tq * (h / kv);
  const dim3 dq_grid((unsigned)((rows + BQ - 1) / BQ), (unsigned)kv,
                     (unsigned)b);
  attn_bwd_dq_kernel<T, HD, DV><<<dq_grid, THREADS, dq_smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), (int)tq, (int)tk,
      (int)h, (int)kv, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

template <int HD, int DV>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int64_t b, int64_t tq, int64_t tk,
                int64_t h, int64_t kv, int causal, int64_t window,
                float scale, cudaStream_t st) {
  static uint64_t dkv_configured = 0, dq_configured = 0;
  constexpr size_t dkv_smem = dkv_smem_bytes<HD, DV>(),
                   dq_smem = dq_smem_bytes<HD, DV>();
  cudaError_t err = allow_smem(attn_bwd_dkv_bf16_kernel<HD, DV>, dkv_smem,
                               dkv_configured);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attn_bwd_dq_bf16_kernel<HD, DV>, dq_smem, dq_configured);
  if (err != cudaSuccess) return (int)err;
  // one-dimensional grids, the (kv head, batch) pair fastest
  const int64_t pairs = kv * b;
  const int64_t dkv_blocks = (tk + TC_KEYS - 1) / TC_KEYS * pairs;
  const int64_t dq_blocks = (tq * (h / kv) + TC_ROWS - 1) / TC_ROWS * pairs;
  if (dkv_blocks > 0x7fffffff || dq_blocks > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;

  const bf16_t* qt = static_cast<const bf16_t*>(q);
  const bf16_t* kt = static_cast<const bf16_t*>(k);
  const bf16_t* vt = static_cast<const bf16_t*>(v);
  const bf16_t* dot = static_cast<const bf16_t*>(dout);
  const int64_t n_rows = b * tq * h;
  attn_bwd_delta_kernel<bf16_t, DV>
      <<<(unsigned)((n_rows + DELTA_ROWS - 1) / DELTA_ROWS), THREADS, 0, st>>>(
          static_cast<const bf16_t*>(o), dot, delta, (int)tq, (int)h, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  attn_bwd_dkv_bf16_kernel<HD, DV><<<(unsigned)dkv_blocks, TC_THREADS,
                                     dkv_smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16_t*>(dk),
      static_cast<bf16_t*>(dv), (int)tq, (int)tk, (int)h, (int)kv, (int)b,
      causal, (int)window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  attn_bwd_dq_bf16_kernel<HD, DV><<<(unsigned)dq_blocks, TC_THREADS,
                                    dq_smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16_t*>(dq), (int)tq, (int)tk,
      (int)h, (int)kv, (int)b, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

template <int HD, int DV>
int launch_dtype(int bf16, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, int64_t b,
                 int64_t tq, int64_t tk, int64_t h, int64_t kv, int causal,
                 int64_t window, float scale, cudaStream_t st) {
  return bf16 ? launch_bf16<HD, DV>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                    b, tq, tk, h, kv, causal, window, scale,
                                    st)
              : launch<float, HD, DV>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, b, tq, tk, h, kv, causal, window,
                                      scale, st);
}

}  // namespace

extern "C" int flash_attn_bwd_f32(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv,
                                  int bf16, int64_t b, int64_t tq,
                                  int64_t tk, int64_t h, int64_t kv,
                                  int64_t hd, int64_t dv_dim, int causal,
                                  int64_t window, float scale,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  if (hd == 192 && dv_dim == 128)  // MLA: q/k nope 128 + rope 64, v 128
    return launch_dtype<192, 128>(bf16, q, k, v, o, dout, l, d, dq, dk, dv, b,
                                  tq, tk, h, kv, causal, window, scale, st);
  if (hd == 48 && dv_dim == 32)  // MLA at deepseek-v2-lite-16b's reduced()
    return launch_dtype<48, 32>(bf16, q, k, v, o, dout, l, d, dq, dk, dv, b,
                                tq, tk, h, kv, causal, window, scale, st);
  if (hd != dv_dim) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch_dtype<32, 32>(bf16, q, k, v, o, dout, l, d, dq, dk,
                                  dv, b, tq, tk, h, kv, causal, window, scale,
                                  st);
    case 64:
      return launch_dtype<64, 64>(bf16, q, k, v, o, dout, l, d, dq, dk,
                                  dv, b, tq, tk, h, kv, causal, window, scale,
                                  st);
    case 112:
      return launch_dtype<112, 112>(bf16, q, k, v, o, dout, l, d, dq, dk,
                                    dv, b, tq, tk, h, kv, causal, window, scale,
                                    st);
    case 128:
      return launch_dtype<128, 128>(bf16, q, k, v, o, dout, l, d, dq, dk,
                                    dv, b, tq, tk, h, kv, causal, window, scale,
                                    st);
    default: return (int)cudaErrorInvalidValue;
  }
}
