// Flash attention, backward, for Hopper (sm_90a): the gradients of the
// causal or sliding-window GQA softmax attention that flash_attn_f32.cu
// computes forward, inputs and outputs in bf16 or f32, f32 arithmetic.
//
//   q, out, dout (B, Tq, H, hd); k, v (B, Tk, KV, hd); lse (B, H, Tq) f32
//   from the forward (+inf on a row with no valid key)
//   → dq (B, Tq, H, hd), dk, dv (B, Tk, KV, hd) in the inputs' dtype
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
// S the scaled scores (scale·q)·kᵀ, as the forward's f32 path computes
// them (for f32 inputs the very same FFMA chain), and the masks the
// forward's: a key at or past Tk, after the query (causal), or `window` or
// more positions before it is invalid. A row with lse = +inf gets P = 0:
// its dq is 0 and it adds nothing to dk and dv (ROADMAP C7).
//
// Three kernels, each deterministic: no atomics; every sum is taken by one
// thread in a fixed order.
//  * Δ: D[b, h, t] = Σ_d dO·O, one warp a row, a fixed shuffle tree.
//  * dK/dV: a block owns (batch, kv head, 64 keys) and walks the query
//    tiles of 64 rows that can see them. A row is a (position, query
//    head) pair of the kv head's group, position-major, as the forward's
//    bf16 path orders them, so the sum over the group's heads happens
//    inside the block, in row order, and dK, dV are written once. Query
//    positions before the tile (causal) or `window` or more past its last
//    key are skipped: they add exactly nothing.
//  * dQ: a block owns (batch, kv head, 64 rows) and walks the key tiles
//    the forward walks for them (the same skipping rule); it recomputes S
//    and dP, the price of writing dQ without atomics.
// Per tile, each block stages its operands in shared memory as f32 (bf16
// widened on load), computes S and dP for 64 × 64 (row, key) pairs (each
// of 256 threads a 4 × 4 set: rows a + 16i, keys b + 16j, so that a warp
// reads 16 different rows of the K/V tile, on 16 banks), writes P and dS
// to shared memory and takes the tile's products into registers from 0,
// ≤ 64 FFMA terms in f32; each tile's sum is then added to a running sum
// kept in f64, rounded to f32 (and to bf16) once at the end. So a
// gradient element carries the rounding of one 64-term f32 sum a tile,
// whatever the number n of rows (or keys) it sums over: at T = 2,048 and
// a group of 4, dK and dV sum 8,192 rows, and an f32 running sum over
// their 128 tiles would add the rounding of 128 more additions at the
// running sum's magnitude (the early keys' columns, which every query
// sees, are the largest). The f64 adds are 4·hd/16 a thread a tile.
//
// Bound on an H100 SXM: 10·hd FLOP per valid (query, key) pair (S twice,
// dP twice, dV, dK, dQ: 2·hd each, FFMA counted as 2) at 67 TFLOP/s f32
// (this kernel stays off the tensor cores for bf16 as well, so 989 TFLOP/s
// there is a bound it cannot approach), against the bytes of q, k, v, out,
// dout, lse, D, dq, dk and dv at 3.35 TB/s. A simple design: FFMA from
// shared memory, one 64 × 64 tile at a time; the FlashAttention-2/3
// shapes (mma.sync or wgmma, K/V double-buffered) are later work.
//
// Plain C interface for ctypes; returns cudaGetLastError(). `delta` is an
// f32 (B, H, Tq) workspace the wrapper allocates.
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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ---------------------------------------------------------------------------
// Δ = rowsum(dO∘O)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
attn_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ delta, int tq, int h,
                      int64_t n_rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * DELTA_ROWS + warp;  // (b, t, h)
  if (row >= n_rows) return;
  float acc = 0.f;
  for (int c = lane; c < HD; c += 32)
    acc = fmaf(to_f32(dout[row * HD + c]), to_f32(o[row * HD + c]), acc);
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
// shared tiles and the (S, dP) → (P, dS) step both kernels share
// ---------------------------------------------------------------------------

template <int HD>
struct Tiles {
  static constexpr int LD = HD + 1;  // f32 per shared row of a (·, hd) tile
  static constexpr int NC = HD / 16;  // output columns a thread: b + 16j
  static constexpr size_t bytes(int n_ps) {
    // Q (scaled), dO, K, V; n_ps tiles of (row, key); lse, D, position
    return sizeof(float) * ((size_t)(2 * BQ + 2 * BK) * LD +
                            (size_t)n_ps * BQ * PS + 3 * BQ);
  }
};

// rows [r0, r0 + BQ) of kv head `kvh`'s group: row r is position r / g of
// query head kvh·g + r % g. Q is stored scaled, dO as it is; rows past the
// last read 0 and are marked invalid (position −1).
template <typename T, int HD>
__device__ void load_rows(float* qs, float* dos, float* lse_s, float* d_s,
                          int* pos_s, const T* __restrict__ q,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta, int b, int kvh,
                          int g, int h, int tq, int r0, float scale) {
  constexpr int LD = Tiles<HD>::LD;
  const int rows = tq * g;
  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int row = i / HD, c = i % HD, r = r0 + row;
    float x = 0.f, dx = 0.f;
    if (r < rows) {
      const size_t off =
          (((size_t)b * tq + r / g) * h + kvh * g + r % g) * HD + c;
      x = to_f32(q[off]) * scale;
      dx = to_f32(dout[off]);
    }
    qs[row * LD + c] = x;
    dos[row * LD + c] = dx;
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
template <typename T, int HD>
__device__ void load_keys(float* ks, float* vs, const T* __restrict__ k,
                          const T* __restrict__ v, int b, int kvh, int kv,
                          int tk, int k0) {
  constexpr int LD = Tiles<HD>::LD;
  for (int i = threadIdx.x; i < BK * HD; i += THREADS) {
    const int key = i / HD, c = i % HD, kpos = k0 + key;
    float kx = 0.f, vx = 0.f;
    if (kpos < tk) {
      const size_t off = (((size_t)b * tk + kpos) * kv + kvh) * HD + c;
      kx = to_f32(k[off]);
      vx = to_f32(v[off]);
    }
    ks[key * LD + c] = kx;
    vs[key * LD + c] = vx;
  }
}

// This thread's 4 × 4 (row, key) pairs of the staged tiles, rows a + 16i
// and keys b + 16j: P = exp(S − lse) (0 on an invalid pair) into p and
// dS = P∘(dP − D) into ds.
template <int HD>
__device__ __forceinline__ void p_and_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* d_s, const int* pos_s, int a, int bc,
    int k0, int tk, int causal, int window, float (&p)[4][4],
    float (&ds)[4][4]) {
  constexpr int LD = Tiles<HD>::LD;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
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

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int tq, int tk, int h, int kv,
                    int causal, int window, float scale) {
  using TL = Tiles<HD>;
  constexpr int LD = TL::LD, NC = TL::NC;
  static_assert(HD % 16 == 0, "head dim in steps of 16 columns");
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* ps = vs + BK * LD;   // [BQ][PS]
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

  load_keys<T, HD>(ks, vs, k, v, b, kvh, kv, tk, k0);
  double acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc_k[i][j] = acc_v[i][j] = 0.0;

  for (int r0 = r_begin; r0 < r_end; r0 += BQ) {
    __syncthreads();  // the last tile's Q, dO, P and dS are read
    load_rows<T, HD>(qs, dos, lse_s, d_s, pos_s, q, dout, lse, delta, b, kvh,
                     g, h, tq, r0, scale);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HD>(qs, dos, ks, vs, lse_s, d_s, pos_s, a, bc, k0, tk, causal,
                 window, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ps[(a + 16 * i) * PS + bc + 16 * j] = p[i][j];
        dss[(a + 16 * i) * PS + bc + 16 * j] = ds[i][j];
      }
    __syncthreads();
    // the tile's Pᵀ·dO and dSᵀ·(scale·Q) for keys a + 16i, columns
    // bc + 16j, from 0, then into the running sums
    float tv[4][NC], tk_[4][NC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) tv[i][j] = tk_[i][j] = 0.f;
    for (int row = 0; row < BQ; ++row) {
      float pk[4], dsk[4], dov[NC], qv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pk[i] = ps[row * PS + a + 16 * i];
        dsk[i] = dss[row * PS + a + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        dov[j] = dos[row * LD + bc + 16 * j];
        qv[j] = qs[row * LD + bc + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          tv[i][j] = fmaf(pk[i], dov[j], tv[i][j]);
          tk_[i][j] = fmaf(dsk[i], qv[j], tk_[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        acc_v[i][j] += (double)tv[i][j];
        acc_k[i][j] += (double)tk_[i][j];
      }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + a + 16 * i;
    if (kpos >= tk) continue;
    const size_t base = (((size_t)b * tk + kpos) * kv + kvh) * HD + bc;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[base + 16 * j] = from_f32<T>((float)acc_k[i][j]);
      dv[base + 16 * j] = from_f32<T>((float)acc_v[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: a block a (row tile, kv head, batch)
// ---------------------------------------------------------------------------

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dq,
                   int tq, int tk, int h, int kv, int causal, int window,
                   float scale) {
  using TL = Tiles<HD>;
  constexpr int LD = TL::LD, NC = TL::NC;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BQ * LD;
  float* ks = dos + BQ * LD;
  float* vs = ks + BK * LD;
  float* dss = vs + BK * LD;  // [BQ][PS]
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

  load_rows<T, HD>(qs, dos, lse_s, d_s, pos_s, q, dout, lse, delta, b, kvh,
                   g, h, tq, r0, scale);
  double acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the last tile's K and dS are read
    load_keys<T, HD>(ks, vs, k, v, b, kvh, kv, tk, k0);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds<HD>(qs, dos, ks, vs, lse_s, d_s, pos_s, a, bc, k0, tk, causal,
                 window, p, ds);
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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int64_t b, int64_t tq, int64_t tk, int64_t h,
           int64_t kv, int causal, int64_t window, float scale,
           cudaStream_t st) {
  static uint64_t dkv_configured = 0, dq_configured = 0;
  const size_t dkv_smem = Tiles<HD>::bytes(2), dq_smem = Tiles<HD>::bytes(1);
  cudaError_t err = allow_smem(attn_bwd_dkv_kernel<T, HD>, dkv_smem,
                               dkv_configured);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(attn_bwd_dq_kernel<T, HD>, dq_smem, dq_configured);
  if (err != cudaSuccess) return (int)err;

  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int64_t n_rows = b * tq * h;
  attn_bwd_delta_kernel<T, HD>
      <<<(unsigned)((n_rows + DELTA_ROWS - 1) / DELTA_ROWS), THREADS, 0, st>>>(
          static_cast<const T*>(o), dot, delta, (int)tq, (int)h, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 dkv_grid((unsigned)((tk + BK - 1) / BK), (unsigned)kv,
                      (unsigned)b);
  attn_bwd_dkv_kernel<T, HD><<<dkv_grid, THREADS, dkv_smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      (int)tq, (int)tk, (int)h, (int)kv, causal, (int)window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int64_t rows = tq * (h / kv);
  const dim3 dq_grid((unsigned)((rows + BQ - 1) / BQ), (unsigned)kv,
                     (unsigned)b);
  attn_bwd_dq_kernel<T, HD><<<dq_grid, THREADS, dq_smem, st>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), (int)tq, (int)tk,
      (int)h, (int)kv, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dtype(int bf16, const void* q, const void* k, const void* v,
                 const void* o, const void* dout, const float* lse,
                 float* delta, void* dq, void* dk, void* dv, int64_t b,
                 int64_t tq, int64_t tk, int64_t h, int64_t kv, int causal,
                 int64_t window, float scale, cudaStream_t st) {
  return bf16 ? launch<__nv_bfloat16, HD>(q, k, v, o, dout, lse, delta, dq,
                                          dk, dv, b, tq, tk, h, kv, causal,
                                          window, scale, st)
              : launch<float, HD>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  b, tq, tk, h, kv, causal, window, scale,
                                  st);
}

}  // namespace

extern "C" int flash_attn_bwd_f32(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv,
                                  int bf16, int64_t b, int64_t tq,
                                  int64_t tk, int64_t h, int64_t kv,
                                  int64_t hd, int causal, int64_t window,
                                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (hd) {
    case 32:
      return launch_dtype<32>(bf16, q, k, v, o, dout, l, d, dq, dk, dv, b,
                              tq, tk, h, kv, causal, window, scale, st);
    case 64:
      return launch_dtype<64>(bf16, q, k, v, o, dout, l, d, dq, dk, dv, b,
                              tq, tk, h, kv, causal, window, scale, st);
    case 112:
      return launch_dtype<112>(bf16, q, k, v, o, dout, l, d, dq, dk, dv, b,
                               tq, tk, h, kv, causal, window, scale, st);
    case 128:
      return launch_dtype<128>(bf16, q, k, v, o, dout, l, d, dq, dk, dv, b,
                               tq, tk, h, kv, causal, window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
