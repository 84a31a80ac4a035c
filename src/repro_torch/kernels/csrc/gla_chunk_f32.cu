// Chunked gated linear attention (GLA), forward, for Hopper (sm_90a): the
// shared core of Mamba2 (scalar decay per head) and RWKV6 (per-channel
// decay, "pre" convention with a current-token bonus), f32 state and
// accumulators, q/k/v in bf16 or f32.
//
//   q, k (B, T, H, K); v (B, T, H, V); log_decay (B, T, H) or (B, T, H, K),
//   f32, every entry ≤ 0; bonus (H, K) f32 or none; initial state
//   (B, H, K, V) f32 or none  →  y (B, T, H, V) in v's dtype, final state
//   (B, H, K, V) f32
//
// Replaces: src/repro/kernels/chunk_scan.py:gla_chunk_pallas (body
// _chunk_kernel) together with the host lax.scan over chunks of
// src/repro/kernels/ops.py:gla_chunked. Per chunk of L tokens it computes
// what the Pallas kernel computes: lc, the inclusive running sum of the
// log decay inside the chunk (lq = lc, or lc shifted by one under "pre");
// y = (q ⊙ e^{lq})·S + (masked scores)·v [+ (q ⊙ u ⊙ k)·1 ⊙ v under
// "pre"], with scores q_i·k_j·e^{lq_i − lc_j} (scalar) or
// Σ_k q_ik k_jk e^{lq_ik − lc_jk} (per channel) for j ≤ i (j < i under
// "pre"); then S ← S ⊙ e^{lc_L} + (k ⊙ e^{lc_L − lc})ᵀ v. Every exponent is
// a difference ≤ 0, taken as one expf, never as e^{lq}·e^{−lc}; a masked
// pair gives 0 without an exponential. A ragged tail (T % L ≠ 0) reads
// k = v = q = 0 and log_decay = 0, the plain version's inert padding.
//
// Design: one launch per layer call. The TPU kernel runs one chunk for all
// (b, h) and the host scans the chunks; here one block owns one (b, h) and
// walks its T / L chunks in order with S (K×V f32) resident in shared
// memory, so the host loop becomes the block's own loop. Strided reads in
// the model's (B, T, H, ·) layout: any batch, time and head stride
// (Mamba2's q and k are its B and C broadcast over the heads: head stride
// 0), unit stride in the last dim. Per chunk, 256 threads as 16×16 stage
// q, k, v, the decay sums and the L×L scores in shared memory (rows padded
// to K + 1 and L + 1: no bank conflicts) and compute each product as
// register tiles, f32 FFMA; no tensor cores.
//
// Bound on an H100 SXM: operations. Per chunk and (b, h) the four
// products cost 2·L·K·V (inter) + L²·K (scores, half of them masked) +
// L²·V (intra) + 2·L·K·V (state) FLOP and the per-channel scores L²·K/2
// exponentials, against 2 bytes a bf16 q/k/v element read once and 4 a
// decay: at K = V = 64 that is ~35 FLOP a byte for rwkv6-7b and ~110 for
// zamba2-7b (its q and k are read once for all heads), above the f32
// ridge of 20 FLOP a byte. Instances: chunk capacity 32 (RWKV6) and 128
// (Mamba2's chunk, or any chunk of 33–128), scalar or per-channel decay,
// bf16 or f32.
//
// Plain C interface for ctypes; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int G = 16;        // row threads of a register tile
constexpr int C = 16;        // column threads
constexpr int MAX_KV = 64;   // largest K and V

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ld;
  const float* bonus;   // null: "post" convention, no bonus
  const float* s0;      // null: zero initial state
  void* y;
  float* s_out;
  int64_t t_len;
  int h, kd, vd, chunk;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t l_sb, l_st, l_sh;
};

// floats of dynamic shared memory for a chunk capacity LT (at most 216 KB:
// LT = 128, K = V = 64, per channel)
inline size_t smem_floats(int lt, int kd, int vd,
                                              bool per_channel) {
  const size_t k1 = kd + 1;
  return (size_t)kd * vd + 2 * lt * k1 + (size_t)lt * vd +
         (per_channel ? lt * k1 : lt) + (size_t)lt * (lt + 1) + lt + kd;
}

template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(THREADS) gla_chunk_kernel(Args a) {
  extern __shared__ float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk, k1 = kd + 1;
  constexpr int LP = LT + 1;
  float* S = sm;                          // [K][V]
  float* qs = S + kd * vd;                // [LT][K + 1]: q, then q ⊙ e^{lq}
  float* ks = qs + LT * k1;               // [LT][K + 1]: k, then k ⊙ e^{lc_L − lc}
  float* vs = ks + LT * k1;               // [LT][V]
  float* lcs = vs + LT * vd;              // [LT][K + 1] or [LT]
  float* sc = lcs + (PERCH ? LT * k1 : LT);  // [LT][LT + 1]
  float* dg = sc + LT * LP;               // [LT] bonus diagonal
  float* us = dg + LT;                    // [K] bonus

  const int tid = threadIdx.x;
  const int g = tid / C, c = tid % C;
  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const bool pre = a.bonus != nullptr;
  const int64_t t_len = a.t_len;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hh * a.v_sh;
  const float* ld = a.ld + b * a.l_sb + hh * a.l_sh;
  T* y = static_cast<T*>(a.y) + ((size_t)b * t_len * a.h + hh) * vd;
  const int64_t y_st = (int64_t)a.h * vd;

  for (int i = tid; i < kd * vd; i += THREADS)
    S[i] = a.s0 ? a.s0[(size_t)bh * kd * vd + i] : 0.f;
  if (pre)
    for (int i = tid; i < kd; i += THREADS) us[i] = a.bonus[(size_t)hh * kd + i];

  const int64_t n_chunks = (t_len + len - 1) / len;
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    const int64_t t0 = ch * len;

    // 1. stage the chunk, zero past T
    for (int i = tid; i < len * kd; i += THREADS) {
      const int r = i / kd, kk = i % kd;
      const int64_t t = t0 + r;
      const bool ok = t < t_len;
      qs[r * k1 + kk] = ok ? to_f32(q[t * a.q_st + kk]) : 0.f;
      ks[r * k1 + kk] = ok ? to_f32(k[t * a.k_st + kk]) : 0.f;
      if (PERCH) lcs[r * k1 + kk] = ok ? ld[t * a.l_st + kk] : 0.f;
    }
    for (int i = tid; i < len * vd; i += THREADS) {
      const int r = i / vd, vv = i % vd;
      const int64_t t = t0 + r;
      vs[r * vd + vv] = t < t_len ? to_f32(v[t * a.v_st + vv]) : 0.f;
    }
    if (!PERCH)
      for (int r = tid; r < len; r += THREADS)
        lcs[r] = t0 + r < t_len ? ld[(t0 + r) * a.l_st] : 0.f;
    __syncthreads();

    // 2. inclusive running sums of the log decay, in token order
    if (PERCH) {
      for (int kk = tid; kk < kd; kk += THREADS) {
        float acc = 0.f;
        for (int r = 0; r < len; ++r) {
          acc += lcs[r * k1 + kk];
          lcs[r * k1 + kk] = acc;
        }
      }
    } else if (tid == 0) {
      float acc = 0.f;
      for (int r = 0; r < len; ++r) {
        acc += lcs[r];
        lcs[r] = acc;
      }
    }
    __syncthreads();

    // 3. masked intra-chunk scores (rows g + 16·r, columns c + 16·s)
    {
      constexpr int R = LT / G;
      // pair (g + 16·r, c + 16·s) lies inside the chunk and the mask
      auto valid = [&](int r, int s) {
        const int i = g + r * G, j = c + s * C;
        return i < len && j < len && (pre ? j < i : j <= i);
      };
      float acc[R][R];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < R; ++s) acc[r][s] = 0.f;
      for (int p = 0; p < kd; ++p) {
        float qa[R], ka[R], la[R], lb[R];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int i = min(g + r * G, len - 1);
          qa[r] = qs[i * k1 + p];
          if (PERCH)
            la[r] = pre ? (i ? lcs[(i - 1) * k1 + p] : 0.f) : lcs[i * k1 + p];
        }
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int j = min(c + s * C, len - 1);
          ka[s] = ks[j * k1 + p];
          if (PERCH) lb[s] = lcs[j * k1 + p];
        }
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int s = 0; s < R; ++s) {
            if (PERCH) {
              if (valid(r, s))
                acc[r][s] = fmaf(qa[r] * ka[s], expf(la[r] - lb[s]),
                                 acc[r][s]);
            } else {
              acc[r][s] = fmaf(qa[r], ka[s], acc[r][s]);
            }
          }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int i = g + r * G, j = c + s * C;
          if (i < len && j < len) {
            float val = 0.f;
            if (valid(r, s)) {
              val = acc[r][s];
              if (!PERCH)
                val *= expf((pre ? (i ? lcs[i - 1] : 0.f) : lcs[i]) - lcs[j]);
            }
            sc[i * LP + j] = val;
          }
        }
      if (pre)
        for (int i = tid; i < len; i += THREADS) {
          float d = 0.f;
          for (int p = 0; p < kd; ++p)
            d = fmaf(qs[i * k1 + p] * us[p], ks[i * k1 + p], d);
          dg[i] = d;
        }
    }
    __syncthreads();

    // 4. q ⊙ e^{lq} and k ⊙ e^{lc_L − lc}, in place
    for (int i = tid; i < len * kd; i += THREADS) {
      const int r = i / kd, kk = i % kd;
      float lq, lc, last;
      if (PERCH) {
        lc = lcs[r * k1 + kk];
        lq = pre ? (r ? lcs[(r - 1) * k1 + kk] : 0.f) : lc;
        last = lcs[(len - 1) * k1 + kk];
      } else {
        lc = lcs[r];
        lq = pre ? (r ? lcs[r - 1] : 0.f) : lc;
        last = lcs[len - 1];
      }
      qs[r * k1 + kk] *= expf(lq);
      ks[r * k1 + kk] *= expf(last - lc);
    }
    __syncthreads();

    // 5. y = (q ⊙ e^{lq})·S + scores·v [+ bonus diagonal ⊙ v]
    {
      constexpr int RY = LT / G, RV = MAX_KV / C;
      float acc[RY][RV];
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int s = 0; s < RV; ++s) acc[r][s] = 0.f;
      for (int p = 0; p < kd; ++p) {
        float xa[RY], xb[RV];
#pragma unroll
        for (int r = 0; r < RY; ++r)
          xa[r] = qs[min(g + r * G, len - 1) * k1 + p];
#pragma unroll
        for (int s = 0; s < RV; ++s) xb[s] = S[p * vd + min(c + s * C, vd - 1)];
#pragma unroll
        for (int r = 0; r < RY; ++r)
#pragma unroll
          for (int s = 0; s < RV; ++s) acc[r][s] = fmaf(xa[r], xb[s], acc[r][s]);
      }
      for (int j = 0; j < len; ++j) {
        float xa[RY], xb[RV];
#pragma unroll
        for (int r = 0; r < RY; ++r) xa[r] = sc[min(g + r * G, len - 1) * LP + j];
#pragma unroll
        for (int s = 0; s < RV; ++s) xb[s] = vs[j * vd + min(c + s * C, vd - 1)];
#pragma unroll
        for (int r = 0; r < RY; ++r)
#pragma unroll
          for (int s = 0; s < RV; ++s) acc[r][s] = fmaf(xa[r], xb[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int s = 0; s < RV; ++s) {
          const int i = g + r * G, vv = c + s * C;
          if (i < len && vv < vd && t0 + i < t_len) {
            float val = acc[r][s];
            if (pre) val = fmaf(dg[i], vs[i * vd + vv], val);
            y[(t0 + i) * y_st + vv] = from_f32<T>(val);
          }
        }
    }
    __syncthreads();

    // 6. S ← S ⊙ e^{lc_L} + (k ⊙ e^{lc_L − lc})ᵀ v
    {
      constexpr int RK = MAX_KV / G, RV = MAX_KV / C;
      float acc[RK][RV];
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int s = 0; s < RV; ++s) acc[r][s] = 0.f;
      for (int j = 0; j < len; ++j) {
        float xa[RK], xb[RV];
#pragma unroll
        for (int r = 0; r < RK; ++r) xa[r] = ks[j * k1 + min(g + r * G, kd - 1)];
#pragma unroll
        for (int s = 0; s < RV; ++s) xb[s] = vs[j * vd + min(c + s * C, vd - 1)];
#pragma unroll
        for (int r = 0; r < RK; ++r)
#pragma unroll
          for (int s = 0; s < RV; ++s) acc[r][s] = fmaf(xa[r], xb[s], acc[r][s]);
      }
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        const int kk = g + r * G;
        if (kk >= kd) continue;
        const float decay =
            expf(PERCH ? lcs[(len - 1) * k1 + kk] : lcs[len - 1]);
#pragma unroll
        for (int s = 0; s < RV; ++s) {
          const int vv = c + s * C;
          if (vv < vd) S[kk * vd + vv] = fmaf(S[kk * vd + vv], decay, acc[r][s]);
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < kd * vd; i += THREADS)
    a.s_out[(size_t)bh * kd * vd + i] = S[i];
}

template <typename T, int LT, bool PERCH>
int launch(const Args& a, int64_t n_blocks, cudaStream_t st) {
  // the attribute is per device: one bit per device it was set on, to the
  // device's opt-in limit (the smem a call needs depends on K and V)
  static uint64_t configured = 0;
  static int max_smem[64];
  const size_t smem = smem_floats(LT, a.kd, a.vd, PERCH) * sizeof(float);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  const uint64_t bit = uint64_t(1) << dev;
  if (!(configured & bit)) {
    err = cudaDeviceGetAttribute(&max_smem[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(gla_chunk_kernel<T, LT, PERCH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem[dev]);
    if (err != cudaSuccess) return (int)err;
    configured |= bit;
  }
  if (smem > (size_t)max_smem[dev]) return (int)cudaErrorInvalidValue;
  gla_chunk_kernel<T, LT, PERCH><<<(unsigned)n_blocks, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool PERCH>
int dispatch_len(const Args& a, int64_t n_blocks, cudaStream_t st) {
  // RWKV6 chunks by 32, Mamba2 by its config's 128 (or a shorter T)
  if (a.chunk <= 32) return launch<T, 32, PERCH>(a, n_blocks, st);
  if (a.chunk <= 128) return launch<T, 128, PERCH>(a, n_blocks, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int gla_chunk_f32(
    const void* q, const void* k, const void* v, const float* ld,
    const float* bonus, const float* s0, void* y, float* s_out, int bf16,
    int per_channel, int64_t b, int64_t t_len, int64_t h, int64_t kd,
    int64_t vd, int64_t chunk, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides,
    const int64_t* l_strides, void* stream) {
  if (kd < 1 || kd > MAX_KV || vd < 1 || vd > MAX_KV || chunk < 1 ||
      chunk > 128 || b < 1 || h < 1 || t_len < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.ld = ld; a.bonus = bonus; a.s0 = s0;
  a.y = y; a.s_out = s_out; a.t_len = t_len; a.h = (int)h;
  a.kd = (int)kd; a.vd = (int)vd; a.chunk = (int)chunk;
  a.q_sb = q_strides[0]; a.q_st = q_strides[1]; a.q_sh = q_strides[2];
  a.k_sb = k_strides[0]; a.k_st = k_strides[1]; a.k_sh = k_strides[2];
  a.v_sb = v_strides[0]; a.v_st = v_strides[1]; a.v_sh = v_strides[2];
  a.l_sb = l_strides[0]; a.l_st = l_strides[1]; a.l_sh = l_strides[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_blocks = b * h;
  if (bf16)
    return per_channel ? dispatch_len<__nv_bfloat16, true>(a, n_blocks, st)
                       : dispatch_len<__nv_bfloat16, false>(a, n_blocks, st);
  return per_channel ? dispatch_len<float, true>(a, n_blocks, st)
                     : dispatch_len<float, false>(a, n_blocks, st);
}
