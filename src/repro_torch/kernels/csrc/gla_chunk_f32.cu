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
// Design: the chunk-parallel form (as FLA's chunk_gla and Mamba2's SSD),
// two launches a call on the caller's stream, the second a programmatic
// dependent launch of the first.
//
// (a) gla_state_kernel, grid (B·H, chunks): a block stages its chunk
//     (cp.async), forms lc, k ⊙ e^{lc_L − lc} and the chunk's contribution
//     U_c = (k ⊙ e^{lc_L − lc})ᵀ v (K × V, 4 × 4 a thread, FFMA) and its
//     decay d_c = e^{lc_L}, and stores both to workspaces the wrapper
//     allocates. The last block of each (b, h), found with an integer
//     atomic on its counter (reset by that block: no memset launch), runs
//     S_{c+1} = S_c ⊙ d_c + U_c over the chunks in order, storing each S_c,
//     the state chunk c enters with, over U_c, and the final state. The
//     blocks trigger `griddepcontrol.launch_dependents` as they start.
// (b) the output pass, a block a chunk: it stages the chunk's k, v and
//     log decay once, forms the masked scores and scores·v of its query
//     rows, and waits (`griddepcontrol.wait`: (a) has completed and its
//     stores are visible) only before it first reads S_c, to add
//     (q ⊙ e^{lq})·S_c [and the bonus diagonal].
//     - bf16 inputs, scalar decay under "post" (Mamba2),
//       gla_output_mma_kernel: a block a chunk, a warp per 16 query rows,
//       on the tensor cores (mma.sync.m16n8k16 bf16 → f32): q·kᵀ, then P·v
//       over blocks of 16 keys up to the warp's last row, then q·S_c
//       scaled by e^{lc_i}. q, k and v enter as one term each (bf16 values
//       exactly); P and S_c, f32, as their exact three-term bf16 splits,
//       the products whose term orders sum to ≤ 2 kept.
//     - Otherwise, gla_output_kernel: the chunk's query rows 32 at a
//       time, f32 FFMA on register tiles fed by float4 reads of shared
//       memory; each pair's per-channel exponent is one expf. f32 inputs
//       stay here: on the tensor cores (three terms each) the f32
//       zamba2-7b prefill read 1.17e-4 against the plain GLA through the
//       full depth on an H100 (phase 14's tolerance: 1e-4). So does
//       per-channel decay: on the tensor cores, by sub-chunks of 16 rows
//       with a reference point between each sub-chunk and the keys before
//       it (tests/test_torch_gla_chunked_form.py emulates the split), the
//       bf16 rwkv6-7b layer call was slower on an H100 (0.2345 against
//       0.2014 ms), most of it in q ⊙ e^{lq} times S_c in three terms
//       each, which has to wait for the state pass.
//     rwkv6-7b's layer call (B 2, H 64, T 512, L 32) runs 2,048 state and
//     2,048 output blocks; zamba2-7b's (H 112, L 128) 896 of each.
//
// Numerics: the state stays f32 (FFMA); rounding k ⊙ e^{lc_L − lc} once to
// bf16 would miss the state tolerance L·K·2⁻²³ (phase 13), and the split
// products stay within it (tests/test_torch_gla_chunked_form.py emulates
// both). Each sum runs in a fixed order, no float atomics: a call
// repeated is bitwise equal.
//
// Bound on an H100 SXM: operations. Per chunk and (b, h) the four
// products cost 2·L·K·V (inter) + L²·K (scores, half of them masked) +
// L²·V (intra) + 2·L·K·V (state) FLOP and the per-channel scores L²·K/2
// exponentials, against 2 bytes a bf16 q/k/v element read once and 4 a
// decay; the workspaces add 8·K·V bytes a chunk and (b, h) (U_c written
// and read, S_c written and read). Instances: chunk capacity 32 (RWKV6)
// and 128 (Mamba2's chunk, or any chunk of 33–128), scalar or per-channel
// decay, bf16 or f32.
//
// Plain C interface for ctypes; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_KV = 64;     // largest K and V
constexpr int S_THREADS = 256; // state pass
constexpr int O_THREADS = 128; // output pass
constexpr int QR = 32;         // output pass: query rows a block

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

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

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 16 bytes global → shared, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A rows × round_up(w, 4) tile of a strided T array (unit column stride,
// row stride rs) into shared memory with row pitch `pitch` elements (a
// multiple of 16 bytes): rows < valid and columns < w from `src`, the
// rest 0. With `vec` (w a multiple of 16 bytes, rows 16-byte aligned)
// 16-byte cp.async copies, in flight until the caller waits; else
// element copies.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int pitch, const T* src,
                                          int64_t rs, int rows, int valid,
                                          int w, bool vec, int tid,
                                          int nthreads) {
  if (vec) {
    constexpr int VE = 16 / sizeof(T);
    const int vpr = w / VE;
    for (int e = tid; e < rows * vpr; e += nthreads) {
      const int r = e / vpr, cv = e % vpr;
      const bool ok = r < valid;
      cp_async16(dst + r * pitch + cv * VE, ok ? src + r * rs + cv * VE : src,
                 ok);
    }
  } else {
    const int wp = round_up(w, 4);
    for (int e = tid; e < rows * wp; e += nthreads) {
      const int r = e / wp, cc = e % wp;
      dst[r * pitch + cc] =
          r < valid && cc < w ? src[r * rs + cc] : from_f32<T>(0.f);
    }
  }
}

// Whether a strided (row stride rs) tile of width w starting at p takes
// 16-byte copies
template <typename T>
__device__ __forceinline__ bool vec_ok(const T* p, int64_t rs, int w) {
  return aligned16(p) && (rs * (int64_t)sizeof(T)) % 16 == 0 &&
         (w * (int)sizeof(T)) % 16 == 0;
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
  float* ws;            // entering states (B·H, chunks, K, V)
  int64_t t_len, n_chunks;
  int h, kd, vd, chunk;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t l_sb, l_st, l_sh;
};

// Inclusive running sums, in token order, of the log decay staged in
// rows 1..n of `lcz` (row 0 holds zeros: the exponent of the first row
// under "pre"), in place: one thread a channel walks its column (scalar
// decay: one column, one thread), loads 8 rows ahead of its adds.
template <bool PERCH>
__device__ __forceinline__ void running_sums(float* lcz, int pitch, int n,
                                             int kd, int tid, int nthreads) {
  for (int kk = tid; kk < (PERCH ? kd : 1); kk += nthreads) {
    float acc = 0.f;
    for (int r0 = 1; r0 <= n; r0 += 8) {
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        x[i] = r0 + i <= n ? lcz[(r0 + i) * pitch + kk] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc += x[i];
        if (r0 + i <= n) lcz[(r0 + i) * pitch + kk] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core products (mma.sync bf16 → f32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the bf16 terms of a pair of values, x0 in the low half: one term when
// the values are bf16 already (EXACT), else hi + mid + lo, each the bf16
// rounding of what the earlier ones leave (the differences are exact)
template <int N>
__device__ __forceinline__ void terms(float x0, float x1, uint32_t (&out)[N]) {
  static_assert(N == 1 || N == 3, "one term or three");
  if constexpr (N == 1) {
    out[0] = bf16x2(x0, x1);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
    const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
    out[0] = *reinterpret_cast<const uint32_t*>(&h);
    out[1] = *reinterpret_cast<const uint32_t*>(&m);
    out[2] = bf16x2(r0 - __low2float(m), r1 - __high2float(m));
  }
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

// A fragment (16 × 16, row major) of an f32 tile at `base` (pitch floats):
// lane (g, t) holds rows g and g + 8, columns 2t, 2t + 1, 2t + 8, 2t + 9
template <int N>
__device__ __forceinline__ void load_a(const float* base, int pitch, int g,
                                       int t, uint32_t (&a)[N][4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(base + g * pitch + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(base + (g + 8) * pitch + 2 * t);
  const float2 x2 =
      *reinterpret_cast<const float2*>(base + g * pitch + 2 * t + 8);
  const float2 x3 =
      *reinterpret_cast<const float2*>(base + (g + 8) * pitch + 2 * t + 8);
  uint32_t r[N];
  terms<N>(x0.x, x0.y, r);
  for (int i = 0; i < N; ++i) a[i][0] = r[i];
  terms<N>(x1.x, x1.y, r);
  for (int i = 0; i < N; ++i) a[i][1] = r[i];
  terms<N>(x2.x, x2.y, r);
  for (int i = 0; i < N; ++i) a[i][2] = r[i];
  terms<N>(x3.x, x3.y, r);
  for (int i = 0; i < N; ++i) a[i][3] = r[i];
}

// B fragment (16 × 8) whose column n is row n of an f32 tile at `base`
// (k along the row): lane (g, t) holds row g, columns 2t, 2t + 1, 2t + 8,
// 2t + 9
template <int N>
__device__ __forceinline__ void load_b_rows(const float* base, int pitch,
                                            int g, int t,
                                            uint32_t (&b)[N][2]) {
  const float2 x0 = *reinterpret_cast<const float2*>(base + g * pitch + 2 * t);
  const float2 x1 =
      *reinterpret_cast<const float2*>(base + g * pitch + 2 * t + 8);
  uint32_t r[N];
  terms<N>(x0.x, x0.y, r);
  for (int i = 0; i < N; ++i) b[i][0] = r[i];
  terms<N>(x1.x, x1.y, r);
  for (int i = 0; i < N; ++i) b[i][1] = r[i];
}

// B fragment (16 × 8) of a tile at `base` (f32, or bf16 values) with k
// along its rows: lane (g, t) holds column g, rows 2t, 2t + 1, 2t + 8,
// 2t + 9.
template <int N, typename E>
__device__ __forceinline__ void load_b_cols(const E* base, int pitch, int g,
                                            int t, uint32_t (&b)[N][2]) {
  uint32_t r[N];
  terms<N>(to_f32(base[2 * t * pitch + g]),
           to_f32(base[(2 * t + 1) * pitch + g]), r);
  for (int i = 0; i < N; ++i) b[i][0] = r[i];
  terms<N>(to_f32(base[(2 * t + 8) * pitch + g]),
           to_f32(base[(2 * t + 9) * pitch + g]), r);
  for (int i = 0; i < N; ++i) b[i][1] = r[i];
}

// d += Σ a_i·b_j over the term pairs with i + j ≤ 2 (the rest lie below
// 2⁻²⁴ of the product), the smallest first
template <int NA, int NB>
__device__ __forceinline__ void mma_terms(float (&d)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < NB) mma_bf16(d, a[i], b[j][0], b[j][1]);
    }
}

// ---------------------------------------------------------------------------
// (a) the state pass
// ---------------------------------------------------------------------------

// Shared memory of a state block, per chunk capacity LT: the raw chunk
// (k [LT][KR] and v [LT][VR] in T), the log decay [LT + 1][KL] or
// [LT + 1] f32 (row 0 zeros), then k ⊙ e^{lc_L − lc} [LT][KS] f32 and,
// for a scalar decay, each row's factor e^{lc_L − lc} [LT].
template <typename T>
struct StateSmem {
  int kr, vr, kl, ks, lt;
  bool perch;
  __host__ __device__ StateSmem(int lt_, int kd, int vd, bool perch_)
      : kr(round_up(kd, 16 / (int)sizeof(T))), vr(round_up(vd, 8)),
        kl(round_up(kd, 4) + 4), ks(round_up(kd, 4) + 4), lt(lt_),
        perch(perch_) {}
  __host__ __device__ size_t v_off() const {
    return sizeof(T) * (size_t)lt * kr;
  }
  __host__ __device__ size_t l_off() const {
    return v_off() + sizeof(T) * (size_t)lt * vr;
  }
  __host__ __device__ size_t k_off() const {
    return l_off() + sizeof(float) * (perch ? (size_t)(lt + 1) * kl
                                            : (size_t)round_up(lt + 1, 4));
  }
  __host__ __device__ size_t bytes(int) const {
    return k_off() + sizeof(float) * ((size_t)lt * ks + (perch ? 0 : lt));
  }
};

// One block a (b, h, chunk): U_c = (k ⊙ e^{lc_L − lc})ᵀ v (K × V) and the
// chunk's decay d_c = e^{lc_L} (K) to the workspaces; the last block of a
// (b, h), found with an integer atomic on its counter, then runs the
// recurrence S_{c+1} = S_c ⊙ d_c + U_c over the chunks in order, storing
// each S_c (the state chunk c enters with) over U_c, and the final state.
template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(S_THREADS, 2)
gla_state_kernel(Args a, float* __restrict__ dws, int* __restrict__ counters) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const StateSmem<T> lay(LT, kd, vd, PERCH);
  const int kp = lay.ks;               // pitch of k ⊙ e^{lc_L − lc}
  T* kr = reinterpret_cast<T*>(smem);
  T* vr = reinterpret_cast<T*>(smem + lay.v_off());
  float* lz = reinterpret_cast<float*>(smem + lay.l_off());
  float* ks = reinterpret_cast<float*>(smem + lay.k_off());
  const int lp = PERCH ? lay.kl : 1;

  // the output pass may start once every block of this pass has: its
  // blocks stage their chunk and form P·v on the SMs this pass frees, and
  // wait before they read ws
  pdl_trigger();
  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int64_t ch = blockIdx.y, n_chunks = a.n_chunks;
  const int b = bh / a.h, hh = bh % a.h;
  const int64_t t0 = ch * len;
  const int valid = (int)min((int64_t)len, a.t_len - t0);
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hh * a.k_sh +
               t0 * a.k_st;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hh * a.v_sh +
               t0 * a.v_st;
  const float* ld = a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st;

  // 1. stage the chunk, zero past T
  copy_tile(kr, lay.kr, k, a.k_st, len, valid, kd, vec_ok(k, a.k_st, kd),
            tid, S_THREADS);
  copy_tile(vr, lay.vr, v, a.v_st, len, valid, vd, vec_ok(v, a.v_st, vd),
            tid, S_THREADS);
  if (PERCH) {
    copy_tile(lz + lay.kl, lay.kl, ld, a.l_st, len, valid, kd,
              vec_ok(ld, a.l_st, kd), tid, S_THREADS);
    for (int i = tid; i < kd; i += S_THREADS) lz[i] = 0.f;
  } else {
    for (int r = tid; r <= len; r += S_THREADS)
      lz[r] = r >= 1 && r - 1 < valid ? ld[(r - 1) * a.l_st] : 0.f;
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 2. running sums of the log decay (rows 1..len)
  running_sums<PERCH>(lz, lp, len, kd, tid, S_THREADS);
  __syncthreads();

  // 3. k ⊙ e^{lc_L − lc} (scalar decay: one exponential a row, `wz`);
  //    the chunk's decay
  float* wz = ks + LT * kp;
  if (!PERCH) {
    for (int r = tid; r < len; r += S_THREADS)
      wz[r] = expf(lz[len] - lz[r + 1]);
    __syncthreads();
  }
#pragma unroll 4
  for (int i = tid; i < len * kd; i += S_THREADS) {
    const int r = i / kd, kk = i % kd;
    ks[r * kp + kk] = to_f32(kr[r * lay.kr + kk]) *
                      (PERCH ? expf(lz[len * lp + kk] - lz[(r + 1) * lp + kk])
                             : wz[r]);
  }
  float* dc = dws + ((size_t)bh * n_chunks + ch) * kd;
  for (int kk = tid; kk < kd; kk += S_THREADS)
    dc[kk] = expf(lz[len * lp + (PERCH ? kk : 0)]);
  __syncthreads();

  // 4. U_c, 4 × 4 a thread (rows 4·tr .. 4·tr + 3, columns 4·tc ..
  //    4·tc + 3): a float4 of k ⊙ e^{lc_L − lc} and 4 values of v a row
  const int tr = tid / 16, tc = tid % 16, k0 = 4 * tr, v0 = 4 * tc;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  // threads past K or V read the last whole float4 of the row (their sums
  // are not stored): no read past the staged rows
  const int kr0 = min(k0, kp - 4), vr0 = min(v0, lay.vr - 4);
#pragma unroll 4
  for (int j = 0; j < len; ++j) {
    const float4 xa = *reinterpret_cast<const float4*>(ks + j * kp + kr0);
    float xb[4];
    if constexpr (sizeof(T) == 2) {
      const uint2 raw = *reinterpret_cast<const uint2*>(vr + j * lay.vr + vr0);
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
      xb[0] = lo.x; xb[1] = lo.y; xb[2] = hi.x; xb[3] = hi.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(vr) + j * lay.vr + vr0);
      xb[0] = f.x; xb[1] = f.y; xb[2] = f.z; xb[3] = f.w;
    }
    const float xs[4] = {xa.x, xa.y, xa.z, xa.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(xs[m], xb[n], acc[m][n]);
  }
  float* w = a.ws + (size_t)bh * n_chunks * kd * vd;
  const bool full = vd % 4 == 0 && v0 + 4 <= vd;   // a float4 of the row
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int kk = k0 + m;
    if (kk >= kd) continue;
    float* row = w + (ch * kd + kk) * vd + v0;
    if (full) {
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    } else {
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (v0 + n < vd) row[n] = acc[m][n];
    }
  }

  // 5. the last block of this (b, h) runs the recurrence over its chunks
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(counters + bh, 1) == n_chunks - 1;
    if (is_last) counters[bh] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  float S[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int kk = k0 + m, vv = v0 + n;
      S[m][n] = a.s0 && kk < kd && vv < vd
                    ? a.s0[((size_t)bh * kd + kk) * vd + vv] : 0.f;
    }
  constexpr int CB = 2;   // chunks whose loads are in flight at once
  const float* dh = dws + (size_t)bh * n_chunks * kd;
  for (int64_t c0 = 0; c0 < n_chunks; c0 += CB) {
    float u[CB][4][4], d[CB][4];
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = k0 + m;
        const bool in = c0 + cb < n_chunks && kk < kd;
        d[cb][m] = in ? __ldcg(dh + (c0 + cb) * kd + kk) : 0.f;
        const float* row = w + ((c0 + cb) * kd + kk) * vd + v0;
        if (in && full) {
          const float4 f = __ldcg(reinterpret_cast<const float4*>(row));
          u[cb][m][0] = f.x; u[cb][m][1] = f.y;
          u[cb][m][2] = f.z; u[cb][m][3] = f.w;
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            u[cb][m][n] = in && v0 + n < vd ? __ldcg(row + n) : 0.f;
        }
      }
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) {
      if (c0 + cb >= n_chunks) break;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int kk = k0 + m;
        if (kk >= kd) continue;
        float* row = w + ((c0 + cb) * kd + kk) * vd + v0;
        if (full) {
          *reinterpret_cast<float4*>(row) =
              make_float4(S[m][0], S[m][1], S[m][2], S[m][3]);
        } else {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            if (v0 + n < vd) row[n] = S[m][n];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          S[m][n] = fmaf(S[m][n], d[cb][m], u[cb][m][n]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int kk = k0 + m, vv = v0 + n;
      if (kk < kd && vv < vd)
        a.s_out[((size_t)bh * kd + kk) * vd + vv] = S[m][n];
    }
}

// ---------------------------------------------------------------------------
// (b) the output pass
// ---------------------------------------------------------------------------

// Shared memory of an output block (f32 arrays, row pitches multiples of
// 16 bytes; rows of K padded by 4 floats so that the rows a warp reads
// together fall in different bank groups): q then q ⊙ e^{lq} [QR][KP],
// k [LT][KP], v [LT][VP], the log decay [LT + 1][KP] or [LT + 1] (row 0
// zeros), the entering state [KR4][VP], the scores [QR][LP], the bonus
// diagonal [QR] and the bonus [K].
struct OutSmem {
  int kp, vp, lp, kr4, lt;
  bool perch;
  __host__ __device__ OutSmem(int lt_, int kd, int vd, bool perch_)
      : kp(round_up(kd, 4) + 4), vp(round_up(vd, 8)), lp(lt_ + 4),
        kr4(round_up(kd, 4)), lt(lt_), perch(perch_) {}
  __host__ __device__ int q() const { return 0; }
  __host__ __device__ int k() const { return q() + QR * kp; }
  __host__ __device__ int v() const { return k() + lt * kp; }
  __host__ __device__ int l() const { return v() + lt * vp; }
  __host__ __device__ int s() const {
    return l() + (perch ? (lt + 1) * kp : round_up(lt + 1, 4));
  }
  __host__ __device__ int sc() const { return s() + kr4 * vp; }
  __host__ __device__ int dg() const { return sc() + QR * lp; }
  __host__ __device__ int u() const { return dg() + QR; }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)(u() + MAX_KV);
  }
};

// bf16 tiles into f32 shared arrays: every 16-byte vector a thread copies
// is loaded first (N at most), then converted and stored; rows ≥ valid and
// columns ≥ w read 0
template <int N, int NTHR>
struct Bf16Tile {
  uint4 raw[N];
  __device__ __forceinline__ void load(const __nv_bfloat16* src, int64_t rs,
                                       int rows, int valid, int w, bool vec,
                                       int tid) {
    const int vpr = (w + 7) / 8;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * NTHR;
      raw[i] = make_uint4(0u, 0u, 0u, 0u);
      if (e >= rows * vpr) continue;
      const int r = e / vpr, cv = e % vpr;
      if (r >= valid) continue;
      const __nv_bfloat16* p = src + r * rs + cv * 8;
      if (vec) {
        raw[i] = __ldg(reinterpret_cast<const uint4*>(p));
      } else {
        const unsigned short* ps = reinterpret_cast<const unsigned short*>(p);
        unsigned h[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (cv * 8 + m < w) h[m / 2] |= unsigned(ps[m]) << (16 * (m % 2));
        raw[i] = make_uint4(h[0], h[1], h[2], h[3]);
      }
    }
  }
  __device__ __forceinline__ void store(float* dst, int pitch, int rows,
                                        int w, int tid) const {
    const int vpr = (w + 7) / 8;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = tid + i * NTHR;
      if (e >= rows * vpr) continue;
      const int r = e / vpr, cv = e % vpr;
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw[i]);
      float4 lo, hi;
      float2 f = __bfloat1622float2(h[0]); lo.x = f.x; lo.y = f.y;
      f = __bfloat1622float2(h[1]); lo.z = f.x; lo.w = f.y;
      f = __bfloat1622float2(h[2]); hi.x = f.x; hi.y = f.y;
      f = __bfloat1622float2(h[3]); hi.z = f.x; hi.w = f.y;
      float* d = dst + r * pitch + cv * 8;
      *reinterpret_cast<float4*>(d) = lo;
      *reinterpret_cast<float4*>(d + 4) = hi;
    }
  }
};

template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(O_THREADS) gla_output_kernel(Args a) {
  // score tile: RT row threads × KT key threads, SR rows × SK keys each
  constexpr int KT = LT == 32 ? 8 : 16, RT = O_THREADS / KT;
  constexpr int SK = LT / KT, SR = QR / RT;
  extern __shared__ __align__(16) float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const OutSmem lay(LT, kd, vd, PERCH);
  const int kp = lay.kp, vp = lay.vp, lp = lay.lp;
  float* qf = sm + lay.q();
  float* kf = sm + lay.k();
  float* vf = sm + lay.v();
  float* lz = sm + lay.l();       // row 0 zeros, row r + 1: lc_r
  float* S = sm + lay.s();
  float* sc = sm + lay.sc();
  float* dg = sm + lay.dg();
  float* us = sm + lay.u();
  const int lzp = PERCH ? kp : 1;

  const int tid = threadIdx.x;
  const int row_blocks = (len + QR - 1) / QR;
  const int64_t ch = blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const bool pre = a.bonus != nullptr;
  const int64_t t_len = a.t_len, t0 = ch * len;
  const int valid = (int)min((int64_t)len, t_len - t0);  // rows before T
  const int len4 = round_up(len, 4);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh +
               t0 * a.q_st;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hh * a.k_sh +
               t0 * a.k_st;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hh * a.v_sh +
               t0 * a.v_st;
  const float* ld = a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st;

  // 1. stage the chunk's k, v and log decay, and the bonus, once for all
  //    its blocks of query rows; zero past T and in the padding
  if (PERCH) {
    copy_tile(lz + kp, kp, ld, a.l_st, len4, valid, kd,
              vec_ok(ld, a.l_st, kd), tid, O_THREADS);
    for (int i = tid; i < kp; i += O_THREADS) lz[i] = 0.f;
  } else {
    for (int r = tid; r <= len4; r += O_THREADS)
      lz[r] = r >= 1 && r - 1 < valid ? ld[(r - 1) * a.l_st] : 0.f;
  }
  if constexpr (sizeof(T) == 4) {
    copy_tile(kf, kp, reinterpret_cast<const float*>(k), a.k_st, len4, valid,
              kd, vec_ok(k, a.k_st, kd), tid, O_THREADS);
    copy_tile(vf, vp, reinterpret_cast<const float*>(v), a.v_st, len4, valid,
              vd, vec_ok(v, a.v_st, vd), tid, O_THREADS);
    cp_async_commit();
  } else {
    cp_async_commit();
    Bf16Tile<LT * MAX_KV / 8 / O_THREADS, O_THREADS> tk, tv;
    tk.load(k, a.k_st, len4, valid, kd, vec_ok(k, a.k_st, kd), tid);
    tv.load(v, a.v_st, len4, valid, vd, vec_ok(v, a.v_st, vd), tid);
    tk.store(kf, kp, len4, kd, tid);
    tv.store(vf, vp, len4, vd, tid);
  }
  if (pre)
    for (int i = tid; i < kd; i += O_THREADS) us[i] = a.bonus[(size_t)hh * kd + i];
  cp_async_wait<0>();
  __syncthreads();

  // 2. running sums of the log decay
  running_sums<PERCH>(lz, lzp, len, kd, tid, O_THREADS);
  __syncthreads();

  const int kd4 = lay.kr4;
  T* y = static_cast<T*>(a.y) + ((size_t)b * t_len * a.h + hh) * vd;
  const int64_t y_st = (int64_t)a.h * vd;
  for (int rb = 0; rb < row_blocks; ++rb) {
    const int i0 = rb * QR;
    if (t0 + i0 >= t_len) break;           // rows wholly past T
    const int nk = min(len, i0 + QR);      // key rows 0 .. nk − 1
    const int nq = nk - i0;                // query rows i0 .. nk − 1
    const int nk4 = round_up(nk, 4);
    const int qvalid = max(0, min(nq, valid - i0));

    // the block's query rows
    if constexpr (sizeof(T) == 4) {
      copy_tile(qf, kp, reinterpret_cast<const float*>(q) + i0 * a.q_st,
                a.q_st, QR, qvalid, kd, vec_ok(q + i0 * a.q_st, a.q_st, kd),
                tid, O_THREADS);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      Bf16Tile<QR * MAX_KV / 8 / O_THREADS, O_THREADS> tq;
      tq.load(q + i0 * a.q_st, a.q_st, QR, qvalid, kd,
              vec_ok(q + i0 * a.q_st, a.q_st, kd), tid);
      tq.store(qf, kp, QR, kd, tid);
    }
    __syncthreads();

    // 3. masked scores: query rows i0 + ry + RT·m, keys kx + KT·n
    {
      const int kx = tid % KT, ry = tid / KT;
      // exponent rows in lz: lq_i is row i (pre) or i + 1 (post), lc_j j + 1
      const int qoff = pre ? 0 : 1;
      bool ok[SR][SK];
#pragma unroll
      for (int m = 0; m < SR; ++m)
#pragma unroll
        for (int n = 0; n < SK; ++n) {
          const int i = i0 + ry + RT * m, j = kx + KT * n;
          ok[m][n] = i < nk && j < nk && (pre ? j < i : j <= i);
        }
      float acc[SR][SK];
#pragma unroll
      for (int m = 0; m < SR; ++m)
#pragma unroll
        for (int n = 0; n < SK; ++n) acc[m][n] = 0.f;
      for (int p = 0; p < kd4; p += 4) {
        float4 qa[SR], ka[SK];
#pragma unroll
        for (int m = 0; m < SR; ++m)
          qa[m] = *reinterpret_cast<const float4*>(qf + (ry + RT * m) * kp + p);
#pragma unroll
        for (int n = 0; n < SK; ++n)
          if (kx + KT * n < nk)   // keys past the last query row: masked
            ka[n] = *reinterpret_cast<const float4*>(kf + (kx + KT * n) * kp + p);
        if (PERCH) {
          float4 la[SR], lb[SK];
#pragma unroll
          for (int m = 0; m < SR; ++m)
            la[m] = *reinterpret_cast<const float4*>(
                lz + min(i0 + ry + RT * m + qoff, nk) * kp + p);
#pragma unroll
          for (int n = 0; n < SK; ++n)
            lb[n] = *reinterpret_cast<const float4*>(
                lz + min(kx + KT * n + 1, nk) * kp + p);
#pragma unroll
          for (int m = 0; m < SR; ++m)
#pragma unroll
            for (int n = 0; n < SK; ++n) {
              if (!ok[m][n]) continue;
              float t = acc[m][n];
              t = fmaf(qa[m].x * ka[n].x, expf(la[m].x - lb[n].x), t);
              t = fmaf(qa[m].y * ka[n].y, expf(la[m].y - lb[n].y), t);
              t = fmaf(qa[m].z * ka[n].z, expf(la[m].z - lb[n].z), t);
              t = fmaf(qa[m].w * ka[n].w, expf(la[m].w - lb[n].w), t);
              acc[m][n] = t;
            }
        } else {
#pragma unroll
          for (int m = 0; m < SR; ++m)
#pragma unroll
            for (int n = 0; n < SK; ++n) {
              if (kx + KT * n >= nk) continue;
              float t = acc[m][n];
              t = fmaf(qa[m].x, ka[n].x, t);
              t = fmaf(qa[m].y, ka[n].y, t);
              t = fmaf(qa[m].z, ka[n].z, t);
              t = fmaf(qa[m].w, ka[n].w, t);
              acc[m][n] = t;
            }
        }
      }
#pragma unroll
      for (int m = 0; m < SR; ++m)
#pragma unroll
        for (int n = 0; n < SK; ++n) {
          const int il = ry + RT * m, i = i0 + il, j = kx + KT * n;
          if (il >= nq || j >= nk4) continue;
          float val = 0.f;
          if (ok[m][n]) {
            val = acc[m][n];
            if (!PERCH) val *= expf(lz[i + qoff] - lz[j + 1]);
          }
          sc[il * lp + j] = val;
        }
      if (pre)
        for (int il = tid; il < nq; il += O_THREADS) {
          float d = 0.f;
          for (int p = 0; p < kd; ++p)
            d = fmaf(qf[il * kp + p] * us[p], kf[(i0 + il) * kp + p], d);
          dg[il] = d;
        }
    }
    __syncthreads();

    // 4. q ⊙ e^{lq}, in place
    for (int e = tid; e < nq * kd; e += O_THREADS) {
      const int il = e / kd, kk = e % kd, i = i0 + il;
      const float lq = PERCH ? lz[(pre ? i : i + 1) * kp + kk]
                             : lz[pre ? i : i + 1];
      qf[il * kp + kk] *= expf(lq);
    }

    // 5. y = scores·v, then + (q ⊙ e^{lq})·S once the state pass is done:
    //    rows ty + 8·m, columns 4·tx .. 4·tx + 3
    constexpr int YR = QR / 8;
    const int tx = tid % 16, ty = tid / 16, c0 = 4 * tx;
    float acc[YR][4];
#pragma unroll
    for (int m = 0; m < YR; ++m)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[m][cc] = 0.f;
    const bool cols = c0 < vd;
    for (int j = 0; j < nk4 && cols; j += 4) {
      float4 pa[YR];
#pragma unroll
      for (int m = 0; m < YR; ++m)
        pa[m] = *reinterpret_cast<const float4*>(
            sc + min(ty + 8 * m, nq - 1) * lp + j);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float4 vb = *reinterpret_cast<const float4*>(vf + (j + jj) * vp + c0);
#pragma unroll
        for (int m = 0; m < YR; ++m) {
          const float w = jj == 0 ? pa[m].x : jj == 1 ? pa[m].y
                        : jj == 2 ? pa[m].z : pa[m].w;
          acc[m][0] = fmaf(w, vb.x, acc[m][0]);
          acc[m][1] = fmaf(w, vb.y, acc[m][1]);
          acc[m][2] = fmaf(w, vb.z, acc[m][2]);
          acc[m][3] = fmaf(w, vb.w, acc[m][3]);
        }
      }
    }
    if (rb == 0) {    // the state pass is done: S_c, once for the chunk
      pdl_wait();
      const float* w = a.ws + ((size_t)bh * a.n_chunks + ch) * kd * vd;
      copy_tile(S, vp, w, vd, kd4, kd, vd, vd % 4 == 0, tid, O_THREADS);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
    for (int p = 0; p < kd4 && cols; p += 4) {
      float4 qa[YR];
#pragma unroll
      for (int m = 0; m < YR; ++m)
        qa[m] = *reinterpret_cast<const float4*>(
            qf + min(ty + 8 * m, nq - 1) * kp + p);
#pragma unroll
      for (int pp = 0; pp < 4; ++pp) {
        const float4 sb = *reinterpret_cast<const float4*>(S + (p + pp) * vp + c0);
#pragma unroll
        for (int m = 0; m < YR; ++m) {
          const float w = pp == 0 ? qa[m].x : pp == 1 ? qa[m].y
                        : pp == 2 ? qa[m].z : qa[m].w;
          acc[m][0] = fmaf(w, sb.x, acc[m][0]);
          acc[m][1] = fmaf(w, sb.y, acc[m][1]);
          acc[m][2] = fmaf(w, sb.z, acc[m][2]);
          acc[m][3] = fmaf(w, sb.w, acc[m][3]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < YR; ++m) {
      const int il = ty + 8 * m;
      const int64_t t = t0 + i0 + il;
      if (il >= nq || t >= t_len) continue;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int vv = c0 + cc;
        if (vv >= vd) continue;
        float val = acc[m][cc];
        if (pre) val = fmaf(dg[il], vf[(i0 + il) * vp + vv], val);
        y[t * y_st + vv] = from_f32<T>(val);
      }
    }
    __syncthreads();   // the query rows and scores are consumed
  }
}

// ---------------------------------------------------------------------------
// (b') the output pass on the tensor cores: scalar decay, "post" (Mamba2)
// ---------------------------------------------------------------------------


// Shared memory of a tensor-core output block (f32; rows of K padded to
// a multiple of 16 and by 8 floats, rows of V to a multiple of 8 and by 4,
// so that the fragments' loads fall in different banks): q [QM][KP],
// k [LT][KP], v [LT][VP], the log decay [LT + 1] (row 0 zero), the
// entering state [K16][VP] (over k's rows where it fits). A block takes a
// whole chunk: QM = LT query rows.
struct MmaSmem {
  int kp, vp, k16, lt;
  __host__ __device__ MmaSmem(int lt_, int kd, int vd)
      : kp(round_up(kd, 16) + 8), vp(round_up(vd, 8) + 4),
        k16(round_up(kd, 16)), lt(lt_) {}
  __host__ __device__ bool s_in_k() const { return k16 * vp <= lt * kp; }
  __host__ __device__ int q() const { return 0; }
  __host__ __device__ int k() const { return lt * kp; }
  __host__ __device__ int v() const { return k() + lt * kp; }
  __host__ __device__ int l() const { return v() + lt * vp; }
  __host__ __device__ int s() const {
    return s_in_k() ? k() : l() + round_up(lt + 1, 4);
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)(l() + round_up(lt + 1, 4) +
                                    (s_in_k() ? 0 : k16 * vp));
  }
};

template <typename T, int LT>
__global__ void __launch_bounds__(2 * LT, 256 / LT) gla_output_mma_kernel(Args a) {
  static_assert(sizeof(T) == 2, "bf16 inputs: q, k and v enter as one term");
  constexpr int NI = 1;                        // terms of q, k, v
  constexpr int KS = MAX_KV / 16, VN = MAX_KV / 8;
  constexpr int QM = LT, NTHR = 2 * LT;        // 16 query rows a warp
  extern __shared__ __align__(16) float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const MmaSmem lay(LT, kd, vd);
  const int kp = lay.kp, vp = lay.vp, k16 = lay.k16;
  float* qf = sm + lay.q();
  float* kf = sm + lay.k();
  float* vf = sm + lay.v();
  float* lz = sm + lay.l();      // row 0 zero, row r + 1: lc_r
  float* S = sm + lay.s();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t ch = blockIdx.y;
  const int bh = blockIdx.x;
  const int b = bh / a.h, hh = bh % a.h;
  const int64_t t_len = a.t_len, t0 = ch * len;
  const int nk = len;                      // key and query rows 0 .. nk − 1
  const int nk16 = round_up(nk, 16);
  const int valid = (int)min((int64_t)nk, t_len - t0);
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hh * a.q_sh +
               t0 * a.q_st;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hh * a.k_sh +
               t0 * a.k_st;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hh * a.v_sh +
               t0 * a.v_st;
  const float* ld = a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st;

  // 1. stage q's rows, k and v up to the last query row (rows to a
  //    multiple of 16), the log decay; zero past T, past nk and in K's
  //    padding
  for (int r = tid; r <= nk16; r += NTHR)
    lz[r] = r >= 1 && r - 1 < valid ? ld[(r - 1) * a.l_st] : 0.f;
  {
    Bf16Tile<QM * MAX_KV / 8 / NTHR, NTHR> tq;
    Bf16Tile<LT * MAX_KV / 8 / NTHR, NTHR> tk, tv;
    tq.load(q, a.q_st, QM, valid, kd, vec_ok(q, a.q_st, kd), tid);
    tk.load(k, a.k_st, nk16, valid, kd, vec_ok(k, a.k_st, kd), tid);
    tv.load(v, a.v_st, nk16, valid, vd, vec_ok(v, a.v_st, vd), tid);
    tq.store(qf, kp, QM, kd, tid);
    tk.store(kf, kp, nk16, kd, tid);
    tv.store(vf, vp, nk16, vd, tid);
  }
  if (kd < k16) {
    const int pad = k16 - kd;
    for (int e = tid; e < (QM + nk16) * pad; e += NTHR) {
      const int r = e / pad, cc = kd + e % pad;
      (r < QM ? qf + r * kp : kf + (r - QM) * kp)[cc] = 0.f;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 2. running sums of the log decay
  running_sums<false>(lz, 1, nk, kd, tid, NTHR);
  __syncthreads();

  // 3. per warp, 16 query rows, over blocks of 16 keys up to the warp's
  //    last row: scores P = q·kᵀ ⊙ e^{lc_i − lc_j} (j ≤ i), then
  //    y += P·v with P in its three bf16 terms (one key block's P live at
  //    a time)
  const int r0 = 16 * warp;               // the warp's rows, block-local
  const bool active = r0 < nk;
  const int nkw = min(nk, r0 + 16);       // keys up to the warp's last row
  uint32_t qa[KS][NI][4];
  float yacc[VN][4];
#pragma unroll
  for (int nv = 0; nv < VN; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) yacc[nv][e] = 0.f;
  if (active) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      if (ks * 16 < k16) load_a<NI>(qf + r0 * kp + ks * 16, kp, g, t4, qa[ks]);
    for (int kb = 0; kb * 16 < nkw; ++kb) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[h][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (ks * 16 >= k16) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t kbf[NI][2];
          load_b_rows<NI>(kf + (kb * 16 + h * 8) * kp + ks * 16, kp, g, t4,
                          kbf);
          mma_terms<NI, NI>(p[h], qa[ks], kbf);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + g + 8 * (e / 2);
          const int j = kb * 16 + h * 8 + 2 * t4 + e % 2;
          p[h][e] = j <= i && i < nk
                        ? p[h][e] * expf(lz[i + 1] - lz[j + 1]) : 0.f;
        }
      uint32_t pa[3][4], r[3];
      terms<3>(p[0][0], p[0][1], r);
      for (int i = 0; i < 3; ++i) pa[i][0] = r[i];
      terms<3>(p[0][2], p[0][3], r);
      for (int i = 0; i < 3; ++i) pa[i][1] = r[i];
      terms<3>(p[1][0], p[1][1], r);
      for (int i = 0; i < 3; ++i) pa[i][2] = r[i];
      terms<3>(p[1][2], p[1][3], r);
      for (int i = 0; i < 3; ++i) pa[i][3] = r[i];
#pragma unroll
      for (int nv = 0; nv < VN; ++nv) {
        if (nv * 8 >= vd) break;
        uint32_t vb[NI][2];
        load_b_cols<NI>(vf + kb * 16 * vp + nv * 8, vp, g, t4, vb);
        mma_terms<3, NI>(yacc[nv], pa, vb);
      }
    }
  }

  // 4. + e^{lc_i}·(q·S) once the state pass is done (S over k's rows)
  pdl_wait();
  __syncthreads();   // every warp is done with k
  {
    const float* w = a.ws + ((size_t)bh * a.n_chunks + ch) * kd * vd;
    copy_tile(S, vp, w, vd, k16, kd, vd, vd % 4 == 0, tid, NTHR);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  if (!active) return;
  T* y = static_cast<T*>(a.y) + ((size_t)b * t_len * a.h + hh) * vd;
  const int64_t y_st = (int64_t)a.h * vd;
  const int il0 = r0 + g, il1 = r0 + g + 8;   // block-local rows
  const float e0 = expf(lz[min(il0, nk - 1) + 1]);
  const float e1 = expf(lz[min(il1, nk - 1) + 1]);
  float z[VN][4];
#pragma unroll
  for (int nv = 0; nv < VN; ++nv)
#pragma unroll
    for (int e = 0; e < 4; ++e) z[nv][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    if (ks * 16 >= k16) break;
#pragma unroll
    for (int nv = 0; nv < VN; ++nv) {
      if (nv * 8 >= vd) break;
      uint32_t sb[3][2];
      load_b_cols<3>(S + ks * 16 * vp + nv * 8, vp, g, t4, sb);
      mma_terms<NI, 3>(z[nv], qa[ks], sb);
    }
  }
#pragma unroll
  for (int nv = 0; nv < VN; ++nv) {
    if (nv * 8 >= vd) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = e < 2 ? il0 : il1, vv = nv * 8 + 2 * t4 + e % 2;
      const int64_t t = t0 + il;
      if (il >= nk || t >= t_len || vv >= vd) continue;
      y[t * y_st + vv] =
          from_f32<T>(fmaf(e < 2 ? e0 : e1, z[nv][e], yacc[nv][e]));
    }
  }
}

// the dynamic shared memory attribute of a kernel, per device: one bit
// per device it was set on, to the device's opt-in limit less the
// kernel's static shared memory
template <typename Kernel>
cudaError_t configure(Kernel kernel, uint64_t& configured, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const uint64_t bit = uint64_t(1) << dev;
  if (!(configured & bit)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    max_smem[dev] = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem[dev]);
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  return cudaSuccess;
}

template <typename T, int LT, bool PERCH>
int launch(const Args& a, float* dws, int* counters, int64_t bh,
           cudaStream_t st) {
  static uint64_t state_configured = 0, output_configured = 0,
                  mma_configured = 0;
  static int state_max[64], output_max[64], mma_max[64];
  // bf16 inputs, scalar decay under "post" (Mamba2): the output pass on
  // the tensor cores. f32 inputs stay on FFMA: split into bf16 terms,
  // their products carry the tensor core's own rounding, which phase 14's
  // f32 oracle sees through the full depth. Per-channel decay stays on
  // FFMA: on the tensor cores (sub-chunk reference points) the rwkv6-7b
  // layer call took 0.2345 ms against FFMA's 0.2014 on an H100.
  constexpr bool MMA_OK = sizeof(T) == 2 && !PERCH;
  const bool mma = MMA_OK && a.bonus == nullptr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = configure(gla_state_kernel<T, LT, PERCH>, state_configured, state_max);
  if (err != cudaSuccess) return (int)err;
  size_t output_smem = OutSmem(LT, a.kd, a.vd, PERCH).bytes();
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)bh, (unsigned)a.n_chunks);   // a block a chunk
  cfg.blockDim = dim3(mma ? 2 * LT : O_THREADS);
  cfg.stream = st;
  void (*output)(Args) = gla_output_kernel<T, LT, PERCH>;
  if constexpr (MMA_OK) {
    if (mma) {
      output = gla_output_mma_kernel<T, LT>;
      output_smem = MmaSmem(LT, a.kd, a.vd).bytes();
    }
  }
  err = mma ? configure(output, mma_configured, mma_max)
            : configure(output, output_configured, output_max);
  if (err != cudaSuccess) return (int)err;
  const size_t state_smem = StateSmem<T>(LT, a.kd, a.vd, PERCH).bytes(a.kd);
  if (state_smem > (size_t)state_max[dev] ||
      output_smem > (size_t)(mma ? mma_max : output_max)[dev])
    return (int)cudaErrorInvalidValue;

  const dim3 sgrid((unsigned)bh, (unsigned)a.n_chunks);
  gla_state_kernel<T, LT, PERCH><<<sgrid, S_THREADS, state_smem, st>>>(
      a, dws, counters);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  cfg.dynamicSmemBytes = output_smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, output, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, bool PERCH>
int dispatch_len(const Args& a, float* dws, int* counters, int64_t bh,
                 cudaStream_t st) {
  // RWKV6 chunks by 32, Mamba2 by its config's 128 (or a shorter T)
  if (a.chunk <= 32) return launch<T, 32, PERCH>(a, dws, counters, bh, st);
  if (a.chunk <= 128) return launch<T, 128, PERCH>(a, dws, counters, bh, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One call: the state pass, then the output pass. `ws` holds
// B·H·⌈T/chunk⌉·K·V floats (the chunks' contributions, then their
// entering states) and `dws` B·H·⌈T/chunk⌉·K (the chunks' decays), neither
// with an initial value; `counters` B·H ints, 0 before the first call and
// left 0 by every call.
extern "C" int gla_chunk_f32(
    const void* q, const void* k, const void* v, const float* ld,
    const float* bonus, const float* s0, void* y, float* s_out, float* ws,
    float* dws, int* counters, int bf16, int per_channel, int64_t b, int64_t t_len, int64_t h,
    int64_t kd, int64_t vd, int64_t chunk, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides,
    const int64_t* l_strides, void* stream) {
  if (kd < 1 || kd > MAX_KV || vd < 1 || vd > MAX_KV || chunk < 1 ||
      chunk > 128 || b < 1 || h < 1 || t_len < 1 || b * h > INT32_MAX ||
      (t_len + chunk - 1) / chunk > 65535 || !counters)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.ld = ld; a.bonus = bonus; a.s0 = s0;
  a.y = y; a.s_out = s_out; a.ws = ws; a.t_len = t_len;
  a.n_chunks = (t_len + chunk - 1) / chunk; a.h = (int)h;
  a.kd = (int)kd; a.vd = (int)vd; a.chunk = (int)chunk;
  a.q_sb = q_strides[0]; a.q_st = q_strides[1]; a.q_sh = q_strides[2];
  a.k_sb = k_strides[0]; a.k_st = k_strides[1]; a.k_sh = k_strides[2];
  a.v_sb = v_strides[0]; a.v_st = v_strides[1]; a.v_sh = v_strides[2];
  a.l_sb = l_strides[0]; a.l_st = l_strides[1]; a.l_sh = l_strides[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t bh = b * h;
  if (bf16)
    return per_channel
               ? dispatch_len<__nv_bfloat16, true>(a, dws, counters, bh, st)
               : dispatch_len<__nv_bfloat16, false>(a, dws, counters, bh, st);
  return per_channel ? dispatch_len<float, true>(a, dws, counters, bh, st)
                     : dispatch_len<float, false>(a, dws, counters, bh, st);
}
