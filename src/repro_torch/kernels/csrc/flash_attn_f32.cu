// Flash attention, forward, for Hopper (sm_90a): causal or sliding-window
// GQA softmax attention with an online softmax, f32 scores and
// accumulators, inputs and output in bf16 or f32.
//
//   q (B, Tq, H, hd); k (B, Tk, KV, hd); v (B, Tk, KV, dv); query head h
//   reads kv head h / (H / KV); out (B, Tq, H, dv) in q's dtype
//
// Instances (HD, DV): (32, 32), (64, 64), (112, 112), (128, 128), and MLA's
// (192, 128) (deepseek-v2-lite-16b: q/k = nope 128 + rope 64, v 128) and
// (48, 32) (its `reduced()` heads, nope 32 + rope 16 over v 32, which the
// training CLI runs: three k16 steps of S, two n16 pairs of P·V). The
// Pallas kernel has one head dim; at dv != hd what this computes is the
// reference's jnp `layers.flash_attention` (src/repro/models/layers.py:84),
// whose value width is v's own.
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas
// (body _fa_kernel). What it computes is the Pallas kernel's: scores q·kᵀ
// in f32 times scale = hd^-1/2 as the caller rounds it; a key is masked
// (score −1e30) when it lies at or past Tk, after the query (causal), or
// `window` or more positions before it; the running max m, sum l and
// output accumulator are rescaled per key tile; out = acc / max(l, 1e-30).
// The TPU kernel runs a sequential grid axis over key blocks with
// (m, l, acc) in VMEM scratch; here a block loops over key tiles itself.
// Key tiles that are masked for every row of the block (above the causal
// diagonal, wholly outside the window) are skipped: they add exactly
// nothing to (m, l, acc). A masked key adds p = 0, so a row with no valid
// key at all (not possible in causal self-attention, where each query sees
// itself) gets 0 here where the Pallas kernel averages the values of the
// padded key blocks.
//
// Bound on an H100 SXM: 2·(hd + dv) FLOP per valid (query, key) pair at 989
// TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32), against the bytes of
// q, k, v and out at 3.35 TB/s; long sequences are bound by operations,
// the serving shape (16 tokens) by bytes.
//
// bf16: tensor cores, the FlashAttention-2 shape.
//  * A block of 4 warps owns 64 query rows, 16 a warp, of one (batch, kv
//    head): the rows are (position, query head) pairs of the kv head's
//    group, position-major, so the group's query heads share every K/V
//    tile the block loads (at the serving shape, Tq = 16 and a group of 4
//    heads fill the tile; GQA reads K/V once per group, not per head).
//  * Q, K and V tiles (64 rows) are copied to shared memory with 16-byte
//    cp.async (rows padded by 16 bytes: ldmatrix reads without bank
//    conflicts; V's rows are DV wide, Q's and K's HD); K/V tiles are
//    double-buffered, the next tile's copy in flight while this one
//    computes. At (192, 128) that is 109 KB of shared memory a block, two
//    blocks an SM.
//  * S = Q·Kᵀ by mma.sync.m16n8k16 (bf16 inputs, f32 accumulation) from
//    ldmatrix fragments; bf16·bf16 products are exact in f32, so S is an
//    f32 sum in another order. `scale` multiplies the f32 scores after the
//    product (a scaled q would not be a bf16 value). S and P stay in
//    registers: the accumulator fragment of S is the A fragment of P·V.
//    Only tiles that cross the diagonal, the window's edge or Tk compute
//    the mask; the others are valid for every row of the block.
//  * P·V: FlashAttention-2 rounds P to bf16 before P·V. That is ~2⁻⁹
//    relative to each weight, and it fails this kernel's tolerance (one
//    bf16 rounding of the output, 2⁻⁷·|out| + 1e-6) where cancellation
//    leaves |out| ~1e-5; so does a two-term split. P is split exactly into
//    three bf16 terms, P = hi + mid + lo (each the bf16 rounding of what
//    the earlier terms leave), and all three multiply the same bf16 V
//    fragment (ldmatrix.trans) into one f32 tile accumulator: P carries
//    ~24 bits, as an f32 P would. The tile's P·V starts from 0 and is
//    added to the running output by FFMA, acc = acc·corr + tile, so the
//    tensor cores' own f32 additions (which align and truncate) never add
//    a small tile into a long sum.
//  Error model: scores within ~hd·2⁻²⁴·Σ|q·k| of an f32 sum; P within
//  2⁻²⁴ relative (3 terms) and expf's 1 ulp; P·V within 64·2⁻²³ relative
//  to Σ|p·v| per tile plus one f32 rounding per tile.
//
// f32: FFMA (phase 11's and 14's f32 oracles; nothing serves in f32).
// One block owns (b, h, 64 query rows), 256 threads, 4 per query row:
// each thread keeps its row of q (scaled) in registers, computes the
// scores of 16 of the tile's 64 keys (keys l, l+4, …), shares max and sum
// over its 4 lanes with warp shuffles, writes its probabilities to shared
// memory, and accumulates p·v for DV/4 of the dv columns over all 64 keys.
// At HD = 192 the q row (192 registers) spills: the oracle's route, slow.
//
// With a non-null `lse` (f32, (B, H, Tq)) each query row also writes the
// log-sum-exp of its scaled, masked scores, m + log(l) in the units of the
// scores above, for the backward kernel (flash_attn_bwd_f32.cu) to
// recompute P = exp(S − lse); a row with no valid key (m still −1e30)
// writes +inf, so that its P is exactly 0 there. The output is computed
// by the same instructions with or without it.
//
// Plain C interface for ctypes; returns cudaGetLastError(). q, k, v and
// out start on 16-byte boundaries (the wrapper checks q, k and v).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// the row's log-sum-exp from its running max and sum, +inf for a row that
// saw no valid key
__device__ __forceinline__ float row_lse(float m, float l) {
  return m > 0.5f * NEG_INF ? m + logf(l) : __int_as_float(0x7f800000);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;   // 4 warps
constexpr int TC_BQ = 64;         // query rows per block, 16 a warp
constexpr int TC_BK = 64;         // keys per tile

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

constexpr int TC_PAD = 8;  // bf16 a shared row is padded by: 16 bytes

template <int HD, int DV>
constexpr size_t tc_smem_bytes() {
  // Q, then 2 stages of K (HD wide), then 2 of V (DV wide)
  return sizeof(__nv_bfloat16) * ((size_t)(TC_BQ + 2 * TC_BK) * (HD + TC_PAD) +
                                  (size_t)2 * TC_BK * (DV + TC_PAD));
}

template <int HD, int DV>
__global__ void __launch_bounds__(TC_THREADS)
flash_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o,
                       float* __restrict__ lse, int tq, int tk, int h,
                       int kv, int causal, int window, float scale) {
  static_assert(HD % 16 == 0 && DV % 16 == 0,
                "head dims in k16 steps and pairs of n8 blocks");
  constexpr int S = HD + TC_PAD;   // bf16 per shared row of Q and K
  constexpr int SV = DV + TC_PAD;  // bf16 per shared row of V
  constexpr int NB = DV / 8;  // n8 blocks of the output's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + TC_BQ * S;
  __nv_bfloat16* vs = ks + 2 * TC_BK * S;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = h / kv;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int rows = tq * g;  // (position, head) rows of this (b, kv head)
  const int r0 = blockIdx.x * TC_BQ;
  const int q_first = r0 / g;
  const int q_last = (min(r0 + TC_BQ, rows) - 1) / g;

  // the Q tile: row r is q[b, r / g, kvh·g + r % g, :]
  for (int c = tid; c < TC_BQ * HD / 8; c += TC_THREADS) {
    const int row = c / (HD / 8), col = c % (HD / 8) * 8;
    const int r = r0 + row;
    const bool ok = r < rows;
    const __nv_bfloat16* src =
        ok ? q + (((size_t)b * tq + r / g) * h + kvh * g + r % g) * HD + col
           : q;
    cp_async16(qs + row * S + col, src, ok);
  }
  auto load_kv = [&](int kt, int stage) {
    for (int c = tid; c < TC_BK * HD / 8; c += TC_THREADS) {
      const int row = c / (HD / 8), col = c % (HD / 8) * 8;
      const int kpos = kt * TC_BK + row;
      const bool ok = kpos < tk;  // past Tk: zeros (masked anyway)
      const size_t off =
          (((size_t)b * tk + (ok ? kpos : 0)) * kv + kvh) * HD + col;
      cp_async16(ks + (stage * TC_BK + row) * S + col, k + off, ok);
    }
    for (int c = tid; c < TC_BK * DV / 8; c += TC_THREADS) {
      const int row = c / (DV / 8), col = c % (DV / 8) * 8;
      const int kpos = kt * TC_BK + row;
      const bool ok = kpos < tk;
      const size_t off =
          (((size_t)b * tk + (ok ? kpos : 0)) * kv + kvh) * DV + col;
      cp_async16(vs + (stage * TC_BK + row) * SV + col, v + off, ok);
    }
  };

  const int n_kt = (tk + TC_BK - 1) / TC_BK;
  const int kt_end = causal ? min(n_kt, q_last / TC_BK + 1) : n_kt;
  const int kt_begin = window > 0 ? max(0, q_first - window + 1) / TC_BK : 0;

  // this thread's two rows of the warp's 16: lane/4 and lane/4 + 8
  int qpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) qpos[i] = (r0 + warp * 16 + lane / 4 + 8 * i) / g;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  if (kt_begin < kt_end) load_kv(kt_begin, 0);
  cp_async_commit();  // with the Q tile

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int stage = (kt - kt_begin) & 1;
    if (kt + 1 < kt_end) load_kv(kt + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed, the next in flight
    __syncthreads();
    const __nv_bfloat16* kst = ks + stage * TC_BK * S;
    const __nv_bfloat16* vst = vs + stage * TC_BK * SV;

    // S = Q·Kᵀ: 16 rows × 64 keys a warp, 8 n8 blocks of keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, qs + (warp * 16 + lane % 16) * S + kk * 16 + lane / 16 * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldmatrix_x4(bk, kst + (jp * 16 + lane / 16 * 8 + lane % 8) * S +
                            kk * 16 + (lane / 8) % 2 * 8);
        mma_bf16(s[2 * jp], a, bk[0], bk[1]);
        mma_bf16(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // scale, mask, online softmax; element e of block j: row lane/4 + 8·(e/2),
    // key kt·64 + 8j + 2·(lane%4) + e%2. A tile whose every key is valid
    // for every row of the block (below the diagonal, inside the window and
    // Tk) skips the mask: the same values, fewer instructions.
    const int k_first = kt * TC_BK, k_last = k_first + TC_BK - 1;
    const bool all_valid = k_last < tk && (!causal || k_last <= q_first) &&
                           (window <= 0 || q_last - k_first < window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (all_valid) {
          s[j][e] *= scale;
        } else {
          const int kpos = k_first + 8 * j + 2 * (lane % 4) + e % 2;
          const int qp = qpos[e / 2];
          bool valid = kpos < tk;
          if (causal) valid = valid && qp >= kpos;
          if (window > 0) valid = valid && qp - kpos < window;
          s[j][e] = valid ? s[j][e] * scale : NEG_INF;
        }
        mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // a masked key adds exactly 0, also while the row's m is −1e30
        const float p = all_valid || s[j][e] > 0.5f * NEG_INF
                            ? expf(s[j][e] - m[e / 2])
                            : 0.f;
        s[j][e] = p;
        psum[e / 2] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
      psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
      l[i] = l[i] * corr[i] + psum[i];
    }

    // the tile's P·V from 0, P in three bf16 terms, then into acc
    float t[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      uint32_t hi[4], mid[4], lo[4];
      split3(s[2 * kk][0], s[2 * kk][1], hi[0], mid[0], lo[0]);
      split3(s[2 * kk][2], s[2 * kk][3], hi[1], mid[1], lo[1]);
      split3(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], mid[2], lo[2]);
      split3(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vst + (kk * 16 + (lane / 8) % 2 * 8 + lane % 8) * SV +
                                  np * 16 + lane / 16 * 8);
        mma_bf16(t[2 * np], hi, bv[0], bv[1]);
        mma_bf16(t[2 * np], mid, bv[0], bv[1]);
        mma_bf16(t[2 * np], lo, bv[0], bv[1]);
        mma_bf16(t[2 * np + 1], hi, bv[2], bv[3]);
        mma_bf16(t[2 * np + 1], mid, bv[2], bv[3]);
        mma_bf16(t[2 * np + 1], lo, bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e / 2], t[n][e]);
    __syncthreads();  // this stage is read; the next prefetch may land here
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + warp * 16 + lane / 4 + 8 * i;
    if (r >= rows) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && lane % 4 == 0)
      lse[((size_t)b * h + kvh * g + r % g) * tq + r / g] =
          row_lse(m[i], l[i]);
    __nv_bfloat16* orow =
        o + (((size_t)b * tq + r / g) * h + kvh * g + r % g) * DV +
        2 * (lane % 4);
#pragma unroll
    for (int n = 0; n < NB; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * i] / den, acc[n][2 * i + 1] / den);
  }
}

template <int HD, int DV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int64_t b, int64_t tq, int64_t tk, int64_t h,
                int64_t kv, int causal, int64_t window, float scale,
                cudaStream_t st) {
  // the attribute is per device: one bit per device it was set on
  static uint64_t configured = 0;
  constexpr size_t smem = tc_smem_bytes<HD, DV>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(flash_attn_bf16_kernel<HD, DV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured |= bit;
  }
  const int64_t rows = tq * (h / kv);
  const dim3 grid((unsigned)((rows + TC_BQ - 1) / TC_BQ), (unsigned)kv,
                  (unsigned)b);
  flash_attn_bf16_kernel<HD, DV><<<grid, TC_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, (int)tq, (int)tk, (int)h, (int)kv, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: FFMA
// ---------------------------------------------------------------------------

constexpr int THREADS = 256;
constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int LANES = 4;             // threads per query row
constexpr int KEYS = BK / LANES;     // scores per thread per tile
constexpr int PS = BK + 4;           // row stride of the P tile

template <int HD, int DV>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BK * (HD + 1) + (size_t)BK * DV +
                          (size_t)BQ * PS);
}

template <int HD, int DV>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o,
                  float* __restrict__ lse, int tq, int tk, int h, int kv,
                  int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                          // [BK][HD + 1]
  float* vs = ks + BK * (HD + 1);            // [BK][DV]
  float* ps = vs + BK * DV;                  // [BQ][PS]

  constexpr int COLS = DV / LANES;
  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kvh = hh / (h / kv);
  const int qpos = q0 + row;
  const bool live = qpos < tq;

  float qr[HD];
  const float* qrow = q + (((size_t)b * tq + (live ? qpos : 0)) * h + hh) * HD;
#pragma unroll
  for (int c = 0; c < HD; ++c) qr[c] = live ? qrow[c] * scale : 0.f;

  float m = NEG_INF, l = 0.f, acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  const int n_kt = (tk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, tq) - 1;
  const int kt_end = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V are no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int key = i / HD, c = i % HD;
      const int kpos = k0 + key;
      ks[key * (HD + 1) + c] =
          kpos < tk ? k[(((size_t)b * tk + kpos) * kv + kvh) * HD + c] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += THREADS) {
      const int key = i / DV, c = i % DV;
      const int kpos = k0 + key;
      vs[key * DV + c] =
          kpos < tk ? v[(((size_t)b * tk + kpos) * kv + kvh) * DV + c] : 0.f;
    }
    __syncthreads();

    float s[KEYS];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const int key = lane + LANES * j;
      const int kpos = k0 + key;
      const float* kr = ks + key * (HD + 1);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dot = fmaf(qr[c], kr[c], dot);
      bool valid = kpos < tk;
      if (causal) valid = valid && qpos >= kpos;
      if (window > 0) valid = valid && qpos - kpos < window;
      s[j] = valid ? dot : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const float p = expf(s[j] - m_new);
      ps[row * PS + lane + LANES * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's 4 lanes have written its probabilities
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= corr;
    const float* prow = ps + row * PS;
    for (int key = 0; key < BK; ++key) {
      const float p = prow[key];
      const float* vr = vs + key * DV + lane;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = fmaf(p, vr[LANES * c], acc[c]);
    }
    __syncwarp();  // done reading the row's probabilities
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
    if (lse != nullptr && lane == 0)
      lse[((size_t)b * h + hh) * tq + qpos] = row_lse(m, l);
    float* orow = o + (((size_t)b * tq + qpos) * h + hh) * DV + lane;
#pragma unroll
    for (int c = 0; c < COLS; ++c) orow[LANES * c] = acc[c] / den;
  }
}

template <int HD, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int64_t b, int64_t tq, int64_t tk, int64_t h,
               int64_t kv, int causal, int64_t window, float scale,
               cudaStream_t st) {
  // the attribute is per device: one bit per device it was set on
  static uint64_t configured = 0;
  constexpr size_t smem = smem_bytes<HD, DV>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(
        flash_attn_kernel<HD, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured |= bit;
  }
  const dim3 grid((unsigned)((tq + BQ - 1) / BQ), (unsigned)h, (unsigned)b);
  flash_attn_kernel<HD, DV><<<grid, THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, (int)tq,
      (int)tk, (int)h, (int)kv, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

template <int HD, int DV>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int bf16, int64_t b, int64_t tq, int64_t tk, int64_t h,
           int64_t kv, int causal, int64_t window, float scale,
           cudaStream_t st) {
  return bf16 ? launch_bf16<HD, DV>(q, k, v, o, lse, b, tq, tk, h, kv, causal,
                                    window, scale, st)
              : launch_f32<HD, DV>(q, k, v, o, lse, b, tq, tk, h, kv, causal,
                                   window, scale, st);
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bf16, int64_t b,
                              int64_t tq, int64_t tk, int64_t h, int64_t kv,
                              int64_t hd, int64_t dv, int causal,
                              int64_t window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (hd == 192 && dv == 128)  // MLA: deepseek-v2-lite-16b's heads
    return launch<192, 128>(q, k, v, o, l, bf16, b, tq, tk, h, kv, causal,
                            window, scale, st);
  if (hd == 48 && dv == 32)  // MLA at deepseek-v2-lite-16b's reduced()
    return launch<48, 32>(q, k, v, o, l, bf16, b, tq, tk, h, kv, causal,
                          window, scale, st);
  if (hd != dv) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return launch<32, 32>(q, k, v, o, l, bf16, b, tq, tk, h, kv, causal,
                            window, scale, st);
    case 64:
      return launch<64, 64>(q, k, v, o, l, bf16, b, tq, tk, h, kv, causal,
                            window, scale, st);
    case 112:  // zamba2's shared attention block, 3584 / 32 heads
      return launch<112, 112>(q, k, v, o, l, bf16, b, tq, tk, h, kv, causal,
                              window, scale, st);
    case 128:
      return launch<128, 128>(q, k, v, o, l, bf16, b, tq, tk, h, kv, causal,
                              window, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
