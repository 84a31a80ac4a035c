// Chunked gated linear attention (GLA), backward, for Hopper (sm_90a): the
// gradients of what gla_chunk_f32.cu computes forward, for Mamba2 (scalar
// decay per head, "post") and RWKV6 (per-channel decay, "pre" with the
// current-token bonus), q/k/v/dy in bf16 or f32, f32 sums.
//
//   q, k (B, T, H, K); v, dy (B, T, H, V); log_decay (B, T, H) or
//   (B, T, H, K) f32; bonus (H, K) f32 or none; the states each chunk
//   entered with, S_c (B·H, chunks, K, V) f32, from the forward's state
//   pass  →  dq, dk (B, T, H, K), dv (B, T, H, V) in q's dtype;
//   d log_decay f32 in log_decay's shape; d bonus (H, K) f32
//
// Replaces no TPU kernel: the reference's Pallas GLA is forward-only and
// its training differentiates the jnp chunked form
// (src/repro/models/ssm.py:gla_chunked) with jax.grad. This kernel
// computes that gradient from the forward's chunked form (lc the running
// sum of the log decay inside the chunk, lq = lc, or lc shifted by one
// under "pre"; L the chunk's length; dS_{c+1} the cotangent of the state
// chunk c leaves with, 0 after the last chunk):
//
//   dq_i = e^{lq_i} ⊙ (S_c·dy_i) + Σ_{j≤i} (dy_i·v_j) k_j ⊙ e^{lq_i − lc_j}
//   dk_j = e^{lc_L − lc_j} ⊙ (dS_{c+1}·v_j)
//          + Σ_{i≥j} (dy_i·v_j) q_i ⊙ e^{lq_i − lc_j}
//   dv_j = (k_j ⊙ e^{lc_L − lc_j})·dS_{c+1} + Σ_{i≥j} s_ij dy_i
//   dS_c = e^{lc_L} ⊙ dS_{c+1} + Σ_i (q_i ⊙ e^{lq_i})ᵀ dy_i
//
// (j < i under "pre", s_ij the forward's masked scores), plus under "pre"
// the bonus diagonal: dq_i += u ⊙ k_i (dy_i·v_i), dk_i += u ⊙ q_i
// (dy_i·v_i), dv_i += (q_i ⊙ u ⊙ k_i)·1 dy_i, d bonus = Σ_{b,t} q_t ⊙ k_t
// (dy_t·v_t). With G the running sum of the log decay over the whole
// sequence, ∂/∂G_t = q_t ⊙ dq_t − k_t ⊙ dk_t ("post") or q_{t+1} ⊙
// dq_{t+1} − k_t ⊙ dk_t ("pre"), dq and dk in f32 without the bonus terms,
// and d log_decay_t = Σ_{t' ≥ t} ∂/∂G_{t'} (summed over K for a scalar
// decay), taken inside chunk c token by token and over all later tokens
// at once: raising G from chunk c + 1 on scales the state S_{c+1} that
// chunk enters with, so that part is ⟨dS_{c+1}, S_{c+1}⟩ (over V), under
// "pre" with q ⊙ dq of the next chunk's first token in it. (A running sum
// over all T tokens in f32 carries T·2⁻²⁴ of its partial sums into
// whatever sums the decay gradient over T: Mamba2's A_log read 3.8e-4
// from the CPU on an H100 that way.) Every exponent is a difference ≤ 0,
// taken as one expf, never as e^{lq}·e^{−lc}; a masked pair gives 0. A
// ragged tail (T % L ≠ 0) reads the forward's inert padding (q = k = v =
// dy = 0, log decay 0) and writes nothing past T.
//
// Passes, five launches a call on the caller's stream (four under
// "post"), each sum in a fixed order, no float atomics (a call repeated
// is bitwise equal):
//  (1) Q_c, grid (B·H, chunks): Q_c = Σ_i (q_i ⊙ e^{lq_i})ᵀ dy_i into the
//      workspace, and e^{lc_L}.
//  (2) the dS scan, grid (B·H, ⌈K·V/256⌉), one (k, v) element a thread:
//      g ← 0; for c = chunks − 1 … 0: store g over Q_c, g ← fmaf(e^{lc_L},
//      g, Q_c), eight chunks' Q_c and decays loaded ahead. The recurrence
//      is independent per element; each element keeps the serial order.
//  (3) the fused pair pass, grid (B·H, chunks), a block a chunk: dq, dk
//      and dv together, each pair's dP (and its exponential) formed once a
//      tile pair, then q ⊙ dq − k ⊙ dk written to d log_decay once, and
//      under "pre" the chunk's bonus partial Σ_t q ⊙ k (dy·v).
//  (4) the decay's sums, a block a (b, h, chunk): the carry ⟨dS_{c+1},
//      S_{c+1}⟩ from per-thread partials combined in a fixed tree, then
//      the chunk's tokens summed from its end, each plus the carry.
//  (5) "pre": d bonus, a thread an (h, channel), over b, then the chunks.
//
// Routes of (1) and (3), chosen by the instance:
//  * TC: bf16 inputs, scalar decay, "post", K and V multiples of 8
//    (Mamba2: the forward's gla_output_mma_kernel's condition plus the
//    widths; `launch` decides it from the inputs, and
//    `chunk_scan.bwd_route` restates it for reporting), on the tensor cores
//    (mma.sync.m16n8k16, bf16 → f32). (3): a block a chunk of LT rows,
//    LT/16 warps; warp w owns rows 16w…16w + 15 as queries, then as keys.
//    Shared: q, k, v, dy as bf16 rows of 72 (16-byte cp.async, or element
//    copies where unaligned: zamba2's q and k are read in place, head
//    stride 0), S_c and then dS_{c+1} f32 [64][68], the log decay: 91,664
//    bytes at LT 128 (two blocks an SM, 128 registers a thread), 35,984
//    at 32; Q_c's pass 37,392 / 9,360.
//      dq:  dP_ij = dy_i·v_j and the pairs' factor e^{lc_i − lc_j} (one
//           expf) on the accumulator fragments, j ≤ i, blocks of 16 keys
//           up to the diagonal; dq_i = e^{lc_i}·(dy_i·S_cᵀ) + Σ_j dP̃_ij k_j.
//      dk, dv: dP̃ᵀ and s̃ᵀ (s_ij = q_i·k_j), blocks of 16 queries from the
//           diagonal on; dk_j = e^{lc_L − lc_j}·(v_j·dS_{c+1}ᵀ) + Σ_i
//           dP̃_ij q_i; dv_j = e^{lc_L − lc_j}·(k_j·dS_{c+1}) + Σ_i s̃_ij dy_i.
//    Under a scalar decay each row's factor multiplies the f32 product,
//    so q, k, v and dy enter as one exact term; S_c, dS_{c+1}, dP̃ and s̃,
//    f32, as their exact three-term bf16 splits (hi + mid + lo, the
//    products whose term orders sum to ≤ 2 kept, the smallest first).
//    (1): Q_c[k][v] with qᵀ as one term and e^{lc_i}·dy_i in three, a warp
//    16 channels, 16 tokens a step.
//    Sums: the tensor cores add a product's terms and the accumulator they
//    are given with their significands aligned to the largest and
//    truncated, not as IEEE f32 additions (flash_attn_bwd_f32.cu's
//    finding). So every product here takes each k16 step (dP and s̃ over
//    V or K, the state terms, Q_c's 16 tokens) or each 16-row block (dq's,
//    dk's and dv's intra sums) from a zeroed accumulator, adds it to f32
//    running sums with IEEE adds, and each gradient is rounded to bf16
//    once. q ⊙ dq − k ⊙ dk takes dq and dk in f32.
//    Error model: a k16 step within ~16 truncated terms (2⁻²³ of the
//    largest term or partial sum each) of its exact sum; the split
//    operands within 2⁻²⁴ relative (three terms) and expf's ulp; then one
//    f32 rounding a step in the running sum: over L = 128 rows, 8 roundings
//    at the running sum's magnitude, K/16 or V/16 for dP and s̃. Far below
//    the gradients' own bf16 rounding (2⁻⁹), and within phase 13 (b)'s f32
//    limit L·K·2⁻²³ for d log_decay, which sums f32 dq and dk. Phase 13
//    (b) also holds this route's d log_decay error and dv's bf16 mismatch
//    share to 3 times the plain f32 backward's (GLA_BWD_TC_SHARE): one
//    bf16 term in place of three, for any split operand, misses that at
//    L 128 where it stays within L·K·2⁻²³.
//  * FFMA: everything else (per-channel decay in either dtype, every f32
//    call, "pre"): f32 FMA on register tiles fed by float4 reads of f32
//    shared tiles. (Per-channel decay on the tensor cores was slower in
//    the forward, 0.2345 against 0.2014 ms; f32 in three-term splits
//    missed phase 14's oracle.) (3): a block a chunk, 128 threads, keys in
//    tiles J of 32 (one at L = 32), query tiles I ≥ J inside:
//      dq (all rows) starts as e^{lq} ⊙ (dy·S_cᵀ) in shared memory; a key
//      tile's dk and dv start as its state terms; then per tile pair:
//      - scalar decay: dP̃ and s̃ (dP, q·kᵀ, one expf a pair) into shared
//        tiles, then dq_I += dP̃·K_J, dk_J += dP̃ᵀ·Q_I, dv_J += s̃ᵀ·dY_I;
//      - per-channel decay: dP into a shared tile, then a warp 16
//        channels, a thread a channel and the keys of one parity, a row a
//        step: each pair's exponential e^{lq_ik − lc_jk} once, used for
//        dq_ik (the two parities added once), dk_jk (complete in the
//        thread) and s's term q_ik k_jk e, whose sum over channels is a
//        fixed butterfly over the half warp, then over the warps in
//        order; dv_J += sᵀ·dY_I.
//      dq of tile J's rows is complete once key tile J is done, so its
//      rows write dq, dk, dv and q ⊙ dq − k ⊙ dk then ("pre": the last row
//      of a tile carries its k ⊙ dk to the next tile).
//    Shared (K = V = 64): 88,848 bytes at L 32 per channel, 79,504
//    scalar; 193,296 / 158,224 at L 128 (two blocks an SM at L 32). Its
//    inputs are staged 16 bytes a load (f32 by cp.async); in the
//    per-channel loop a lane keeps its keys' k and lc in registers, takes
//    two rows a step and the keys in groups of four without branches, so
//    that each pair's load, expf and FMAs overlap the next ones'.
//    (1) keeps 4 × 4 register tiles of Q_c a thread over the chunk's rows.
//
// Workspace (the wrapper's): Q_c, then dS (B·H, chunks, K, V) f32, the
// chunks' decays (B·H, chunks, K) and the bonus partials (B·H, chunks, K).
//
// Bound on an H100 SXM: operations. Per chunk and (b, h) the function
// needs, for each of the mask's pairs, the scores (2·K FLOP), dP (2·V),
// dq's and dk's intra-chunk terms (2·K each) and dv's (2·V), and per
// channel K exponentials a pair; and four products of 2·L·K·V FLOP (dq's
// and dk's state terms, dv's, Q_c); against 2 bytes a bf16 element of q,
// k, v, dy read once and dq, dk, dv written once, 4 a decay element read
// and written. With bf16 inputs every product of two operands counts at
// the bf16 peak, as for the attention backward: an f32 operand (S_c, dS,
// the decayed pair matrices, e^{lq}·dy) runs on the tensor cores as its
// three-term split, as route TC runs it. That leaves at the f32 peak the
// exponentials, the recurrence, the decay's and the bonus's element-wise
// work and, under a per-channel decay, the scores and dq's and dk's intra
// terms, each term of which carries its own factor e^{lq_ik − lc_jk}
// (chip_smoke.py's `_gla_bwd_ops`). At the two bf16 training layer calls
// the bound is then the bytes.
//
// Instances: chunk capacity 32 (RWKV6) and 128 (Mamba2's chunk, or any
// chunk of 33–128), scalar or per-channel decay, bf16 or f32.
//
// Plain C interface for ctypes; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_KV = 64;        // largest K and V
constexpr int QR = 32;            // rows of an FFMA tile
constexpr int THREADS = 128;      // FFMA pair pass
constexpr int S_THREADS = 256;    // FFMA Q_c pass: a 4 × 4 piece of K × V each
constexpr int QC_THREADS = 128;   // tensor-core Q_c pass: 16 channels a warp
constexpr int SCAN_THREADS = 256;
constexpr int DEC_THREADS = 256;
constexpr int TPP = QR + 4;       // pitch of the FFMA pair tiles
constexpr int SPP = QR + 2;       // pitch of the per-warp score partials
constexpr int BP = MAX_KV + 8;    // bf16 row pitch of the tensor-core tiles
constexpr int SP = MAX_KV + 4;    // f32 row pitch of S on the tensor cores

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dy;
  const float* ld;
  const float* bonus;    // null: "post" convention, no bonus
  const float* states;   // S_c (B·H, chunks, K, V)
  void* dq;
  void* dk;
  void* dv;
  float* dld;
  float* dbonus;
  float* ds;             // Q_c, then dS_{c+1} (B·H, chunks, K, V)
  float* dc;             // e^{lc_L} (B·H, chunks, K)
  float* part;           // bonus partials (B·H, chunks, K)
  int64_t t_len, n_chunks;
  int b, h, kd, vd, chunk;
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t y_sb, y_st, y_sh;
  int64_t l_sb, l_st, l_sh;
};

// pointer of (b, h) and token t0 in a strided (B, T, H, ·) array
template <typename T>
__device__ __forceinline__ const T* at(const void* p, int b, int hh,
                                       int64_t t0, int64_t sb, int64_t st,
                                       int64_t sh) {
  return static_cast<const T*>(p) + b * sb + hh * sh + t0 * st;
}

// rows × round_up(w, 4) of a strided array (unit column stride, row
// stride rs) into f32 shared rows of pitch `pitch`: rows < valid and
// columns < w from src, the rest 0
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                     int64_t rs, int rows, int valid, int w,
                                     int tid, int nthreads) {
  const int wp = round_up(w, 4);
  for (int e = tid; e < rows * wp; e += nthreads) {
    const int r = e / wp, c = e % wp;
    dst[r * pitch + c] = r < valid && c < w ? to_f32(src[r * rs + c]) : 0.f;
  }
}

// 16-byte global → shared copies, zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The same, 16 bytes a load where the rows and width allow (w a multiple
// of 8 bf16 or 4 f32 values, rows 16-byte aligned), without index
// arithmetic per element: f32 as cp.async copies, in flight until
// cp_async_wait_all; bf16 through registers, four loads in flight a
// thread before their stores.
template <typename T>
__device__ __forceinline__ void stage_vec(float* dst, int pitch, const T* src,
                                         int64_t rs, int rows, int valid,
                                         int w, int tid, int nthreads) {
  constexpr int VE = 16 / sizeof(T);
  if (!aligned16(src) || (rs * (int64_t)sizeof(T)) % 16 != 0 ||
      w % VE != 0) {
    stage(dst, pitch, src, rs, rows, valid, w, tid, nthreads);
    return;
  }
  const int vpr = w / VE, n = rows * vpr;
  if constexpr (sizeof(T) == 4) {
    for (int e = tid; e < n; e += nthreads) {
      const int r = e / vpr, cv = e - r * vpr;
      const bool ok = r < valid;
      cp_async16(dst + r * pitch + cv * VE, ok ? src + r * rs + cv * VE : src,
                 ok);
    }
  } else {
    for (int e0 = tid; e0 < n; e0 += 4 * nthreads) {
      uint4 u[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int e = e0 + m * nthreads, r = e / vpr, cv = e - r * vpr;
        u[m] = e < n && r < valid
                   ? *reinterpret_cast<const uint4*>(src + r * rs + cv * VE)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int e = e0 + m * nthreads, r = e / vpr, cv = e - r * vpr;
        if (e >= n) continue;
        const __nv_bfloat162* hh =
            reinterpret_cast<const __nv_bfloat162*>(&u[m]);
        float* d = dst + r * pitch + cv * VE;
        *reinterpret_cast<float4*>(d) =
            make_float4(__low2float(hh[0]), __high2float(hh[0]),
                        __low2float(hh[1]), __high2float(hh[1]));
        *reinterpret_cast<float4*>(d + 4) =
            make_float4(__low2float(hh[2]), __high2float(hh[2]),
                        __low2float(hh[3]), __high2float(hh[3]));
      }
    }
  }
}

// The chunk's log decay into `lz` (row 0 zeros, row r + 1 token r, zeros
// past `valid`, rows 0 … `rows`), then its inclusive running sums in token
// order, in place: one thread a channel walks its column (scalar: one).
template <bool PERCH>
__device__ __forceinline__ void decay_sums(float* lz, int lp, const float* ld,
                                           int64_t l_st, int rows, int valid,
                                           int kd, int tid, int nthreads) {
  const int w = PERCH ? kd : 1;
  for (int e = tid; e < (rows + 1) * w; e += nthreads) {
    const int r = e / w, c = e % w;
    lz[r * lp + c] = r >= 1 && r - 1 < valid ? ld[(r - 1) * l_st + c] : 0.f;
  }
  __syncthreads();
  for (int c = tid; c < w; c += nthreads) {
    float acc = 0.f;
    for (int r = 1; r <= rows; ++r) {
      acc += lz[r * lp + c];
      lz[r * lp + c] = acc;
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// tensor-core building blocks (mma.sync bf16 → f32), as gla_chunk_f32.cu's
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// the bf16 terms of a pair of f32 values, x0 in the low half: hi + mid +
// lo, each the bf16 rounding of what the earlier ones leave (exact)
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

// d = Σ a_i·b_j over the term pairs with i + j ≤ 2, the smallest first,
// from a zeroed accumulator
template <int NA, int NB>
__device__ __forceinline__ void mma_step(float (&d)[4],
                                         const uint32_t (&a)[NA][4],
                                         const uint32_t (&b)[NB][2]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int j = s - i;
      if (j >= 0 && j < NB) mma_bf16(d, a[i], b[j][0], b[j][1]);
    }
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&x)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += x[e];
}

// A fragment (16 × 16, row major) of a bf16 tile at `base` (pitch
// elements): lane (g, t) holds rows g and g + 8, columns 2t, 2t + 1,
// 2t + 8, 2t + 9; bf16 values enter as one term
__device__ __forceinline__ void load_a_bf(const bf16* base, int p, int g, int t,
                                          uint32_t (&a)[1][4]) {
  a[0][0] = *reinterpret_cast<const uint32_t*>(base + g * p + 2 * t);
  a[0][1] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * p + 2 * t);
  a[0][2] = *reinterpret_cast<const uint32_t*>(base + g * p + 2 * t + 8);
  a[0][3] = *reinterpret_cast<const uint32_t*>(base + (g + 8) * p + 2 * t + 8);
}

// A fragment whose row r is column r of a bf16 tile at `base` (A[r][c] =
// base[c·p + r])
__device__ __forceinline__ void load_a_t_bf(const bf16* base, int p, int g,
                                            int t, uint32_t (&a)[1][4]) {
  a[0][0] = pack2(base[2 * t * p + g], base[(2 * t + 1) * p + g]);
  a[0][1] = pack2(base[2 * t * p + g + 8], base[(2 * t + 1) * p + g + 8]);
  a[0][2] = pack2(base[(2 * t + 8) * p + g], base[(2 * t + 9) * p + g]);
  a[0][3] = pack2(base[(2 * t + 8) * p + g + 8],
                  base[(2 * t + 9) * p + g + 8]);
}

// B fragment (16 × 8) whose column n is row n of a bf16 tile (k along the
// row): lane (g, t) holds row g, columns 2t, 2t + 1, 2t + 8, 2t + 9
__device__ __forceinline__ void load_b_rows_bf(const bf16* base, int p, int g,
                                               int t, uint32_t (&b)[1][2]) {
  b[0][0] = *reinterpret_cast<const uint32_t*>(base + g * p + 2 * t);
  b[0][1] = *reinterpret_cast<const uint32_t*>(base + g * p + 2 * t + 8);
}

// B fragment (16 × 8) of a bf16 tile with k along its rows: lane (g, t)
// holds column g, rows 2t, 2t + 1, 2t + 8, 2t + 9
__device__ __forceinline__ void load_b_cols_bf(const bf16* base, int p, int g,
                                               int t, uint32_t (&b)[1][2]) {
  b[0][0] = pack2(base[2 * t * p + g], base[(2 * t + 1) * p + g]);
  b[0][1] = pack2(base[(2 * t + 8) * p + g], base[(2 * t + 9) * p + g]);
}

// the same two B fragments of an f32 tile, in N terms
template <int N>
__device__ __forceinline__ void load_b_rows_f(const float* base, int p, int g,
                                              int t, uint32_t (&b)[N][2]) {
  const float2 x0 = *reinterpret_cast<const float2*>(base + g * p + 2 * t);
  const float2 x1 = *reinterpret_cast<const float2*>(base + g * p + 2 * t + 8);
  uint32_t r[N];
  terms<N>(x0.x, x0.y, r);
#pragma unroll
  for (int i = 0; i < N; ++i) b[i][0] = r[i];
  terms<N>(x1.x, x1.y, r);
#pragma unroll
  for (int i = 0; i < N; ++i) b[i][1] = r[i];
}
template <int N>
__device__ __forceinline__ void load_b_cols_f(const float* base, int p, int g,
                                              int t, uint32_t (&b)[N][2]) {
  uint32_t r[N];
  terms<N>(base[2 * t * p + g], base[(2 * t + 1) * p + g], r);
#pragma unroll
  for (int i = 0; i < N; ++i) b[i][0] = r[i];
  terms<N>(base[(2 * t + 8) * p + g], base[(2 * t + 9) * p + g], r);
#pragma unroll
  for (int i = 0; i < N; ++i) b[i][1] = r[i];
}

// the A fragment, in three terms, of a 16 × 16 f32 block held as two
// accumulator fragments (columns 0–7 and 8–15)
__device__ __forceinline__ void acc_to_a3(const float (&p)[2][4],
                                          uint32_t (&a)[3][4]) {
  uint32_t r[3];
  terms<3>(p[0][0], p[0][1], r);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i][0] = r[i];
  terms<3>(p[0][2], p[0][3], r);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i][1] = r[i];
  terms<3>(p[1][0], p[1][1], r);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i][2] = r[i];
  terms<3>(p[1][2], p[1][3], r);
#pragma unroll
  for (int i = 0; i < 3; ++i) a[i][3] = r[i];
}

// rows × w of a strided T array (unit column stride, row stride rs) into
// shared rows of pitch `pitch` elements, rows ≥ valid zero; 16-byte
// cp.async copies where rows and width allow (in flight until
// cp_async_wait_all), element copies otherwise. Columns from w on are
// left as they are.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int pitch, const T* src,
                                          int64_t rs, int rows, int valid,
                                          int w, int tid, int nthreads) {
  constexpr int VE = 16 / sizeof(T);
  const bool vec = aligned16(src) && (rs * (int64_t)sizeof(T)) % 16 == 0 &&
                   (w * (int)sizeof(T)) % 16 == 0;
  if (vec) {
    const int vpr = w / VE;
    for (int e = tid; e < rows * vpr; e += nthreads) {
      const int r = e / vpr, cv = e % vpr;
      const bool ok = r < valid;
      cp_async16(dst + r * pitch + cv * VE, ok ? src + r * rs + cv * VE : src,
                 ok);
    }
  } else {
    for (int e = tid; e < rows * w; e += nthreads) {
      const int r = e / w, c = e % w;
      dst[r * pitch + c] = r < valid ? src[r * rs + c] : from_f32<T>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// (1) Q_c and the chunks' decays
// ---------------------------------------------------------------------------

// FFMA. Shared floats of a chunk's block: q then q ⊙ e^{lq} [LT][KP], dy
// [LT][VP], the log decay [LT + 1][KP] or [LT + 1].
template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(S_THREADS) gla_bwd_qc_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const int kp = round_up(kd, 4) + 4, vp = round_up(vd, 4) + 4;
  const int lp = PERCH ? kp : 1;
  float* qf = sm;
  float* yf = qf + LT * kp;
  float* lz = yf + LT * vp;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y;
  const bool pre = a.bonus != nullptr;
  const int64_t t0 = ch * len;
  const int valid = (int)min((int64_t)len, a.t_len - t0);

  stage_vec(qf, kp, at<T>(a.q, b, hh, t0, a.q_sb, a.q_st, a.q_sh), a.q_st, len,
        valid, kd, tid, S_THREADS);
  stage_vec(yf, vp, at<T>(a.dy, b, hh, t0, a.y_sb, a.y_st, a.y_sh), a.y_st,
        len, valid, vd, tid, S_THREADS);
  cp_async_wait_all();
  decay_sums<PERCH>(lz, lp, a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st,
                    a.l_st, len, valid, kd, tid, S_THREADS);
  const int qoff = pre ? 0 : 1;
  for (int e = tid; e < len * kd; e += S_THREADS) {
    const int i = e / kd, kk = e % kd;
    qf[i * kp + kk] *= expf(lz[(i + qoff) * lp + (PERCH ? kk : 0)]);
  }
  float* dc = a.dc + ((size_t)bh * a.n_chunks + ch) * kd;
  for (int kk = tid; kk < kd; kk += S_THREADS)
    dc[kk] = expf(lz[len * lp + (PERCH ? kk : 0)]);
  __syncthreads();

  // Q_c = Σ_i (q_i ⊙ e^{lq_i})ᵀ dy_i, rows in order: 4 × 4 a thread
  const int k0 = 4 * (tid / 16), v0 = 4 * (tid % 16);
  if (k0 >= kd || v0 >= vd) return;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  for (int i = 0; i < len; ++i) {
    const float4 xa = *reinterpret_cast<const float4*>(qf + i * kp + k0);
    const float4 xb = *reinterpret_cast<const float4*>(yf + i * vp + v0);
    const float av[4] = {xa.x, xa.y, xa.z, xa.w};
    const float bv[4] = {xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
  }
  float* w = a.ds + ((size_t)bh * a.n_chunks + ch) * kd * vd;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (k0 + m < kd && v0 + n < vd)
        w[(k0 + m) * vd + v0 + n] = acc[m][n];
}

// Tensor cores (bf16, scalar decay, "post"). Shared: q and dy bf16
// [LT][BP], the log decay [LT + 1]. Warp w forms Q_c's channels
// 16w … 16w + 15: A = qᵀ (one term), B = e^{lc_i}·dy_i (three), 16 tokens
// a step from a zeroed accumulator, added in f32.
template <int LT>
__global__ void __launch_bounds__(QC_THREADS) gla_bwd_qc_mma_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* ys = qs + LT * BP;
  float* lz = reinterpret_cast<float*>(ys + LT * BP);
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y;
  const int64_t t0 = ch * len;
  const int valid = (int)min((int64_t)len, a.t_len - t0);

  copy_rows(qs, BP, at<bf16>(a.q, b, hh, t0, a.q_sb, a.q_st, a.q_sh),
            a.q_st, LT, valid, kd, tid, QC_THREADS);
  copy_rows(ys, BP, at<bf16>(a.dy, b, hh, t0, a.y_sb, a.y_st, a.y_sh),
            a.y_st, LT, valid, vd, tid, QC_THREADS);
  cp_async_wait_all();
  decay_sums<false>(lz, 1, a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st,
                    a.l_st, LT, valid, kd, tid, QC_THREADS);
  float* dc = a.dc + ((size_t)bh * a.n_chunks + ch) * kd;
  const float dlast = expf(lz[len]);
  for (int kk = tid; kk < kd; kk += QC_THREADS) dc[kk] = dlast;

  const int k0 = 16 * warp;
  if (k0 >= kd) return;
  constexpr int VN = MAX_KV / 8;
  float acc[VN][4];
#pragma unroll
  for (int n = 0; n < VN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int s = 0; s * 16 < valid; ++s) {
    const int i0 = 16 * s;
    uint32_t qa[1][4];
    load_a_t_bf(qs + i0 * BP + k0, BP, g, t4, qa);
    // e^{lc_i} of the rows this lane's B fragments hold (lq = lc, "post")
    const float e0 = expf(lz[i0 + 2 * t4 + 1]), e1 = expf(lz[i0 + 2 * t4 + 2]);
    const float e8 = expf(lz[i0 + 2 * t4 + 9]), e9 = expf(lz[i0 + 2 * t4 + 10]);
#pragma unroll
    for (int n = 0; n < VN; ++n) {
      if (n * 8 >= vd) break;
      const bf16* y = ys + i0 * BP + n * 8 + g;
      uint32_t yb[3][2], r[3];
      terms<3>(e0 * to_f32(y[2 * t4 * BP]), e1 * to_f32(y[(2 * t4 + 1) * BP]),
               r);
#pragma unroll
      for (int i = 0; i < 3; ++i) yb[i][0] = r[i];
      terms<3>(e8 * to_f32(y[(2 * t4 + 8) * BP]),
               e9 * to_f32(y[(2 * t4 + 9) * BP]), r);
#pragma unroll
      for (int i = 0; i < 3; ++i) yb[i][1] = r[i];
      float tmp[4];
      mma_step<1, 3>(tmp, qa, yb);
      add4(acc[n], tmp);
    }
  }
  float* w = a.ds + ((size_t)bh * a.n_chunks + ch) * kd * vd;
#pragma unroll
  for (int n = 0; n < VN; ++n) {
    if (n * 8 >= vd) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + g + 8 * (e / 2), vv = n * 8 + 2 * t4 + e % 2;
      if (kk < kd && vv < vd) w[kk * vd + vv] = acc[n][e];
    }
  }
}

// ---------------------------------------------------------------------------
// (2) the dS scan, element-parallel
// ---------------------------------------------------------------------------

// A thread an element (k, v) of a (b, h): g ← 0; for c = chunks − 1 … 0:
// read Q_c, store g, g ← fmaf(e^{lc_L}, g, Q_c). The loads do not wait
// for g: LOAD_AHEAD chunks' Q_c and decays are loaded before their fmafs
// (the decay pass's token sums load as far ahead).
constexpr int LOAD_AHEAD = 8;
__global__ void __launch_bounds__(SCAN_THREADS) gla_bwd_scan_kernel(Args a) {
  const int kv = a.kd * a.vd;
  const int e = blockIdx.y * SCAN_THREADS + threadIdx.x;
  if (e >= kv) return;
  const int64_t bh = blockIdx.x, nc = a.n_chunks;
  float* __restrict__ w = a.ds + bh * nc * kv + e;
  const float* __restrict__ dh = a.dc + bh * nc * a.kd + e / a.vd;
  const int kd = a.kd;
  float g = 0.f;
  for (int64_t c0 = nc - 1; c0 >= 0; c0 -= LOAD_AHEAD) {
    float qc[LOAD_AHEAD], d[LOAD_AHEAD];
#pragma unroll
    for (int u = 0; u < LOAD_AHEAD; ++u)
      if (c0 - u >= 0) {
        qc[u] = w[(c0 - u) * kv];
        d[u] = dh[(c0 - u) * kd];
      }
#pragma unroll
    for (int u = 0; u < LOAD_AHEAD; ++u)
      if (c0 - u >= 0) {
        w[(c0 - u) * kv] = g;
        g = fmaf(d[u], g, qc[u]);
      }
  }
}

// ---------------------------------------------------------------------------
// (3) the fused pair pass, FFMA
// ---------------------------------------------------------------------------

// acc[m][n] += Σ_c A[m·as + c] B[n·bs + c] (both along the contraction),
// float4 reads
template <int MR, int NR>
__device__ __forceinline__ void mm_abt(float (&acc)[MR][NR], const float* A,
                                       int as, const float* B, int bs,
                                       int nc) {
  for (int c = 0; c < nc; c += 4) {
    float4 x[MR], y[NR];
#pragma unroll
    for (int m = 0; m < MR; ++m)
      x[m] = *reinterpret_cast<const float4*>(A + m * as + c);
#pragma unroll
    for (int n = 0; n < NR; ++n)
      y[n] = *reinterpret_cast<const float4*>(B + n * bs + c);
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < NR; ++n) {
        float t = acc[m][n];
        t = fmaf(x[m].x, y[n].x, t);
        t = fmaf(x[m].y, y[n].y, t);
        t = fmaf(x[m].z, y[n].z, t);
        t = fmaf(x[m].w, y[n].w, t);
        acc[m][n] = t;
      }
  }
}

// acc[m][n] += Σ_c A[m·as + c] B[c·bp + n] (A along the contraction, B's
// rows the contraction and 4 consecutive outputs), float4 reads
template <int MR>
__device__ __forceinline__ void mm_ab(float (&acc)[MR][4], const float* A,
                                      int as, const float* B, int bp,
                                      int nc) {
  for (int c = 0; c < nc; c += 4) {
    float4 x[MR];
#pragma unroll
    for (int m = 0; m < MR; ++m)
      x[m] = *reinterpret_cast<const float4*>(A + m * as + c);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const float4 y = *reinterpret_cast<const float4*>(B + (c + cc) * bp);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float xv = cc == 0 ? x[m].x : cc == 1 ? x[m].y
                       : cc == 2 ? x[m].z : x[m].w;
        acc[m][0] = fmaf(xv, y.x, acc[m][0]);
        acc[m][1] = fmaf(xv, y.y, acc[m][1]);
        acc[m][2] = fmaf(xv, y.z, acc[m][2]);
        acc[m][3] = fmaf(xv, y.w, acc[m][3]);
      }
    }
  }
}

// acc[m][n] += Σ_c A[c·ap + m] B[c·bp + n] (the contraction along both
// tiles' rows; 4 consecutive outputs of each), float4 reads
__device__ __forceinline__ void mm_atb(float (&acc)[4][4], const float* A,
                                       int ap, const float* B, int bp,
                                       int nc) {
  for (int c = 0; c < nc; ++c) {
    const float4 x = *reinterpret_cast<const float4*>(A + c * ap);
    const float4 y = *reinterpret_cast<const float4*>(B + c * bp);
    const float xv[4] = {x.x, x.y, x.z, x.w};
    const float yv[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(xv[m], yv[n], acc[m][n]);
  }
}

// v[0 … 15] summed over the 16 lanes of a half warp by a fixed butterfly
// (xor 8, 4, 2, 1, each step halving the values a lane keeps): the lane
// h = lane & 15 returns the sum of v[h]. One template instance a step,
// so that every index is a constant and v stays in registers.
template <int M>
__device__ __forceinline__ void butterfly_step(float (&v)[QR / 2], int lane) {
  const bool up = lane & M;
#pragma unroll
  for (int x = 0; x < M; ++x) {
    const float send = up ? v[x] : v[x + M];
    const float keep = up ? v[x + M] : v[x];
    v[x] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}
__device__ __forceinline__ float half_warp_sums(float (&v)[QR / 2],
                                                int lane) {
  butterfly_step<8>(v, lane);
  butterfly_step<4>(v, lane);
  butterfly_step<2>(v, lane);
  butterfly_step<1>(v, lane);
  return v[0];
}

// Shared floats of an FFMA pair block (chunk capacity LT): q and dy of
// every row [LT][KP], [LT][VP]; k and v of the key tile [QR][KP],
// [QR][VP]; the log decay [LT + 1][KP] or [LT + 1]; dq [LT][KP]; dk of
// the key tile [QR][KP]; region X: S_c or dS_{c+1} [64][VP] with
// k ⊙ e^{lc_L − lc} [QR][KP], or the pair tiles P, s [QR][TPP] and the
// per-warp score partials [4][QR][SPP]; the bonus [K], dy·v and
// q·(u ⊙ k) of the key tile [QR] each, a carried k ⊙ dk [2][K] (by the
// parity of the tile that writes it).
struct PairSmem {
  int kp, vp, lp, lt;
  bool perch;
  __host__ __device__ PairSmem(int lt_, int kd, int vd, bool perch_)
      : kp(round_up(kd, 4) + 4), vp(round_up(vd, 4) + 4),
        lp(perch_ ? round_up(kd, 4) + 4 : 1), lt(lt_), perch(perch_) {}
  __host__ __device__ int q() const { return 0; }
  __host__ __device__ int dy() const { return q() + lt * kp; }
  __host__ __device__ int k() const { return dy() + lt * vp; }
  __host__ __device__ int v() const { return k() + QR * kp; }
  __host__ __device__ int l() const { return v() + QR * vp; }
  __host__ __device__ int dq() const {
    return l() + round_up((lt + 1) * lp, 4);
  }
  __host__ __device__ int dk() const { return dq() + lt * kp; }
  __host__ __device__ int x() const { return dk() + QR * kp; }
  __host__ __device__ int x_floats() const {
    return imax(MAX_KV * vp + QR * kp,
                2 * QR * TPP + (perch ? 4 * QR * SPP : 0));
  }
  __host__ __device__ int s() const { return x(); }
  __host__ __device__ int kt() const { return x() + MAX_KV * vp; }
  __host__ __device__ int p() const { return x(); }
  __host__ __device__ int sc() const { return x() + QR * TPP; }
  __host__ __device__ int sp() const { return x() + 2 * QR * TPP; }
  __host__ __device__ int u() const { return x() + round_up(x_floats(), 4); }
  __host__ __device__ int dg() const { return u() + MAX_KV; }
  __host__ __device__ int gq() const { return dg() + QR; }
  __host__ __device__ int kdc() const { return gq() + QR; }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)(kdc() + 2 * MAX_KV);
  }
};

template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(THREADS) gla_bwd_pair_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const PairSmem lay(LT, kd, vd, PERCH);
  const int kp = lay.kp, vp = lay.vp, lp = lay.lp;
  const int kd4 = round_up(kd, 4), vd4 = round_up(vd, 4);
  float* qf = sm + lay.q();
  float* yf = sm + lay.dy();
  float* kf = sm + lay.k();
  float* vf = sm + lay.v();
  float* lz = sm + lay.l();       // row 0 zeros, row r + 1: lc_r
  float* dqa = sm + lay.dq();
  float* dkt = sm + lay.dk();
  float* S = sm + lay.s();
  float* kt = sm + lay.kt();
  float* P = sm + lay.p();
  float* Sc = sm + lay.sc();
  float* spart = sm + lay.sp();
  float* us = sm + lay.u();
  float* dg = sm + lay.dg();
  float* gq = sm + lay.gq();
  float* kdc = sm + lay.kdc();

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y;
  const bool pre = a.bonus != nullptr;
  const int64_t t_len = a.t_len, t0 = ch * len;
  const int valid = (int)min((int64_t)len, t_len - t0);   // rows before T
  const int qoff = pre ? 0 : 1;    // lq_i is row i (pre) or i + 1 of lz
  const size_t kv = (size_t)kd * vd;
  // register-tile coordinates: (ty + 8m, tx + 16n) or (4·jq + m, 4·kq + n)
  const int tx = tid % 16, ty = tid / 16;
  const int jq = tid / 16, kq = tid % 16;
  const int j0 = 4 * jq, c0 = 4 * kq;

  // 1. stage q and dy of every row, the log decay, S_c and the bonus
  stage_vec(qf, kp, at<T>(a.q, b, hh, t0, a.q_sb, a.q_st, a.q_sh), a.q_st,
            LT, valid, kd, tid, THREADS);
  stage_vec(yf, vp, at<T>(a.dy, b, hh, t0, a.y_sb, a.y_st, a.y_sh), a.y_st,
            LT, valid, vd, tid, THREADS);
  stage_vec(S, vp, a.states + ((size_t)bh * a.n_chunks + ch) * kv,
            (int64_t)vd, MAX_KV, kd, vd, tid, THREADS);
  // the first key tile's k and v
  stage_vec(kf, kp, at<T>(a.k, b, hh, t0, a.k_sb, a.k_st, a.k_sh), a.k_st,
            QR, min(QR, valid), kd, tid, THREADS);
  stage_vec(vf, vp, at<T>(a.v, b, hh, t0, a.v_sb, a.v_st, a.v_sh), a.v_st,
            QR, min(QR, valid), vd, tid, THREADS);
  if (pre)
    for (int kk = tid; kk < kd; kk += THREADS)
      us[kk] = a.bonus[(size_t)hh * kd + kk];
  cp_async_wait_all();
  decay_sums<PERCH>(lz, lp, a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st,
                    a.l_st, LT, valid, kd, tid, THREADS);

  // 2. dq = e^{lq} ⊙ (dy·S_cᵀ), every row
  for (int r0 = 0; r0 < valid; r0 += QR) {
    float acc[4][4] = {};
    mm_abt<4, 4>(acc, yf + (r0 + ty) * vp, 8 * vp, S + tx * vp, 16 * vp, vd4);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = r0 + ty + 8 * m;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int kk = tx + 16 * n;
        if (kk >= kd) continue;
        const float lq = lz[(i + qoff) * lp + (PERCH ? kk : 0)];
        dqa[i * kp + kk] = expf(lq) * acc[m][n];
      }
    }
  }

  T* dq_out = static_cast<T*>(a.dq) + ((size_t)b * t_len * a.h + hh) * kd;
  T* dk_out = static_cast<T*>(a.dk) + ((size_t)b * t_len * a.h + hh) * kd;
  T* dv_out = static_cast<T*>(a.dv) + ((size_t)b * t_len * a.h + hh) * vd;
  const int64_t k_st = (int64_t)a.h * kd, v_st = (int64_t)a.h * vd;
  const int w_ld = PERCH ? kd : 1;
  float* dld = a.dld + ((size_t)b * t_len * a.h + hh) * w_ld;
  const int64_t l_st = (int64_t)a.h * w_ld;
  float bonus_acc = 0.f;           // thread kk's bonus partial, rows in order

  for (int J0 = 0; J0 < valid; J0 += QR) {
    const int nj = min(QR, valid - J0);     // the key tile's rows before T
    __syncthreads();   // the last tile's readers of k, v, X are done
    // 3. the key tile's k and v (the first staged with q), dS_{c+1},
    //    k ⊙ e^{lc_L − lc}
    if (J0 > 0) {
      stage_vec(kf, kp, at<T>(a.k, b, hh, t0 + J0, a.k_sb, a.k_st, a.k_sh),
                a.k_st, QR, nj, kd, tid, THREADS);
      stage_vec(vf, vp, at<T>(a.v, b, hh, t0 + J0, a.v_sb, a.v_st, a.v_sh),
                a.v_st, QR, nj, vd, tid, THREADS);
    }
    stage_vec(S, vp, a.ds + ((size_t)bh * a.n_chunks + ch) * kv,
              (int64_t)vd, MAX_KV, kd, vd, tid, THREADS);
    cp_async_wait_all();
    __syncthreads();
    for (int e = tid; e < QR * kd4; e += THREADS) {
      const int jl = e / kd4, kk = e % kd4;
      const int c = PERCH ? min(kk, kd - 1) : 0;
      kt[jl * kp + kk] = kk < kd ? kf[jl * kp + kk] *
          expf(lz[len * lp + c] - lz[(J0 + jl + 1) * lp + c]) : 0.f;
    }
    __syncthreads();

    // 4. the state terms: dk_J = e^{lc_L − lc} ⊙ (v·dS_{c+1}ᵀ) into dkt;
    //    dv_J = (k ⊙ e^{lc_L − lc})·dS_{c+1} into registers (j0 + m, c0 + n)
    {
      float acc[4][4] = {};
      mm_abt<4, 4>(acc, vf + ty * vp, 8 * vp, S + tx * vp, 16 * vp, vd4);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int jl = ty + 8 * m;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int kk = tx + 16 * n;
          if (kk >= kd) continue;
          const int c = PERCH ? kk : 0;
          dkt[jl * kp + kk] =
              expf(lz[len * lp + c] - lz[(J0 + jl + 1) * lp + c]) * acc[m][n];
        }
      }
    }
    float dvr[4][4] = {};
    if (c0 < vd) mm_ab<4>(dvr, kt + j0 * kp, kp, S + c0, vp, kd4);
    __syncthreads();
    float dkr[4][4] = {};          // scalar decay: dk_J (j0 + m, c0 + n)
    if (!PERCH && c0 < kd)
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) dkr[m][n] = dkt[(j0 + m) * kp + c0 + n];
    float dkc[QR / 2];             // per channel: dk of keys 2x + parity
#pragma unroll
    for (int x = 0; x < QR / 2; ++x) dkc[x] = 0.f;

    // 5. the tile pairs (I, J), I ≥ J
    for (int I0 = J0; I0 < valid; I0 += QR) {
      __syncthreads();   // the last pair's readers of P and s are done
      //    dP (scalar decay: dP̃ and s̃), rows ry + 16m, keys kx + 8n
      {
        const int kx = tid % 8, ry = tid / 8;
        float dp[2][4] = {}, qk[2][4] = {};
        mm_abt<2, 4>(dp, yf + (I0 + ry) * vp, 16 * vp, vf + kx * vp, 8 * vp,
                     vd4);
        if (!PERCH)
          mm_abt<2, 4>(qk, qf + (I0 + ry) * kp, 16 * kp, kf + kx * kp, 8 * kp,
                       kd4);
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int il = ry + 16 * m, jl = kx + 8 * n;
            const int i = I0 + il, j = J0 + jl;
            const bool ok = pre ? j < i : j <= i;
            float p = 0.f, s = 0.f;
            if (ok) {
              p = dp[m][n];
              if (!PERCH) {
                const float e = expf(lz[i + qoff] - lz[j + 1]);
                p *= e;
                s = qk[m][n] * e;
              }
            }
            P[il * TPP + jl] = p;
            if (!PERCH) Sc[il * TPP + jl] = s;
          }
      }
      __syncthreads();
      if (!PERCH) {
        // dq_I += dP̃·K_J (rows ty + 8m, channels 4tx …); dk_J += dP̃ᵀ·Q_I;
        // dv_J += s̃ᵀ·dY_I
        if (4 * tx < kd) {
          float acc[4][4] = {};
          mm_ab<4>(acc, P + ty * TPP, 8 * TPP, kf + 4 * tx, kp, QR);
#pragma unroll
          for (int m = 0; m < 4; ++m)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              float* d = dqa + (I0 + ty + 8 * m) * kp + 4 * tx + n;
              *d += acc[m][n];
            }
        }
        if (c0 < kd) mm_atb(dkr, P + j0, TPP, qf + I0 * kp + c0, kp, QR);
        if (c0 < vd) mm_atb(dvr, Sc + j0, TPP, yf + I0 * vp + c0, vp, QR);
      } else {
        // a warp 16 channels, a lane a channel kk and the keys of
        // parity r (their k and lc in registers), two rows a step, the
        // keys in groups of four without branches (a masked pair's
        // exponent is −∞: its terms are 0)
        const int warp = tid / 32, lane = tid % 32;
        const int kk = 16 * warp + (lane & 15), r = lane >> 4;
        const bool on = kk < kd;
        const int kc = on ? kk : 0;
        constexpr int NX = QR / 2;
        float kr[NX], lcr[NX];
#pragma unroll
        for (int x = 0; x < NX; ++x) {
          kr[x] = on ? kf[(2 * x + r) * kp + kk] : 0.f;
          lcr[x] = lz[(J0 + 2 * x + r + 1) * lp + kc];
        }
        const bool diag = I0 == J0;
        for (int il = 0; il < QR; il += 2) {
          if (I0 + il >= valid) break;           // rows past T
          const int i = I0 + il;
          const float lq0 = lz[(i + qoff) * lp + kc];
          const float lq1 = lz[(i + 1 + qoff) * lp + kc];
          const float qv0 = on ? qf[i * kp + kk] : 0.f;
          const float qv1 = on ? qf[(i + 1) * kp + kk] : 0.f;
          float dq0 = 0.f, dq1 = 0.f, sp0[NX], sp1[NX];
#pragma unroll
          for (int x = 0; x < NX; ++x) sp0[x] = sp1[x] = 0.f;
          // keys up to the second row: x ≤ (il + 1) / 2 on the diagonal
          const int xmax = diag ? il / 2 + 1 : NX;
#pragma unroll
          for (int x4 = 0; x4 < NX; x4 += 4) {
            if (x4 < xmax)     // uniform: the loops unroll, indices static
#pragma unroll
            for (int x = x4; x < x4 + 4; ++x) {
              const int jl = 2 * x + r;
              const bool ok0 = on && (!diag || (pre ? jl < il : jl <= il));
              const bool ok1 =
                  on && (!diag || (pre ? jl < il + 1 : jl <= il + 1));
              const float e0 = expf(ok0 ? lq0 - lcr[x] : -INFINITY);
              const float e1 = expf(ok1 ? lq1 - lcr[x] : -INFINITY);
              const float t0 = P[il * TPP + jl] * e0;
              const float t1 = P[(il + 1) * TPP + jl] * e1;
              dq0 = fmaf(t0, kr[x], dq0);
              dq1 = fmaf(t1, kr[x], dq1);
              dkc[x] = fmaf(t1, qv1, fmaf(t0, qv0, dkc[x]));
              sp0[x] = qv0 * kr[x] * e0;
              sp1[x] = qv1 * kr[x] * e1;
            }
          }
          // the parities' dq added once (a + b = b + a: both lanes agree)
          const float dqt0 = dq0 + __shfl_xor_sync(0xffffffffu, dq0, 16);
          const float dqt1 = dq1 + __shfl_xor_sync(0xffffffffu, dq1, 16);
          const float s0 = half_warp_sums(sp0, lane);
          const float s1 = half_warp_sums(sp1, lane);
          float* spw = spart + (warp * QR + il) * SPP + 2 * (lane & 15) + r;
          spw[0] = s0;
          spw[SPP] = s1;
          if (on && r == 0) {
            dqa[i * kp + kk] += dqt0;
            dqa[(i + 1) * kp + kk] += dqt1;
          }
        }
        __syncthreads();
        // s = Σ over the warps' partials, in order; rows past T 0
        const int nw = (kd + 15) / 16;
        for (int e = tid; e < QR * QR; e += THREADS) {
          const int il = e / QR, jl = e % QR;
          float s = 0.f;
          if (I0 + il < valid)
            for (int w = 0; w < nw; ++w) s += spart[(w * QR + il) * SPP + jl];
          Sc[il * TPP + jl] = s;
        }
        __syncthreads();
        if (c0 < vd) mm_atb(dvr, Sc + j0, TPP, yf + I0 * vp + c0, vp, QR);
      }
    }
    __syncthreads();   // every pair of the key tile is done

    // 6. dk_J complete in dkt; under "pre" dy·v and q·(u ⊙ k) of its rows
    if (!PERCH) {
      if (c0 < kd)
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) dkt[(j0 + m) * kp + c0 + n] = dkr[m][n];
    } else {
      const int warp = tid / 32, lane = tid % 32;
      const int kk = 16 * warp + (lane & 15), r = lane >> 4;
      if (kk < kd)
#pragma unroll
        for (int x = 0; x < QR / 2; ++x) dkt[(2 * x + r) * kp + kk] += dkc[x];
    }
    if (pre) {
      // four threads a row, each every fourth column, added in a fixed
      // butterfly
      const int jl = tid / 4, part = tid % 4;
      float d = 0.f, gv = 0.f;
      for (int c = part; c < vd; c += 4)
        d = fmaf(yf[(J0 + jl) * vp + c], vf[jl * vp + c], d);
      for (int kk = part; kk < kd; kk += 4)
        gv = fmaf(qf[(J0 + jl) * kp + kk] * us[kk], kf[jl * kp + kk], gv);
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      gv += __shfl_xor_sync(0xffffffffu, gv, 1);
      gv += __shfl_xor_sync(0xffffffffu, gv, 2);
      if (part == 0) {
        dg[jl] = d;
        gq[jl] = gv;
      }
    }
    __syncthreads();

    // 7. the tile's rows: dv, dk and dq out, q ⊙ dq − k ⊙ dk into
    //    d log_decay ("pre": q ⊙ dq of the next row, the tile's last row
    //    carrying its k ⊙ dk to the next tile), the bonus partial
    if (c0 < vd)
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int jl = j0 + m;
        if (jl >= nj) continue;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (c0 + n >= vd) continue;
          float val = dvr[m][n];
          if (pre) val = fmaf(gq[jl], yf[(J0 + jl) * vp + c0 + n], val);
          dv_out[(t0 + J0 + jl) * v_st + c0 + n] = from_f32<T>(val);
        }
      }
    // a tile's last row carries its k ⊙ dk in kdc[its parity]
    float* kdc_out = kdc + ((J0 / QR) & 1) * MAX_KV;
    const float* kdc_in = kdc + (((J0 / QR) & 1) ^ 1) * MAX_KV;
    for (int e = tid; e < nj * kd; e += THREADS) {
      const int jl = e / kd, kk = e % kd, i = J0 + jl;
      const float dqv = dqa[i * kp + kk], dkv = dkt[jl * kp + kk];
      const float kdk = kf[jl * kp + kk] * dkv;
      float dqo = dqv, dko = dkv;
      if (pre) {
        dqo = fmaf(us[kk] * kf[jl * kp + kk], dg[jl], dqo);
        dko = fmaf(us[kk] * qf[i * kp + kk], dg[jl], dko);
      }
      dq_out[(t0 + i) * k_st + kk] = from_f32<T>(dqo);
      dk_out[(t0 + i) * k_st + kk] = from_f32<T>(dko);
      if (PERCH) {
        float* slot = dld + (t0 + i) * l_st + kk;
        if (!pre) {
          *slot = qf[i * kp + kk] * dqv - kdk;
        } else if (i + 1 >= valid) {
          *slot = -kdk;
        } else if (jl + 1 < QR) {
          *slot = qf[(i + 1) * kp + kk] * dqa[(i + 1) * kp + kk] - kdk;
        } else {
          kdc_out[kk] = kdk;
        }
        if (pre && jl == 0 && J0 > 0)   // the last tile's carried row
          dld[(t0 + i - 1) * l_st + kk] = qf[i * kp + kk] * dqv - kdc_in[kk];
      }
    }
    if (!PERCH)
      for (int jl = tid; jl < nj; jl += THREADS) {
        const int i = J0 + jl;
        float kdk = 0.f;
        for (int kk = 0; kk < kd; ++kk)
          kdk = fmaf(kf[jl * kp + kk], dkt[jl * kp + kk], kdk);
        const int iq = pre ? i + 1 : i;   // the row whose q ⊙ dq enters
        float qdq = 0.f;
        if (iq < valid)
          for (int kk = 0; kk < kd; ++kk)
            qdq = fmaf(qf[iq * kp + kk], dqa[iq * kp + kk], qdq);
        if (!pre || i + 1 >= valid || jl + 1 < QR)
          dld[(t0 + i) * l_st] = qdq - kdk;
        else
          kdc_out[0] = kdk;
        if (pre && jl == 0 && J0 > 0) {
          float q0 = 0.f;
          for (int kk = 0; kk < kd; ++kk)
            q0 = fmaf(qf[i * kp + kk], dqa[i * kp + kk], q0);
          dld[(t0 + i - 1) * l_st] = q0 - kdc_in[0];
        }
      }
    if (pre && tid < kd)
      for (int jl = 0; jl < nj; ++jl)
        bonus_acc = fmaf(qf[(J0 + jl) * kp + tid] * kf[jl * kp + tid],
                         dg[jl], bonus_acc);
  }
  if (pre && tid < kd)
    a.part[((size_t)bh * a.n_chunks + ch) * kd + tid] = bonus_acc;
}

// ---------------------------------------------------------------------------
// (3) the fused pair pass on the tensor cores: bf16, scalar decay, "post"
// ---------------------------------------------------------------------------

// Shared: q, k, v, dy bf16 [LT][BP] (K and V padded to a multiple of 16
// with zeros), S_c then dS_{c+1} f32 [64][SP] (zeros past K and V), the
// log decay [LT + 1] (row 0 zero).
__host__ __device__ constexpr size_t tc_smem_bytes(int lt) {
  return (size_t)4 * lt * BP * 2 + (size_t)MAX_KV * SP * 4 +
         (size_t)round_up(lt + 1, 4) * 4;
}

// two blocks an SM: 128 registers a thread (a few bytes spilled) ran
// faster on an H100 than one block at 166 without spills
constexpr int TC_MIN_BLOCKS = 2;
template <int LT>
__global__ void __launch_bounds__(2 * LT, TC_MIN_BLOCKS)
    gla_bwd_pair_mma_kernel(Args a) {
  constexpr int NTHR = 2 * LT;
  constexpr int KS = MAX_KV / 16, KN = MAX_KV / 8;
  extern __shared__ __align__(16) float sm[];
  bf16* qs = reinterpret_cast<bf16*>(sm);
  bf16* ks = qs + LT * BP;
  bf16* vs = ks + LT * BP;
  bf16* ys = vs + LT * BP;
  float* S = reinterpret_cast<float*>(ys + LT * BP);
  float* lz = S + MAX_KV * SP;     // row 0 zero, row r + 1: lc_r
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const int k16 = round_up(kd, 16), v16 = round_up(vd, 16);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y;
  const int64_t t_len = a.t_len, t0 = ch * len;
  const int valid = (int)min((int64_t)len, t_len - t0);
  const size_t kv = (size_t)kd * vd;
  const float* s_c = a.states + ((size_t)bh * a.n_chunks + ch) * kv;
  const float* ds_c = a.ds + ((size_t)bh * a.n_chunks + ch) * kv;

  // 1. stage q, k, v, dy (rows past T zero, K and V zero-padded to 16),
  //    S_c (zeros past K and V), the log decay's running sums
  copy_rows(qs, BP, at<bf16>(a.q, b, hh, t0, a.q_sb, a.q_st, a.q_sh), a.q_st,
            LT, valid, kd, tid, NTHR);
  copy_rows(ks, BP, at<bf16>(a.k, b, hh, t0, a.k_sb, a.k_st, a.k_sh), a.k_st,
            LT, valid, kd, tid, NTHR);
  copy_rows(vs, BP, at<bf16>(a.v, b, hh, t0, a.v_sb, a.v_st, a.v_sh), a.v_st,
            LT, valid, vd, tid, NTHR);
  copy_rows(ys, BP, at<bf16>(a.dy, b, hh, t0, a.y_sb, a.y_st, a.y_sh),
            a.y_st, LT, valid, vd, tid, NTHR);
  copy_rows(S, SP, s_c, (int64_t)vd, kd, kd, vd, tid, NTHR);
  {
    const bf16 z = __float2bfloat16(0.f);
    const int pk = k16 - kd, pv = v16 - vd;
    for (int e = tid; e < LT * (pk + pv); e += NTHR) {
      const int r = e / (pk + pv), c = e % (pk + pv);
      if (c < pk) {
        qs[r * BP + kd + c] = z;
        ks[r * BP + kd + c] = z;
      } else {
        vs[r * BP + vd + c - pk] = z;
        ys[r * BP + vd + c - pk] = z;
      }
    }
    for (int e = tid; e < MAX_KV * SP; e += NTHR) {
      const int r = e / SP, c = e % SP;
      if (r >= kd || c >= vd) S[e] = 0.f;
    }
  }
  cp_async_wait_all();
  decay_sums<false>(lz, 1, a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st,
                    a.l_st, LT, valid, kd, tid, NTHR);

  const int r0 = 16 * warp;            // the warp's rows, block-local
  const bool active = r0 < valid;
  const int il0 = r0 + g, il1 = r0 + g + 8;   // this lane's rows
  bf16* dq_out = static_cast<bf16*>(a.dq) + ((size_t)b * t_len * a.h + hh) * kd;
  bf16* dk_out = static_cast<bf16*>(a.dk) + ((size_t)b * t_len * a.h + hh) * kd;
  bf16* dv_out = static_cast<bf16*>(a.dv) + ((size_t)b * t_len * a.h + hh) * vd;
  const int64_t k_st = (int64_t)a.h * kd, v_st = (int64_t)a.h * vd;
  float qdq0 = 0.f, qdq1 = 0.f;        // q ⊙ dq of rows il0, il1 (f32)

  // 2. dq of the warp's 16 query rows
  if (active) {
    uint32_t ya[KS][1][4];
#pragma unroll
    for (int s = 0; s < KS; ++s)
      if (s * 16 < v16) load_a_bf(ys + r0 * BP + s * 16, BP, g, t4, ya[s]);
    float dq[KN][4];
    // the state term dy·S_cᵀ, a k16 step of V at a time
#pragma unroll
    for (int n = 0; n < KN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
      if (n * 8 >= kd) continue;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s * 16 >= v16) break;
        uint32_t sb[3][2];
        load_b_rows_f<3>(S + n * 8 * SP + s * 16, SP, g, t4, sb);
        float tmp[4];
        mma_step<1, 3>(tmp, ya[s], sb);
        add4(dq[n], tmp);
      }
    }
    const float f0 = expf(lz[il0 + 1]), f1 = expf(lz[il1 + 1]);
#pragma unroll
    for (int n = 0; n < KN; ++n) {
      dq[n][0] *= f0; dq[n][1] *= f0;
      dq[n][2] *= f1; dq[n][3] *= f1;
    }
    // the intra-chunk term, blocks of 16 keys up to the diagonal
    for (int kb = 0; kb <= warp; ++kb) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[h][e] = 0.f;
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          if (s * 16 >= v16) break;
          uint32_t vb[1][2];
          load_b_rows_bf(vs + (kb * 16 + h * 8) * BP + s * 16, BP, g, t4, vb);
          float tmp[4];
          mma_step<1, 1>(tmp, ya[s], vb);
          add4(p[h], tmp);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e < 2 ? il0 : il1;
          const int j = kb * 16 + h * 8 + 2 * t4 + e % 2;
          p[h][e] = j <= i ? p[h][e] * expf(lz[i + 1] - lz[j + 1]) : 0.f;
        }
      }
      uint32_t pa[3][4];
      acc_to_a3(p, pa);
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        if (n * 8 >= kd) break;
        uint32_t kb_[1][2];
        load_b_cols_bf(ks + kb * 16 * BP + n * 8, BP, g, t4, kb_);
        float tmp[4];
        mma_step<3, 1>(tmp, pa, kb_);
        add4(dq[n], tmp);
      }
    }
    // dq out (rows before T), q ⊙ dq over this lane's columns
#pragma unroll
    for (int n = 0; n < KN; ++n) {
      if (n * 8 >= kd) break;
      const int c = n * 8 + 2 * t4;
      if (c >= kd) continue;
      const __nv_bfloat162 q0 =
          *reinterpret_cast<const __nv_bfloat162*>(qs + il0 * BP + c);
      const __nv_bfloat162 q1 =
          *reinterpret_cast<const __nv_bfloat162*>(qs + il1 * BP + c);
      qdq0 = fmaf(__low2float(q0), dq[n][0], qdq0);
      qdq0 = fmaf(__high2float(q0), dq[n][1], qdq0);
      qdq1 = fmaf(__low2float(q1), dq[n][2], qdq1);
      qdq1 = fmaf(__high2float(q1), dq[n][3], qdq1);
      if (il0 < valid)
        *reinterpret_cast<__nv_bfloat162*>(dq_out + (t0 + il0) * k_st + c) =
            __floats2bfloat162_rn(dq[n][0], dq[n][1]);
      if (il1 < valid)
        *reinterpret_cast<__nv_bfloat162*>(dq_out + (t0 + il1) * k_st + c) =
            __floats2bfloat162_rn(dq[n][2], dq[n][3]);
    }
    qdq0 += __shfl_xor_sync(0xffffffffu, qdq0, 1);
    qdq0 += __shfl_xor_sync(0xffffffffu, qdq0, 2);
    qdq1 += __shfl_xor_sync(0xffffffffu, qdq1, 1);
    qdq1 += __shfl_xor_sync(0xffffffffu, qdq1, 2);
  }

  // 3. dS_{c+1} in place of S_c
  __syncthreads();
  copy_rows(S, SP, ds_c, (int64_t)vd, kd, kd, vd, tid, NTHR);
  cp_async_wait_all();
  __syncthreads();
  if (!active) return;

  // 4. dk and dv of the warp's 16 keys
  uint32_t va[KS][1][4], ka[KS][1][4];
#pragma unroll
  for (int s = 0; s < KS; ++s) {
    if (s * 16 < v16) load_a_bf(vs + r0 * BP + s * 16, BP, g, t4, va[s]);
    if (s * 16 < k16) load_a_bf(ks + r0 * BP + s * 16, BP, g, t4, ka[s]);
  }
  float dk[KN][4], dv[KN][4];
#pragma unroll
  for (int n = 0; n < KN; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
    if (n * 8 < kd)      // v·dS_{c+1}ᵀ, a k16 step of V at a time
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s * 16 >= v16) break;
        uint32_t sb[3][2];
        load_b_rows_f<3>(S + n * 8 * SP + s * 16, SP, g, t4, sb);
        float tmp[4];
        mma_step<1, 3>(tmp, va[s], sb);
        add4(dk[n], tmp);
      }
    if (n * 8 < vd)      // k·dS_{c+1}, a k16 step of K at a time
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s * 16 >= k16) break;
        uint32_t sb[3][2];
        load_b_cols_f<3>(S + s * 16 * SP + n * 8, SP, g, t4, sb);
        float tmp[4];
        mma_step<1, 3>(tmp, ka[s], sb);
        add4(dv[n], tmp);
      }
  }
  {
    const float f0 = expf(lz[len] - lz[il0 + 1]);
    const float f1 = expf(lz[len] - lz[il1 + 1]);
#pragma unroll
    for (int n = 0; n < KN; ++n) {
      dk[n][0] *= f0; dk[n][1] *= f0; dk[n][2] *= f1; dk[n][3] *= f1;
      dv[n][0] *= f0; dv[n][1] *= f0; dv[n][2] *= f1; dv[n][3] *= f1;
    }
  }
  // blocks of 16 queries from the diagonal on: dP̃ᵀ and s̃ᵀ (rows: keys)
  const int nb = (valid + 15) / 16;
  for (int ib = warp; ib < nb; ++ib) {
    float p[2][4], sc[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[h][e] = sc[h][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        if (s * 16 < v16) {
          uint32_t yb[1][2];
          load_b_rows_bf(ys + (ib * 16 + h * 8) * BP + s * 16, BP, g, t4, yb);
          float tmp[4];
          mma_step<1, 1>(tmp, va[s], yb);
          add4(p[h], tmp);
        }
        if (s * 16 < k16) {
          uint32_t qb[1][2];
          load_b_rows_bf(qs + (ib * 16 + h * 8) * BP + s * 16, BP, g, t4, qb);
          float tmp[4];
          mma_step<1, 1>(tmp, ka[s], qb);
          add4(sc[h], tmp);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = e < 2 ? il0 : il1;
        const int i = ib * 16 + h * 8 + 2 * t4 + e % 2;
        const float ex = i >= j ? expf(lz[i + 1] - lz[j + 1]) : 0.f;
        p[h][e] = i >= j ? p[h][e] * ex : 0.f;
        sc[h][e] = i >= j ? sc[h][e] * ex : 0.f;
      }
    }
    uint32_t pa[3][4], sa[3][4];
    acc_to_a3(p, pa);
    acc_to_a3(sc, sa);
#pragma unroll
    for (int n = 0; n < KN; ++n) {
      if (n * 8 < kd) {
        uint32_t qb[1][2];
        load_b_cols_bf(qs + ib * 16 * BP + n * 8, BP, g, t4, qb);
        float tmp[4];
        mma_step<3, 1>(tmp, pa, qb);
        add4(dk[n], tmp);
      }
      if (n * 8 < vd) {
        uint32_t yb[1][2];
        load_b_cols_bf(ys + ib * 16 * BP + n * 8, BP, g, t4, yb);
        float tmp[4];
        mma_step<3, 1>(tmp, sa, yb);
        add4(dv[n], tmp);
      }
    }
  }
  // dk, dv out; q ⊙ dq − k ⊙ dk into d log_decay (rows before T)
  float kdk0 = 0.f, kdk1 = 0.f;
#pragma unroll
  for (int n = 0; n < KN; ++n) {
    const int c = n * 8 + 2 * t4;
    if (n * 8 < kd && c < kd) {
      const __nv_bfloat162 k0 =
          *reinterpret_cast<const __nv_bfloat162*>(ks + il0 * BP + c);
      const __nv_bfloat162 k1 =
          *reinterpret_cast<const __nv_bfloat162*>(ks + il1 * BP + c);
      kdk0 = fmaf(__low2float(k0), dk[n][0], kdk0);
      kdk0 = fmaf(__high2float(k0), dk[n][1], kdk0);
      kdk1 = fmaf(__low2float(k1), dk[n][2], kdk1);
      kdk1 = fmaf(__high2float(k1), dk[n][3], kdk1);
      if (il0 < valid)
        *reinterpret_cast<__nv_bfloat162*>(dk_out + (t0 + il0) * k_st + c) =
            __floats2bfloat162_rn(dk[n][0], dk[n][1]);
      if (il1 < valid)
        *reinterpret_cast<__nv_bfloat162*>(dk_out + (t0 + il1) * k_st + c) =
            __floats2bfloat162_rn(dk[n][2], dk[n][3]);
    }
    if (n * 8 < vd && c < vd) {
      if (il0 < valid)
        *reinterpret_cast<__nv_bfloat162*>(dv_out + (t0 + il0) * v_st + c) =
            __floats2bfloat162_rn(dv[n][0], dv[n][1]);
      if (il1 < valid)
        *reinterpret_cast<__nv_bfloat162*>(dv_out + (t0 + il1) * v_st + c) =
            __floats2bfloat162_rn(dv[n][2], dv[n][3]);
    }
  }
  kdk0 += __shfl_xor_sync(0xffffffffu, kdk0, 1);
  kdk0 += __shfl_xor_sync(0xffffffffu, kdk0, 2);
  kdk1 += __shfl_xor_sync(0xffffffffu, kdk1, 1);
  kdk1 += __shfl_xor_sync(0xffffffffu, kdk1, 2);
  if (t4 == 0) {
    float* dld = a.dld + (size_t)b * t_len * a.h + hh;
    if (il0 < valid) dld[(t0 + il0) * a.h] = qdq0 - kdk0;
    if (il1 < valid) dld[(t0 + il1) * a.h] = qdq1 - kdk1;
  }
}

// ---------------------------------------------------------------------------
// (4) the decay's reverse sums, (5) d bonus
// ---------------------------------------------------------------------------

// d log_decay_t = Σ_{t' ≥ t} ∂/∂G_{t'}, in place: a block a (b, h, chunk).
// The carry over every later chunk, ⟨dS_{c+1}, S_{c+1}⟩ (0 for the last
// chunk), over V per channel (scalar: over K and V): per-thread partials
// (per channel: 4 threads a channel, a quarter of V each; scalar: every
// 256th element), combined pairwise in a fixed tree. Then a thread a
// channel sums the chunk's slots from its last token back, each token's
// sum plus the carry.
__global__ void __launch_bounds__(DEC_THREADS) gla_bwd_decay_kernel(Args a,
                                                                    int perch) {
  __shared__ float red[DEC_THREADS];
  __shared__ float carry_s[MAX_KV];
  const int tid = threadIdx.x, bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y;
  const int kd = a.kd, vd = a.vd, w = perch ? kd : 1;
  const int kv = kd * vd;
  const bool last = ch + 1 >= a.n_chunks;
  if (!last) {
    const float* g = a.ds + ((size_t)bh * a.n_chunks + ch) * kv;
    const float* sn = a.states + ((size_t)bh * a.n_chunks + ch + 1) * kv;
    float part = 0.f;
    if (perch) {
      const int kk = tid / 4, qq = tid % 4, vq = (vd + 3) / 4;
      if (kk < kd)
        for (int c = qq * vq; c < min(vd, (qq + 1) * vq); ++c)
          part = fmaf(g[kk * vd + c], sn[kk * vd + c], part);
    } else {
      for (int e = tid; e < kv; e += DEC_THREADS)
        part = fmaf(g[e], sn[e], part);
    }
    red[tid] = part;
    __syncthreads();
    if (perch) {
      if (tid < kd) {
        const float* r = red + 4 * tid;
        carry_s[tid] = (r[0] + r[1]) + (r[2] + r[3]);
      }
    } else {
      for (int s = DEC_THREADS / 2; s > 0; s >>= 1) {
        if (tid < s) red[tid] += red[tid + s];
        __syncthreads();
      }
      if (tid == 0) carry_s[0] = red[0];
    }
    __syncthreads();
  }
  if (tid >= w) return;
  const float carry = last ? 0.f : carry_s[tid];
  const int64_t t0 = ch * a.chunk;
  const int valid = (int)min((int64_t)a.chunk, a.t_len - t0);
  const int64_t st = (int64_t)a.h * w;
  float* p = a.dld + ((size_t)b * a.t_len * a.h + hh) * w + tid + t0 * st;
  float r = 0.f;
  for (int i0 = valid - 1; i0 >= 0; i0 -= LOAD_AHEAD) {
    float x[LOAD_AHEAD];
#pragma unroll
    for (int u = 0; u < LOAD_AHEAD; ++u)
      if (i0 - u >= 0) x[u] = p[(i0 - u) * st];
#pragma unroll
    for (int u = 0; u < LOAD_AHEAD; ++u)
      if (i0 - u >= 0) {
        r += x[u];
        p[(i0 - u) * st] = r + carry;
      }
  }
}

// d bonus (H, K): a thread an (h, channel), the chunks' partials summed
// over b, then over the chunks in sequence order
__global__ void __launch_bounds__(MAX_KV) gla_bwd_bonus_kernel(Args a) {
  const int kk = threadIdx.x, hh = blockIdx.x, kd = a.kd;
  if (kk >= kd) return;
  const int64_t n = a.n_chunks;
  float acc = 0.f;
  for (int b = 0; b < a.b; ++b) {
    const float* p = a.part + (size_t)(b * a.h + hh) * n * kd + kk;
    for (int64_t i = 0; i < n; ++i) acc += p[i * kd];
  }
  a.dbonus[(size_t)hh * kd + kk] = acc;
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
int launch(const Args& a, cudaStream_t st) {
  // the route, decided here alone: the tensor cores take bf16 inputs with
  // a scalar decay under "post", K and V multiples of 8 (Mamba2);
  // chunk_scan.bwd_route restates the condition for reporting
  constexpr bool TC_OK = sizeof(T) == 2 && !PERCH;
  const bool tc = TC_OK && !a.bonus && a.kd % 8 == 0 && a.vd % 8 == 0;
  static uint64_t qc_conf = 0, pair_conf = 0, qcm_conf = 0, pairm_conf = 0;
  static int qc_max[64], pair_max[64], qcm_max[64], pairm_max[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const unsigned bh = (unsigned)a.b * a.h;
  const dim3 chunks(bh, (unsigned)a.n_chunks);
  const int kp = round_up(a.kd, 4) + 4, vp = round_up(a.vd, 4) + 4;
  if constexpr (TC_OK) {
    if (tc) {
      const size_t qc_smem = (size_t)2 * LT * BP * 2 +
                             (size_t)round_up(LT + 1, 4) * 4;
      const size_t pair_smem = tc_smem_bytes(LT);
      err = configure(gla_bwd_qc_mma_kernel<LT>, qcm_conf, qcm_max);
      if (err == cudaSuccess)
        err = configure(gla_bwd_pair_mma_kernel<LT>, pairm_conf, pairm_max);
      if (err != cudaSuccess) return (int)err;
      if (qc_smem > (size_t)qcm_max[dev] || pair_smem > (size_t)pairm_max[dev])
        return (int)cudaErrorInvalidValue;
      gla_bwd_qc_mma_kernel<LT><<<chunks, QC_THREADS, qc_smem, st>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      gla_bwd_scan_kernel<<<dim3(bh, (a.kd * a.vd + SCAN_THREADS - 1) /
                                         SCAN_THREADS),
                            SCAN_THREADS, 0, st>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      gla_bwd_pair_mma_kernel<LT><<<chunks, 2 * LT, pair_smem, st>>>(a);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      gla_bwd_decay_kernel<<<chunks, DEC_THREADS, 0, st>>>(a, 0);
      return (int)cudaGetLastError();
    }
  }
  const size_t qc_smem = sizeof(float) *
      ((size_t)LT * (kp + vp) + round_up((LT + 1) * (PERCH ? kp : 1), 4));
  const size_t pair_smem = PairSmem(LT, a.kd, a.vd, PERCH).bytes();
  err = configure(gla_bwd_qc_kernel<T, LT, PERCH>, qc_conf, qc_max);
  if (err == cudaSuccess)
    err = configure(gla_bwd_pair_kernel<T, LT, PERCH>, pair_conf, pair_max);
  if (err != cudaSuccess) return (int)err;
  if (qc_smem > (size_t)qc_max[dev] || pair_smem > (size_t)pair_max[dev])
    return (int)cudaErrorInvalidValue;
  gla_bwd_qc_kernel<T, LT, PERCH><<<chunks, S_THREADS, qc_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gla_bwd_scan_kernel<<<dim3(bh, (a.kd * a.vd + SCAN_THREADS - 1) /
                                     SCAN_THREADS),
                        SCAN_THREADS, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gla_bwd_pair_kernel<T, LT, PERCH><<<chunks, THREADS, pair_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gla_bwd_decay_kernel<<<chunks, DEC_THREADS, 0, st>>>(a, PERCH ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a.bonus) gla_bwd_bonus_kernel<<<a.h, MAX_KV, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool PERCH>
int dispatch_len(const Args& a, cudaStream_t st) {
  // RWKV6 chunks by 32, Mamba2 by its config's 128 (or a shorter T)
  if (a.chunk <= 32) return launch<T, 32, PERCH>(a, st);
  if (a.chunk <= 128) return launch<T, 128, PERCH>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One call: four or five launches, the route chosen from the inputs
// (`launch`). `ws` holds B·H·⌈T/chunk⌉·K·V floats
// (Q_c, then dS), then B·H·⌈T/chunk⌉·K (the chunks' decays), then
// B·H·⌈T/chunk⌉·K (the bonus partials), none with an initial value; dq,
// dk, dv, dld contiguous.
extern "C" int gla_chunk_bwd_f32(
    const void* q, const void* k, const void* v, const void* dy,
    const float* ld, const float* bonus, const float* states, void* dq,
    void* dk, void* dv, float* dld, float* dbonus, float* ws, int bf16_in,
    int per_channel, int64_t b, int64_t t_len, int64_t h, int64_t kd,
    int64_t vd, int64_t chunk, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides,
    const int64_t* y_strides, const int64_t* l_strides, void* stream) {
  if (kd < 1 || kd > MAX_KV || vd < 1 || vd > MAX_KV || chunk < 1 ||
      chunk > 128 || b < 1 || h < 1 || t_len < 1 || b * h > INT32_MAX ||
      (t_len + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.dy = dy; a.ld = ld; a.bonus = bonus;
  a.states = states; a.dq = dq; a.dk = dk; a.dv = dv; a.dld = dld;
  a.dbonus = dbonus;
  a.t_len = t_len; a.n_chunks = (t_len + chunk - 1) / chunk;
  a.b = (int)b; a.h = (int)h; a.kd = (int)kd; a.vd = (int)vd;
  a.chunk = (int)chunk;
  const size_t n_chunks = (size_t)(b * h) * a.n_chunks;
  a.ds = ws;
  a.dc = ws + n_chunks * kd * vd;
  a.part = a.dc + n_chunks * kd;
  a.q_sb = q_strides[0]; a.q_st = q_strides[1]; a.q_sh = q_strides[2];
  a.k_sb = k_strides[0]; a.k_st = k_strides[1]; a.k_sh = k_strides[2];
  a.v_sb = v_strides[0]; a.v_st = v_strides[1]; a.v_sh = v_strides[2];
  a.y_sb = y_strides[0]; a.y_st = y_strides[1]; a.y_sh = y_strides[2];
  a.l_sb = l_strides[0]; a.l_st = l_strides[1]; a.l_sh = l_strides[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16_in)
    return per_channel ? dispatch_len<bf16, true>(a, st)
                       : dispatch_len<bf16, false>(a, st);
  return per_channel ? dispatch_len<float, true>(a, st)
                     : dispatch_len<float, false>(a, st);
}
