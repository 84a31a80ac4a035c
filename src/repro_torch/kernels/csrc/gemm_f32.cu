// f32 GEMM for Hopper (sm_90a): C(M,N) = op(A)(M,K) · op(B)(K,N), summed in
// full f32 with FFMA — no TF32, no tensor cores, because the reference
// accumulates in f32 (TF32 keeps ~10 mantissa bits; a 3×TF32 split is a
// later candidate).
//
// Replaces: src/repro/kernels/local_step.py:matmul_blocked (Pallas blocked
// GEMM, body _mm_kernel) and the two backward products of its custom VJP
// (_make_gemm_pallas: dA = G·Bᵀ, dB = Aᵀ·G). The TPU kernel walks K as the
// innermost sequential grid axis and accumulates into a revisited output
// tile; here blocks run in parallel with nothing carried between them.
//
// Bound on an H100 SXM: the larger of 2·M·N·K FLOP at 67 TFLOP/s (f32 FFMA)
// and (M·K + K·N + M·N)·4 bytes at 3.35 TB/s. The paper CNN's forward, dA
// and dB products of c2 and c3 are FLOP-bound; c1's (K = 27 forward, M = 27
// weight gradient) are byte-bound.
//
// Design. The plan — block tile, number of K slices, slice length — is
// chosen per product by `gemm_plan` in kernels/local_step.py and passed
// in; the kernel computes what the plan says.
//  * Block tiles of 128×128, 128×64 or 64×64 outputs, 256 threads, each
//    thread an 8×8, 8×4 or 4×4 register micro-tile whose rows and columns
//    come in runs of 4, read from shared memory as float4 (an 8-wide run is
//    split into two 4-runs half a tile apart, so the 8 lanes of a
//    shared-memory phase read consecutive 16 bytes). The two smaller tiles
//    are held to 128 registers, two blocks an SM; the 128×128 tile's two
//    levels of 64 sums take 255 registers, one block an SM, so the plan
//    gives it only long K.
//  * K advances in panels of 16, staged through a 3-deep ring in shared
//    memory by cp.async, so two panels are in flight while one computes
//    and one barrier separates panels. op(A) is stored k-major ([k][m])
//    and op(B) [k][n]. An operand whose memory runs along the stored
//    dimension (A transposed, B plain) is copied 16 bytes at a time when
//    its leading dimension and pointer allow; otherwise (c1's lda = 27,
//    and the operands that must be transposed on the way in) 4 bytes at a
//    time, with neighbouring threads on neighbouring addresses. Out of range
//    elements are zero-filled by the copy (src-size 0): every ragged edge
//    is masked and no operand is padded.
//  * Split-K for products with few output tiles and a long K (every dB:
//    c1's 27×64 output is one tile over K = 65,536). Block z of a tile
//    takes the slice [z·slice_k, (z+1)·slice_k), slice_k a multiple of 128.
//    Each block writes its slice's sum to a workspace; an integer atomic on
//    the tile's counter finds the tile's last block, which adds the slices
//    in index order (fixed order: the result does not depend on which
//    block finishes last) and resets the counter to 0 for the next launch.
//    No float atomics; one product is one launch.
//  * A run axis: R independent products of one shape (the B runs of a
//    batched training step) in one launch. Grid z is runs × slices, block
//    z taking run z / splits and slice z % splits; run r reads A and B at
//    r times their run strides (0 for an operand the runs share) and
//    writes C's r-th (M, N) matrix. Each run has its own split tiles,
//    workspace and counters, and the plan is the one product's, so a
//    batched launch computes each run's product bit for bit as a launch
//    of that product alone.
//
// Error model. Summation is two-level within a block, as the reference's
// is: each 128-wide chunk of K sums by FMA into a fresh partial that is
// then added to the block's accumulator (the Pallas kernel adds one
// 128-wide K block at a time); split products add a third level, the
// slices, in index order. One running sum over all of K would round like
// K·2⁻²⁴ — ~4e-3 relative at K = 65,536 on c1's weight gradient, which
// cancels heavily — where these levels round like
// (128 + slice_k/128 + splits)·2⁻²⁴ relative to Σ|a·b|: at most ~650·2⁻²⁴
// on the paper CNN's products.
//
// Plain C interface for ctypes: pointers and the stream come as void*, the
// launch goes on the caller's stream, and the return value is
// cudaGetLastError() (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;        // K per panel
constexpr int STAGES = 3;     // panels in the shared-memory ring
constexpr int PAD = 4;        // keeps rows 16-byte aligned, eases bank conflicts
constexpr int CHUNK_K = 128;  // K per partial sum (the reference's BLOCK_K)
constexpr int PANELS_PER_CHUNK = CHUNK_K / BK;

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand's panels, [BK][W] in shared memory (row stride W + PAD),
// copied by cp.async. Element (k, w) of the operand lies at src[k·ld + w]
// when ALONG (memory runs along w: 16-byte copies where `vec`, else 4-byte)
// or at src[w·ld + k] otherwise (4-byte copies into the transposed slot;
// neighbouring threads take neighbouring k). Everything a thread needs per
// copy is fixed at construction; a panel adds one pointer step.
template <int W, bool ALONG>
struct PanelCopier {
  static_assert(BK * W % (4 * THREADS) == 0, "whole copies a thread");
  static constexpr int MAX_COPIES = BK * W / THREADS;
  const float* origin;  // a valid address for the copies out of range
  const float* src;     // this thread's first copy of panel 0
  int64_t src_step;     // between this thread's copies
  int64_t panel_step;   // between panels
  int dst, dst_step;    // in floats, within a stage
  int k0, k_step;       // the first copy's k within its panel; k between copies
  int copies;
  unsigned w_ok;        // bit r: copy r lies inside the operand along w
  bool vec;

  __device__ PanelCopier(const float* s, int64_t ld, int64_t w0, int64_t wn,
                         int64_t kb, bool vec_ok, int tid)
      : origin(s), vec(ALONG && vec_ok) {
    if (ALONG) {
      const int per_row = vec ? W / 4 : W;  // copies a k row takes
      const int wl = tid % per_row * (vec ? 4 : 1);
      k0 = tid / per_row;
      k_step = THREADS / per_row;
      copies = BK / k_step;
      src = s + (kb + k0) * ld + w0 + wl;
      src_step = k_step * ld;
      panel_step = BK * ld;
      dst = k0 * (W + PAD) + wl;
      dst_step = k_step * (W + PAD);
      // ld % 4 == 0 when vec, so wn % 4 == 0: a 4-run is in or out whole
      w_ok = w0 + wl < wn ? ~0u : 0u;
    } else {
      constexpr int w_step = THREADS / BK;
      const int wl = tid / BK;
      k0 = tid % BK;
      k_step = 0;
      copies = MAX_COPIES;
      src = s + (w0 + wl) * ld + kb + k0;
      src_step = w_step * ld;
      panel_step = BK;
      dst = k0 * (W + PAD) + wl;
      dst_step = w_step;
      w_ok = 0;
#pragma unroll
      for (int r = 0; r < MAX_COPIES; ++r)
        if (w0 + wl + r * w_step < wn) w_ok |= 1u << r;
    }
  }

  // panel p (its first k is k_panel) into `stage`; k past ke is zero-filled
  __device__ __forceinline__ void copy(float* stage, int p, int64_t k_panel,
                                       int64_t ke) const {
    const float* s = src + p * panel_step;
#pragma unroll
    for (int r = 0; r < MAX_COPIES; ++r) {
      if (r >= copies) break;
      const bool ok = (w_ok >> r & 1u) && k_panel + k0 + r * k_step < ke;
      float* d = stage + dst + r * dst_step;
      if (vec)
        cp_async16(d, ok ? s + r * src_step : origin, ok);
      else
        cp_async4(d, ok ? s + r * src_step : origin, ok);
    }
  }
};

// row (or column) of micro-tile entry i: runs of 4, an 8-run split in two
// halves BM/2 apart
template <int BW, int TW>
__device__ __forceinline__ int tile_index(int t, int i) {
  return (i / 4) * (BW / (TW / 4)) + t * 4 + (i % 4);
}

template <int BM, int BN, int TM, int TN, int MIN_BLOCKS, bool TA, bool TB>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int64_t M, int64_t N, int64_t K,
                int64_t lda, int64_t ldb, int64_t a_run, int64_t b_run,
                int64_t slice_k, int splits, float* __restrict__ ws,
                int* __restrict__ counters) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "one micro-tile a thread");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tiles in runs of 4");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                  // [STAGES][BK][BM+PAD]
  float* Bs = smem + STAGES * BK * (BM + PAD);       // [STAGES][BK][BN+PAD]
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int run = blockIdx.z / splits;
  const int slice = blockIdx.z % splits;
  A += run * a_run;
  B += run * b_run;
  C += run * M * N;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const int64_t kb = static_cast<int64_t>(slice) * slice_k;
  const int64_t ke = kb + slice_k < K ? kb + slice_k : K;
  const int n_panels = static_cast<int>((ke - kb + BK - 1) / BK);

  // 16-byte copies where the stored rows allow them
  const bool vec_a = TA && lda % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(A) & 15) == 0;
  const bool vec_b = !TB && ldb % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(B) & 15) == 0;

  // op(A)(m, k): A[k·lda + m] when transposed, else A[m·lda + k];
  // op(B)(k, n): B[n·ldb + k] when transposed, else B[k·ldb + n]
  const PanelCopier<BM, TA> copy_a(A, lda, m0, M, kb, vec_a, tid);
  const PanelCopier<BN, !TB> copy_b(B, ldb, n0, N, kb, vec_b, tid);
  auto load = [&](int p, int stage) {
    const int64_t k_panel = kb + static_cast<int64_t>(p) * BK;
    copy_a.copy(As + stage * BK * (BM + PAD), p, k_panel, ke);
    copy_b.copy(Bs + stage * BK * (BN + PAD), p, k_panel, ke);
  };

  float acc[TM][TN];
  float part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_panels) load(s, s);
    cp_async_commit();
  }

  for (int p = 0; p < n_panels; ++p) {
    cp_async_wait<STAGES - 2>();  // panel p has landed (this thread's part)
    __syncthreads();              // ... every thread's; panel p-1 is done
    if (p + STAGES - 1 < n_panels) load(p + STAGES - 1, (p + STAGES - 1) % STAGES);
    cp_async_commit();

    const float* as = As + (p % STAGES) * BK * (BM + PAD);
    const float* bs = Bs + (p % STAGES) * BK * (BN + PAD);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int h = 0; h < TM / 4; ++h) {
        const float4 x = *reinterpret_cast<const float4*>(
            as + kk * (BM + PAD) + tile_index<BM, TM>(ty, 4 * h));
        av[4 * h] = x.x; av[4 * h + 1] = x.y;
        av[4 * h + 2] = x.z; av[4 * h + 3] = x.w;
      }
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 x = *reinterpret_cast<const float4*>(
            bs + kk * (BN + PAD) + tile_index<BN, TN>(tx, 4 * h));
        bv[4 * h] = x.x; bv[4 * h + 1] = x.y;
        bv[4 * h + 2] = x.z; bv[4 * h + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }

    // a 128-wide chunk of K is summed (or the slice's K is exhausted):
    // add its partial to the accumulator
    if ((p + 1) % PANELS_PER_CHUNK == 0 || p + 1 == n_panels) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  if (splits == 1) {
    const bool vec_c = N % 4 == 0 && (reinterpret_cast<uintptr_t>(C) & 15) == 0;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int64_t gm = m0 + tile_index<BM, TM>(ty, i);
      if (gm >= M) continue;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const int64_t gn = n0 + tile_index<BN, TN>(tx, 4 * h);
        float* c = C + gm * N + gn;
        if (vec_c && gn < N) {
          *reinterpret_cast<float4*>(c) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
              acc[i][4 * h + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) c[j] = acc[i][4 * h + j];
        }
      }
    }
    return;
  }

  // split-K: this slice's sums to the workspace, [run][tile][slice][BM][BN]
  const int tile = (run * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  float* mine = ws + (static_cast<int64_t>(tile) * splits + slice) * BM * BN;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      *reinterpret_cast<float4*>(mine + tile_index<BM, TM>(ty, i) * BN +
                                 tile_index<BN, TN>(tx, 4 * h)) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    is_last = atomicAdd(counters + tile, 1) == splits - 1;
    if (is_last) counters[tile] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the tile's last block: add the slices in index order
  const float4* all = reinterpret_cast<const float4*>(
      ws + static_cast<int64_t>(tile) * splits * BM * BN);
  constexpr int V = BM * BN / 4 / THREADS;  // float4s a thread
  float4 sum[V];
#pragma unroll
  for (int v = 0; v < V; ++v) sum[v] = __ldcg(all + tid + v * THREADS);
#pragma unroll 4
  for (int s = 1; s < splits; ++s) {
    const float4* sl = all + static_cast<int64_t>(s) * (BM * BN / 4);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float4 x = __ldcg(sl + tid + v * THREADS);
      sum[v].x += x.x; sum[v].y += x.y; sum[v].z += x.z; sum[v].w += x.w;
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const int e = 4 * (tid + v * THREADS);
    const int64_t gm = m0 + e / BN, gn = n0 + e % BN;
    if (gm >= M) continue;
    const float x[4] = {sum[v].x, sum[v].y, sum[v].z, sum[v].w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < N) C[gm * N + gn + j] = x[j];
  }
}

template <int BM, int BN>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) * STAGES * BK * (BM + PAD + BN + PAD);
}

template <int BM, int BN, int TM, int TN, int MIN_BLOCKS, bool TA, bool TB>
int launch(const float* A, const float* B, float* C, int64_t m, int64_t n,
           int64_t k, int64_t lda, int64_t ldb, int64_t a_run, int64_t b_run,
           int runs, int64_t slice_k, int splits, float* ws, int* counters,
           cudaStream_t s) {
  // the attribute is per device: one bit per device it was set on
  static uint64_t configured = 0;
  constexpr int smem = smem_bytes<BM, BN>();
  auto kernel = gemm_f32_kernel<BM, BN, TM, TN, MIN_BLOCKS, TA, TB>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM),
                  static_cast<unsigned>(runs * splits));
  kernel<<<grid, THREADS, smem, s>>>(A, B, C, m, n, k, lda, ldb, a_run, b_run,
                                     slice_k, splits, ws, counters);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int TM, int TN, int MIN_BLOCKS>
int dispatch(const float* A, const float* B, float* C, int64_t m, int64_t n,
             int64_t k, int64_t a_run, int64_t b_run, int runs, int trans_a,
             int trans_b, int64_t slice_k, int splits, float* ws,
             int* counters, cudaStream_t s) {
  const int64_t lda = trans_a ? m : k;
  const int64_t ldb = trans_b ? k : n;
  if (trans_a) {
    if (trans_b)
      return launch<BM, BN, TM, TN, MIN_BLOCKS, true, true>(
          A, B, C, m, n, k, lda, ldb, a_run, b_run, runs, slice_k, splits, ws,
          counters, s);
    return launch<BM, BN, TM, TN, MIN_BLOCKS, true, false>(
        A, B, C, m, n, k, lda, ldb, a_run, b_run, runs, slice_k, splits, ws,
        counters, s);
  }
  if (trans_b)
    return launch<BM, BN, TM, TN, MIN_BLOCKS, false, true>(
        A, B, C, m, n, k, lda, ldb, a_run, b_run, runs, slice_k, splits, ws,
        counters, s);
  return launch<BM, BN, TM, TN, MIN_BLOCKS, false, false>(
      A, B, C, m, n, k, lda, ldb, a_run, b_run, runs, slice_k, splits, ws,
      counters, s);
}

}  // namespace

// A is stored (M, K) row-major, or (K, M) when trans_a; B is stored (K, N),
// or (N, K) when trans_b; C is (M, N) row-major. All contiguous. `runs`
// products in one launch: run r reads A + r·a_run and B + r·b_run (strides
// in floats; 0 for an operand the runs share) and writes C + r·M·N. The
// plan: `tile` 0, 1 or 2 for 128×128, 128×64 or 64×64 block tiles;
// `splits` slices of `slice_k` (a multiple of 128) along K. With
// splits > 1, `ws` holds runs·tiles·splits·BM·BN floats and `counters` one
// int per run and tile, all 0 (the kernel leaves them 0).
extern "C" int gemm_f32(const void* a, const void* b, void* c, int64_t m,
                        int64_t n, int64_t k, int runs, int64_t a_run,
                        int64_t b_run, int trans_a, int trans_b, int tile,
                        int64_t slice_k, int splits, void* ws, void* counters,
                        void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  float* W = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || runs < 1 || a_run < 0 || b_run < 0 ||
      static_cast<int64_t>(runs) * splits > 65535 ||
      (splits > 1 && (slice_k % CHUNK_K != 0 || W == nullptr ||
                      cnt == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (tile) {
    case 0:
      return dispatch<128, 128, 8, 8, 1>(A, B, C, m, n, k, a_run, b_run, runs,
                                         trans_a, trans_b, slice_k, splits, W,
                                         cnt, s);
    case 1:
      return dispatch<128, 64, 8, 4, 2>(A, B, C, m, n, k, a_run, b_run, runs,
                                        trans_a, trans_b, slice_k, splits, W,
                                        cnt, s);
    case 2:
      return dispatch<64, 64, 4, 4, 2>(A, B, C, m, n, k, a_run, b_run, runs,
                                       trans_a, trans_b, slice_k, splits, W,
                                       cnt, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
