// f32 GEMM for Hopper (sm_90a): C(M,N) = op(A)(M,K) · op(B)(K,N), summed in
// full f32 with FFMA — no TF32, no tensor cores, because the reference
// accumulates in f32.
//
// Replaces: src/repro/kernels/local_step.py:matmul_blocked (Pallas blocked
// GEMM, body _mm_kernel) and the two backward products of its custom VJP
// (_make_gemm_pallas: dA = G·Bᵀ, dB = Aᵀ·G). The TPU kernel walks K as the
// innermost sequential grid axis and accumulates into a revisited output
// tile; here blocks run in parallel with nothing carried between them, so
// each block owns one 64×64 output tile and loops over K itself.
//
// Bound on an H100 SXM: the larger of 2·M·N·K FLOP at 67 TFLOP/s (f32 FFMA)
// and (M·K + K·N + M·N)·4 bytes at 3.35 TB/s. The paper CNN's forward and
// dA products are FLOP-bound; c1's (K = 27) are byte-bound. The dB products
// reduce over M (up to 65,536) into small outputs and so launch only a few
// blocks: this simple design leaves most SMs idle there (no split-K yet).
//
// Design: 256 threads per block, each accumulating a 4×4 micro-tile in
// registers; K advances in panels of 16 staged through shared memory (A's
// panel stored k-major so a thread reads its 4 rows as one float4). Loads
// are masked at every ragged edge (c1 has K = 27), so no operand needs
// padding. Summation is two-level, as the reference's is: each 128-wide
// chunk of K sums into a fresh partial that is then added to the tile's
// accumulator (the Pallas kernel adds one 128-wide K block at a time).
// One running sum over all of K would round like K·2⁻²⁴ — ~4e-3 relative
// at K = 65,536 on c1's weight gradient, which cancels heavily — where
// two levels round like (128 + K/128)·2⁻²⁴. The transpose flags choose, at compile time, the thread→element
// map that keeps global loads coalesced for row-major or transposed
// operands, so the backward products run without transposed copies.
//
// Plain C interface for ctypes: pointers and the stream come as void*, the
// launch goes on the caller's stream, and the return value is
// cudaGetLastError() (0 = launched).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps rows 16-byte aligned, eases bank conflicts
constexpr int CHUNK_K = 128;  // K per partial sum (the reference's BLOCK_K)

template <bool TA, bool TB>
__global__ void __launch_bounds__(THREADS)
gemm_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int64_t M, int64_t N, int64_t K,
                int64_t lda, int64_t ldb, int64_t ldc) {
  __shared__ __align__(16) float As[BK][BM + PAD];
  __shared__ __align__(16) float Bs[BK][BN + PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;

  float acc[TM][TN];
  float part[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    // op(A)[m0 + i, k0 + kk] -> As[kk][i]
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      // stored (K, M) when transposed: neighbouring threads take
      // neighbouring m; stored (M, K) otherwise: neighbouring k
      const int i = TA ? e % BM : e / BK;
      const int kk = TA ? e / BM : e % BK;
      const int64_t gm = m0 + i;
      const int64_t gk = k0 + kk;
      float v = 0.f;
      if (gm < M && gk < K) v = TA ? A[gk * lda + gm] : A[gm * lda + gk];
      As[kk][i] = v;
    }
    // op(B)[k0 + kk, n0 + j] -> Bs[kk][j]
#pragma unroll
    for (int r = 0; r < (BN * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      // stored (N, K) when transposed: neighbouring k; stored (K, N)
      // otherwise: neighbouring n
      const int j = TB ? e / BK : e % BN;
      const int kk = TB ? e % BK : e / BN;
      const int64_t gn = n0 + j;
      const int64_t gk = k0 + kk;
      float v = 0.f;
      if (gn < N && gk < K) v = TB ? B[gn * ldb + gk] : B[gk * ldb + gn];
      Bs[kk][j] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * TN]);
      const float av[TM] = {a.x, a.y, a.z, a.w};
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    __syncthreads();

    if ((k0 + BK) % CHUNK_K == 0 || k0 + BK >= K) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t gn = n0 + tx * TN + j;
      if (gn < N) C[gm * ldc + gn] = acc[i][j];
    }
  }
}

}  // namespace

// A is stored (M, K) row-major, or (K, M) when trans_a; B is stored (K, N),
// or (N, K) when trans_b; C is (M, N) row-major. All contiguous.
extern "C" int gemm_f32(const void* a, const void* b, void* c, int64_t m,
                        int64_t n, int64_t k, int trans_a, int trans_b,
                        void* stream) {
  const float* A = static_cast<const float*>(a);
  const float* B = static_cast<const float*>(b);
  float* C = static_cast<float*>(c);
  const int64_t lda = trans_a ? m : k;
  const int64_t ldb = trans_b ? k : n;
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (trans_a) {
    if (trans_b)
      gemm_f32_kernel<true, true><<<grid, block, 0, s>>>(A, B, C, m, n, k, lda, ldb, n);
    else
      gemm_f32_kernel<true, false><<<grid, block, 0, s>>>(A, B, C, m, n, k, lda, ldb, n);
  } else {
    if (trans_b)
      gemm_f32_kernel<false, true><<<grid, block, 0, s>>>(A, B, C, m, n, k, lda, ldb, n);
    else
      gemm_f32_kernel<false, false><<<grid, block, 0, s>>>(A, B, C, m, n, k, lda, ldb, n);
  }
  return static_cast<int>(cudaGetLastError());
}
