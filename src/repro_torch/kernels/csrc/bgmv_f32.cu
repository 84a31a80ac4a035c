// Batched low-rank correction (BGMV) for Hopper (sm_90a): for every pool
// member s, y_s = (x_s · u_s) · v_sᵀ in f32.
//
//   x (S, N, d_in) per member, or (N, d_in) shared by all members; f32 or
//   bf16 (converted to f32 as it is staged)
//   u (S, d_in, r), v (S, d_out, r) f32  →  y (S, N, d_out) f32
//
// Replaces: src/repro/kernels/bgmv.py:bgmv_pallas (body _bgmv_kernel). The
// Pallas grid is (S, N-blocks) with each member's whole factor panels
// resident in VMEM; at the factored serving shapes (N = 32 rows) that is
// S = 5 blocks, and neither factor panel of the (8192 → 2048) down
// projection fits one SM's shared memory (256 KB of f32 each). Here one
// call runs the Punica-style pair of kernels on the caller's stream:
//
// * shrink, grid (d_in / 256, N / 32, S): each block sums x·u over 256
//   columns of d_in for 32 rows, staging x (converted to f32) and u in
//   shared memory with coalesced loads. A thread owns a 4-row × 2-rank
//   tile — eight independent sums, six shared-memory reads for eight FMAs
//   — and the threads of the 16·⌈r/2⌉ tiles form groups that each take
//   every G-th column (G = 8 at r = 8), added in group order. The block
//   writes its (32, r) partial to a workspace the caller allocates
//   (`bgmv_f32_workspace` floats).
// * expand, grid (d_out / 512, N / 32, S): each block adds the partials
//   of its rows in split order (t = x·u), then every thread produces 2
//   output columns for all 32 rows, y[n, o] = Σ_j t[n, j]·v[o, j],
//   reading each v row once and writing coalesced rows of y.
//
// At the serving shapes that is 40–160 shrink blocks and 10–1,255 expand
// blocks a call, where a single (tile, member) block doing both spent most
// of its time in a serial x·u over d_in on a handful of SMs.
//
// Bound on an H100 SXM: bytes. The work is 2·N·r·(d_in + d_out) FLOP per
// member on N·d_in + (d_in + d_out)·r + N·d_out words — a few FLOP a
// byte, far below the f32 ridge; the workspace adds 4·r·N·d_in/256 bytes
// each way (1/32 of x's f32 bytes at r = 8).
//
// Arithmetic: f32 FMAs in a fixed order, no atomics, so a call is
// deterministic. It differs from the plain version (`ref.bgmv_ref`, two
// cuBLAS products) by the order of the d_in summation only.
//
// Plain C interface for ctypes; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NB = 32;            // activation rows per block
constexpr int DC = 128;           // d_in columns per staged chunk
constexpr int DS = 2 * DC;        // d_in columns per shrink block
constexpr int MAX_R = 64;         // largest rank the kernel takes
constexpr int RW = 4;             // rows of t per thread
constexpr int RT = 2;             // ranks of t per thread
constexpr int X_PER_THREAD = NB * DC / THREADS;       // staged x values
constexpr int U_PER_THREAD = DC * MAX_R / THREADS;    // staged u values
constexpr int O_PER_THREAD = 2;
constexpr int O_TILE = THREADS * O_PER_THREAD;  // output columns per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared memory of a shrink block at rank r, in floats: x chunk, u chunk,
// the micro-tiles' partial sums.
__host__ __device__ constexpr int shrink_floats(int r) {
  return NB * (DC + 1) + DC * r + THREADS * RW * RT;
}

// Shrink: part[s][nb][split] = x[rows of nb, cols of split] · u[cols, :]
// for one (split of DS columns, block of NB rows, member).
template <typename T>
__global__ void __launch_bounds__(THREADS)
shrink_kernel(const T* __restrict__ x, const float* __restrict__ u,
              float* __restrict__ part, int n, int d_in, int r,
              int shared_x, int n_split) {
  extern __shared__ float smem[];
  float* xs = smem;                     // [NB][DC + 1]
  float* us = xs + NB * (DC + 1);       // [DC][r]
  float* red = us + DC * r;             // [G][tiles][RW·RT]

  const int tid = threadIdx.x;
  const int split = blockIdx.x, nb = blockIdx.y, s = blockIdx.z;
  const int n0 = nb * NB;
  const int rows = min(NB, n - n0);
  const int c0 = split * DS, c1 = min(d_in, c0 + DS);
  const T* xb = x + (shared_x ? 0 : (size_t)s * n * d_in) + (size_t)n0 * d_in;
  const float* ub = u + (size_t)s * d_in * r;

  // micro-tiles of RW rows × RT ranks (8 independent sums a thread); the
  // tiles' threads form G groups, group g summing every G-th column
  const int rank_groups = (r + RT - 1) / RT;
  const int tiles = (NB / RW) * rank_groups;
  const int G = THREADS / tiles;
  const int q = tid % tiles, g = tid / tiles;
  const int rb = (q / rank_groups) * RW, jb = (q % rank_groups) * RT;
  float acc[RW][RT];
#pragma unroll
  for (int i = 0; i < RW; ++i)
#pragma unroll
    for (int k = 0; k < RT; ++k) acc[i][k] = 0.f;

  for (int d0 = c0; d0 < c1; d0 += DC) {
    const int dc = min(DC, c1 - d0);
    __syncthreads();  // the previous chunk is summed
#pragma unroll
    for (int i = 0; i < X_PER_THREAD; ++i) {
      const int e = tid + i * THREADS, nn = e / DC, dd = e % DC;
      xs[nn * (DC + 1) + dd] =
          (nn < rows && dd < dc) ? to_f32(xb[(size_t)nn * d_in + d0 + dd])
                                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < U_PER_THREAD; ++i) {
      const int e = tid + i * THREADS;
      if (e >= DC * r) break;
      us[e] = e / r < dc ? ub[(size_t)d0 * r + e] : 0.f;
    }
    __syncthreads();
    if (g < G) {
      for (int dd = g; dd < DC; dd += G) {
        float xv[RW], uv[RT];
#pragma unroll
        for (int i = 0; i < RW; ++i) xv[i] = xs[(rb + i) * (DC + 1) + dd];
#pragma unroll
        for (int k = 0; k < RT; ++k)
          uv[k] = jb + k < r ? us[dd * r + jb + k] : 0.f;
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
          for (int k = 0; k < RT; ++k)
            acc[i][k] = fmaf(xv[i], uv[k], acc[i][k]);
      }
    }
  }
  if (g < G) {
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int k = 0; k < RT; ++k)
        red[(g * tiles + q) * RW * RT + i * RT + k] = acc[i][k];
  }
  __syncthreads();
  float* out = part + (((size_t)s * gridDim.y + nb) * n_split + split) * NB * r;
  for (int e = tid; e < NB * r; e += THREADS) {
    const int nn = e / r, j = e % r;
    const int tile = (nn / RW) * rank_groups + j / RT;
    const int slot = (nn % RW) * RT + j % RT;
    float t = 0.f;
    for (int gg = 0; gg < G; ++gg)
      t += red[(gg * tiles + tile) * RW * RT + slot];
    out[e] = t;
  }
}

// Expand: y[n, o] = Σ_j t[n, j]·v[o, j] for one (tile of O_TILE columns,
// block of NB rows, member), t summed over the shrink splits in order.
__global__ void __launch_bounds__(THREADS)
expand_kernel(const float* __restrict__ part, const float* __restrict__ v,
              float* __restrict__ y, int n, int d_out, int r, int n_split) {
  extern __shared__ float smem[];
  float* ts = smem;                     // [NB][r + 1]
  const int tid = threadIdx.x;
  const int nb = blockIdx.y, s = blockIdx.z;
  const int n0 = nb * NB;
  const int rows = min(NB, n - n0);
  const int o0 = blockIdx.x * O_TILE;
  const float* pb = part + ((size_t)s * gridDim.y + nb) * n_split * NB * r;
  for (int e = tid; e < NB * r; e += THREADS) {
    float t = 0.f;
    for (int k = 0; k < n_split; ++k) t += pb[(size_t)k * NB * r + e];
    ts[(e / r) * (r + 1) + e % r] = t;
  }
  __syncthreads();
  const float* vb = v + (size_t)s * d_out * r;
  float* yb = y + ((size_t)s * n + n0) * d_out;
  for (int c = 0; c < O_PER_THREAD; ++c) {
    const int o = o0 + c * THREADS + tid;
    if (o >= d_out) break;
    float out[NB];
#pragma unroll
    for (int nn = 0; nn < NB; ++nn) out[nn] = 0.f;
    const float* vrow = vb + (size_t)o * r;
    for (int j = 0; j < r; ++j) {
      const float vj = vrow[j];
#pragma unroll
      for (int nn = 0; nn < NB; ++nn)
        out[nn] = fmaf(ts[nn * (r + 1) + j], vj, out[nn]);
    }
#pragma unroll
    for (int nn = 0; nn < NB; ++nn)
      if (nn < rows) yb[(size_t)nn * d_out + o] = out[nn];
  }
}

template <typename T>
int launch(const void* x, const float* u, const float* v, float* y,
           float* part, int64_t s, int64_t n, int64_t d_in, int64_t d_out,
           int64_t r, int shared_x, cudaStream_t st) {
  // the attribute is per device: one bit per device it was set on
  static uint64_t configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(
        shrink_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * shrink_floats(MAX_R)));
    if (err != cudaSuccess) return (int)err;
    configured |= bit;
  }
  const unsigned n_blocks = (unsigned)((n + NB - 1) / NB);
  const int n_split = (int)((d_in + DS - 1) / DS);
  shrink_kernel<T><<<dim3((unsigned)n_split, n_blocks, (unsigned)s), THREADS,
                     sizeof(float) * shrink_floats((int)r), st>>>(
      static_cast<const T*>(x), u, part, (int)n, (int)d_in, (int)r, shared_x,
      n_split);
  expand_kernel<<<dim3((unsigned)((d_out + O_TILE - 1) / O_TILE), n_blocks,
                       (unsigned)s),
                  THREADS, sizeof(float) * NB * (r + 1), st>>>(
      part, v, y, (int)n, (int)d_out, (int)r, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of workspace a call at this shape needs (the shrink partials).
extern "C" int64_t bgmv_f32_workspace(int64_t s, int64_t n, int64_t d_in,
                                      int64_t r) {
  return s * ((n + NB - 1) / NB) * ((d_in + DS - 1) / DS) * NB * r;
}

extern "C" int bgmv_f32(const void* x, int x_bf16, const float* u,
                        const float* v, float* y, float* part, int64_t s,
                        int64_t n, int64_t d_in, int64_t d_out, int64_t r,
                        int shared_x, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, u, v, y, part, s, n, d_in, d_out,
                                        r, shared_x, st)
                : launch<float>(x, u, v, y, part, s, n, d_in, d_out, r,
                                shared_x, st);
}
