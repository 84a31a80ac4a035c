// Factor Gram for Hopper (sm_90a): G_b = A_b·A_bᵀ over the long trailing
// axis, A (B, M, P) f32 → G (B, M, M) f32, M = pool capacity × rank.
//
// Replaces: src/repro/kernels/pool_distance.py:factor_gram (body
// _gram_kernel). The Pallas kernel walks P in blocks of 2,048 on a
// sequential grid axis and adds each block's product into one resident
// (M, M) tile. Blocks on the card run in no order, so the sum over P
// becomes two stages that give the same bits on every run: each block of
// the grid (P chunk, output tile, b) computes one 64×64 output tile over
// its chunk of columns and writes it to a workspace; the last block of
// each (b, output tile) to finish — counted with an integer atomic, never
// a float one — adds the chunks' partials in a fixed order and writes G.
// The chunk width is a function of the shape that puts ~264 blocks in the
// grid (two per SM). Inside a block, 256 threads own 4×4 outputs each;
// A's rows for the tile are staged 32 columns at a time in shared memory
// (coalesced loads, the next 32 prefetched into registers while these are
// summed), and every output sums its chunk's columns in order.
//
// Bound on an H100 SXM: bytes at the pool's shapes, barely. M = 40 rows
// of P = 16 … 128,256 f32 are read once (4·M·P bytes) for 2·M²·P FLOP: 20
// FLOP a byte, exactly the f32 ridge (67 TFLOP/s over 3.35 TB/s), and the
// output's bytes tip it; the workspace adds 16 KB per chunk and tile.
//
// Plain C interface for ctypes; the caller passes the workspace
// (`factor_gram_f32_workspace` floats) and zeroed int32 counters
// (B·tiles²). Returns cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 64;       // output tile edge
constexpr int MICRO = 4;       // outputs per thread along each edge
constexpr int TP = 32;         // columns staged at a time
constexpr int TARGET_BLOCKS = 264;  // two blocks per SM of an H100
constexpr int LOADS = TILE * TP / THREADS;  // staged values per thread

// Columns of P per block: enough chunks that the grid holds about
// TARGET_BLOCKS blocks, a multiple of TP. A function of the shape alone,
// so the summation order (and the bits) never depend on the run.
int64_t chunk_cols(int64_t b, int64_t m, int64_t p) {
  const int64_t tiles = (m + TILE - 1) / TILE;
  int64_t chunks = (TARGET_BLOCKS + b * tiles * tiles - 1) /
                   (b * tiles * tiles);
  if (chunks < 1) chunks = 1;
  int64_t cols = (p + chunks - 1) / chunks;
  return (cols + TP - 1) / TP * TP;
}

__global__ void __launch_bounds__(THREADS)
factor_gram_kernel(const float* __restrict__ a, float* __restrict__ out,
                   float* __restrict__ part, int* __restrict__ counters,
                   int m, int64_t p, int64_t pc, int n_chunks, int n_tiles) {
  __shared__ float ai[TILE][TP + 1];
  __shared__ float aj[TILE][TP + 1];
  __shared__ int is_last;

  const int tid = threadIdx.x;
  const int tx = tid % (TILE / MICRO), ty = tid / (TILE / MICRO);
  const int chunk = blockIdx.x;
  const int tile = blockIdx.y;
  const int b = blockIdx.z;
  const int ti = tile / n_tiles, tj = tile % n_tiles;
  const float* ab = a + (size_t)b * m * p;
  const int64_t c0 = (int64_t)chunk * pc;
  const int64_t c1 = p < c0 + pc ? p : c0 + pc;

  float acc[MICRO][MICRO];
#pragma unroll
  for (int x = 0; x < MICRO; ++x)
#pragma unroll
    for (int y = 0; y < MICRO; ++y) acc[x][y] = 0.f;

  // the next TP columns are loaded into registers while these are summed
  float ri[LOADS], rj[LOADS];
  auto load = [&](int64_t p0) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * THREADS, rr = e / TP, cc = e % TP;
      const int64_t col = p0 + cc;
      const int row_i = ti * TILE + rr, row_j = tj * TILE + rr;
      ri[i] = (row_i < m && col < c1) ? ab[(size_t)row_i * p + col] : 0.f;
      rj[i] = (row_j < m && col < c1) ? ab[(size_t)row_j * p + col] : 0.f;
    }
  };
  load(c0);
  for (int64_t p0 = c0; p0 < c1; p0 += TP) {
    __syncthreads();  // the previous columns are summed
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * THREADS;
      ai[e / TP][e % TP] = ri[i];
      aj[e / TP][e % TP] = rj[i];
    }
    __syncthreads();
    if (p0 + TP < c1) load(p0 + TP);
#pragma unroll 4
    for (int cc = 0; cc < TP; ++cc) {
      float xi[MICRO], xj[MICRO];
#pragma unroll
      for (int x = 0; x < MICRO; ++x) xi[x] = ai[ty * MICRO + x][cc];
#pragma unroll
      for (int y = 0; y < MICRO; ++y) xj[y] = aj[tx * MICRO + y][cc];
#pragma unroll
      for (int x = 0; x < MICRO; ++x)
#pragma unroll
        for (int y = 0; y < MICRO; ++y) acc[x][y] = fmaf(xi[x], xj[y], acc[x][y]);
    }
  }

  const size_t slot = ((size_t)b * n_tiles * n_tiles + tile) * n_chunks;
  float* mine = part + (slot + chunk) * TILE * TILE;
#pragma unroll
  for (int x = 0; x < MICRO; ++x)
#pragma unroll
    for (int y = 0; y < MICRO; ++y)
      mine[(ty * MICRO + x) * TILE + tx * MICRO + y] = acc[x][y];

  // the last block of this (b, tile) adds the chunks' partials: four
  // running sums over chunks c ≡ 0, 1, 2, 3 (mod 4), then (s0+s1)+(s2+s3)
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int done = atomicAdd(counters + (size_t)b * n_tiles * n_tiles + tile, 1);
    is_last = done == n_chunks - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* all = part + slot * TILE * TILE;
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int row = ti * TILE + e / TILE, col = tj * TILE + e % TILE;
    if (row >= m || col >= m) continue;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    int c = 0;
    for (; c + 4 <= n_chunks; c += 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        s[k] += __ldcg(all + (size_t)(c + k) * TILE * TILE + e);
    }
    for (int k = 0; c < n_chunks; ++c, ++k)
      s[k] += __ldcg(all + (size_t)c * TILE * TILE + e);
    out[((size_t)b * m + row) * m + col] = (s[0] + s[1]) + (s[2] + s[3]);
  }
}

}  // namespace

// Floats of workspace a call at this shape needs.
extern "C" int64_t factor_gram_f32_workspace(int64_t b, int64_t m,
                                             int64_t p) {
  const int64_t tiles = (m + TILE - 1) / TILE;
  const int64_t pc = chunk_cols(b, m, p);
  return b * tiles * tiles * ((p + pc - 1) / pc) * TILE * TILE;
}

extern "C" int factor_gram_f32(const float* a, float* out, float* part,
                               int* counters, int64_t b, int64_t m, int64_t p,
                               void* stream) {
  const int64_t pc = chunk_cols(b, m, p);
  const int n_chunks = (int)((p + pc - 1) / pc);
  const int n_tiles = (int)((m + TILE - 1) / TILE);
  const dim3 grid((unsigned)n_chunks, (unsigned)(n_tiles * n_tiles),
                  (unsigned)b);
  factor_gram_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, out, part, counters, (int)m, p, pc, n_chunks, n_tiles);
  return (int)cudaGetLastError();
}
