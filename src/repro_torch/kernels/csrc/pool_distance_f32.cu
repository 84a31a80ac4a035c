// Pool-distance statistics sweep for Hopper (sm_90a), forward and backward.
//
// Forward: for every member t of a stacked pool (and every run b),
//   sq[t] = Σ(w − m_t)²,  l1[t] = Σ|w − m_t|,  dot[t] = Σ w·m_t,
//   norm[t] = Σ m_t²,     and once per run  wsq = Σ w²,
// over all parameter leaves, read in f32 or bf16, summed in f32.
// Backward (no TPU original: the reference differentiates its jnp path):
//   ∂/∂w = 2Σ_t ḡsq_t·(w − m_t) + Σ_t ḡl1_t·s(w − m_t) + Σ_t ḡdot_t·m_t
//          + 2·ḡwsq·w,   s(x) = +1 for x ≥ 0, −1 otherwise
// (JAX's derivative of |x|); ḡnorm has no term, the members carry no
// gradient. f32 only.
//
// Replaces: src/repro/kernels/pool_distance.py:_pool_distance_stats_batched
// (body _pd_kernel_batched; front pool_distance_stats). The Pallas kernel
// walks one flat parameter vector in blocks of 65,536 on a sequential grid
// axis and adds each block's sums into a resident (C, 1) output, so its
// callers concatenate the whole pool first (ops.tree_pool_distances). Here
// nothing is copied: the launch carries a table of leaves by value (each
// leaf's w, its member 0 and the strides between members and runs), and
// each block finds its leaf and chunk in that table, as sgd_f32.cu does.
// Blocks on the card run in no order, so the sum over P is two stages
// that give the same bits on every run: each block writes its chunk's
// 4·C + 1 sums to a workspace; the last block of each run to finish —
// counted with an integer atomic, never a float one — adds the chunks'
// partials in a fixed order, as factor_gram_f32.cu does.
//
// Inside a block, thread i owns the four-element groups i, i + 256, i + 512
// and i + 768 of its 4,096-element chunk, loaded as one 16-byte (f32) or
// 8-byte (bf16) vector where every pointer of the leaf is aligned and
// element by element otherwise (the CNN's fc2.b has 10 elements); either
// way each thread adds its 16 elements in the same order, so alignment
// never changes a bit. The thread keeps its 16 w values in registers and
// walks the members, each member's four sums reduced over the block by a
// warp shuffle tree and then the 8 warps in order.
//
// Summation chain (the longest run of dependent f32 additions, which the
// tolerance of chip_smoke.py's phase 15 is derived from): 16 in a thread,
// 5 shuffle levels, 7 warps, then ⌈chunks/4⌉ + 2 across chunks.
//
// Bound on an H100 SXM: bytes. The forward reads w and the C members once,
// (C + 1)·P·4 bytes at f32 (the paper CNN's P = 1,422,218 at capacity 4:
// 28.4 MB, 8.5 µs at 3.35 TB/s) for ~8 operations an element and member;
// the backward reads them again and writes ∂w, (C + 2)·P·4 bytes.
//
// Plain C interface for ctypes. The caller passes host arrays of the
// leaves' pointers, sizes and strides (in elements), a workspace of
// (B · total blocks · (4C + 1)) floats and B zeroed int32 counters; the
// entry packs the leaves into tables of MAX_LEAVES and launches once per
// table on the caller's stream (blocks of later launches count on from
// earlier ones, so the last block of the last launch adds every chunk).
// It returns cudaGetLastError() and writes the number of launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUPS = 4;                         // 4-element groups a thread
constexpr int PER_THREAD = GROUPS * 4;            // 16 elements
constexpr int64_t CHUNK = THREADS * PER_THREAD;   // 4,096 elements a block
constexpr int MAX_LEAVES = 40;                    // table < 4 KB of params
constexpr int MAX_MEMBERS = 63;  // 4C + 1 ≤ THREADS (pool_distance.py too)

struct Leaf {
  const void* w;        // run 0's w
  const void* m;        // run 0's member 0
  float* out;           // run 0's ∂w (backward)
  int64_t n;            // elements of the leaf
  int64_t w_run;        // elements between two runs' w
  int64_t m_run;        // … between two runs' member 0
  int64_t m_member;     // … between two members
  int64_t o_run;        // … between two runs' ∂w
  int64_t first_block;  // global index of the leaf's first block
  int aligned;          // every pointer the leaf reads (and writes) aligned
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n_leaves;
  int64_t block0;       // global index of this launch's first block
};

__device__ __forceinline__ float load(const void* p, int64_t i, int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// the four elements of group g (elements 4g … 4g + 3 of the chunk)
__device__ __forceinline__ void load4(const void* base, int64_t start,
                                      int64_t len, int64_t g, int bf16,
                                      int aligned, float v[4]) {
  const int64_t e = start + 4 * g;
  if (aligned && 4 * g + 3 < len) {
    if (bf16) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          static_cast<const __nv_bfloat16*>(base) + e);
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
      v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(
          static_cast<const float*>(base) + e);
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    v[j] = 4 * g + j < len ? load(base, e + j, bf16) : 0.f;
}

__device__ __forceinline__ const void* offset(const void* p, int64_t i,
                                              int bf16) {
  return bf16 ? static_cast<const void*>(
                    static_cast<const __nv_bfloat16*>(p) + i)
              : static_cast<const void*>(static_cast<const float*>(p) + i);
}

// The leaf whose blocks hold global block gb (the table is in block order).
__device__ __forceinline__ int find_leaf(const Table& t, int64_t gb) {
  int li = 0;
  while (li + 1 < t.n_leaves && t.leaf[li + 1].first_block <= gb) ++li;
  return li;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

__global__ void __launch_bounds__(THREADS)
pool_distance_kernel(const __grid_constant__ Table table, int c, int bf16,
                     int64_t total_blocks, float* __restrict__ stats,
                     float* __restrict__ wsq, float* __restrict__ part,
                     int* __restrict__ counters) {
  __shared__ float red[WARPS][4];
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = blockIdx.y;
  const int64_t gb = table.block0 + blockIdx.x;
  const Leaf& leaf = table.leaf[find_leaf(table, gb)];
  const int64_t start = (gb - leaf.first_block) * CHUNK;
  const int64_t len = leaf.n - start < CHUNK ? leaf.n - start : CHUNK;
  const int n_out = 4 * c + 1;
  float* mine = part + (b * total_blocks + gb) * n_out;

  float w[PER_THREAD];
  const void* wb = offset(leaf.w, b * leaf.w_run, bf16);
#pragma unroll
  for (int k = 0; k < GROUPS; ++k)
    load4(wb, start, len, tid + k * THREADS, bf16, leaf.aligned, w + 4 * k);

  // the block's sums: per member sq, l1, dot, norm; then Σ w² (slot 4C)
  for (int t = 0; t <= c; ++t) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (t < c) {
      const void* mb = offset(leaf.m, b * leaf.m_run + t * leaf.m_member, bf16);
#pragma unroll
      for (int k = 0; k < GROUPS; ++k) {
        float m[4];
        load4(mb, start, len, tid + k * THREADS, bf16, leaf.aligned, m);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = w[4 * k + j], y = m[j], r = x - y;
          s[0] = fmaf(r, r, s[0]);
          s[1] += fabsf(r);
          s[2] = fmaf(x, y, s[2]);
          s[3] = fmaf(y, y, s[3]);
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < PER_THREAD; ++e) s[0] = fmaf(w[e], w[e], s[0]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] = warp_sum(s[q]);
    if (lane == 0) {
#pragma unroll
      for (int q = 0; q < 4; ++q) red[warp][q] = s[q];
    }
    __syncthreads();
    if (tid < (t < c ? 4 : 1)) {
      float acc = red[0][tid];
#pragma unroll
      for (int v = 1; v < WARPS; ++v) acc += red[v][tid];
      mine[t < c ? tid * c + t : 4 * c] = acc;
    }
    __syncthreads();  // red is read before the next member writes it
  }

  // the last block of run b adds the chunks' partials: four running sums
  // over chunks ≡ 0, 1, 2, 3 (mod 4), then (s0 + s1) + (s2 + s3)
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counters + b, 1) == total_blocks - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const float* all = part + b * total_blocks * n_out;
  for (int j = tid; j < n_out; j += THREADS) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    int64_t g = 0;
    for (; g + 4 <= total_blocks; g += 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) s[q] += __ldcg(all + (g + q) * n_out + j);
    }
    for (int q = 0; g < total_blocks; ++g, ++q)
      s[q] += __ldcg(all + g * n_out + j);
    const float sum = (s[0] + s[1]) + (s[2] + s[3]);
    if (j < 4 * c) stats[b * 4 * c + j] = sum;
    else wsq[b] = sum;
  }
}

__global__ void __launch_bounds__(THREADS)
pool_distance_bwd_kernel(const __grid_constant__ Table table, int c,
                         const float* __restrict__ g_stats,
                         const float* __restrict__ g_wsq) {
  // ḡsq, ḡl1, ḡdot of run b's members (rows 0–2 of its (4, C) block)
  __shared__ float g[3 * MAX_MEMBERS];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.y;
  for (int j = tid; j < 3 * c; j += THREADS) g[j] = g_stats[b * 4 * c + j];
  const float two_gw = 2.f * g_wsq[b];
  __syncthreads();

  const int64_t gb = table.block0 + blockIdx.x;
  const Leaf& leaf = table.leaf[find_leaf(table, gb)];
  const int64_t start = (gb - leaf.first_block) * CHUNK;
  const int64_t len = leaf.n - start < CHUNK ? leaf.n - start : CHUNK;
  const float* wb = static_cast<const float*>(leaf.w) + b * leaf.w_run;
  float* ob = leaf.out + b * leaf.o_run;

  float w[PER_THREAD], acc[PER_THREAD];
#pragma unroll
  for (int k = 0; k < GROUPS; ++k)
    load4(wb, start, len, tid + k * THREADS, 0, leaf.aligned, w + 4 * k);
#pragma unroll
  for (int e = 0; e < PER_THREAD; ++e) acc[e] = two_gw * w[e];
  for (int t = 0; t < c; ++t) {
    const float* mb = static_cast<const float*>(leaf.m) + b * leaf.m_run +
                      t * leaf.m_member;
    const float gs2 = 2.f * g[t], gl = g[c + t], gd = g[2 * c + t];
#pragma unroll
    for (int k = 0; k < GROUPS; ++k) {
      float m[4];
      load4(mb, start, len, tid + k * THREADS, 0, leaf.aligned, m);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float r = w[4 * k + j] - m[j];
        float a = acc[4 * k + j];
        a = fmaf(gs2, r, a);
        a += r >= 0.f ? gl : -gl;
        acc[4 * k + j] = fmaf(gd, m[j], a);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < GROUPS; ++k) {
    const int64_t g4 = tid + k * THREADS;
    if (leaf.aligned && 4 * g4 + 3 < len) {
      *reinterpret_cast<float4*>(ob + start + 4 * g4) =
          make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2],
                      acc[4 * k + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * g4 + j < len) ob[start + 4 * g4 + j] = acc[4 * k + j];
    }
  }
}

bool aligned_to(const void* p, int64_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

// Packs the leaves into tables and launches `launch(table)` once per table.
template <typename Launch>
int for_each_table(const void* const* w, const void* const* m,
                   void* const* out, const int64_t* n, const int64_t* w_run,
                   const int64_t* m_run, const int64_t* m_member,
                   const int64_t* o_run, int n_leaves, int b, int c,
                   int esz, Launch launch, int* launches) {
  *launches = 0;
  Table table;
  table.n_leaves = 0;
  table.block0 = 0;
  int64_t blocks = 0;  // global block count so far
  const int64_t vec = 4 * esz;  // bytes of a 4-element group
  for (int i = 0; i <= n_leaves; ++i) {
    const bool flush = i == n_leaves || table.n_leaves == MAX_LEAVES;
    if (flush && table.n_leaves > 0) {
      launch(table, blocks - table.block0);
      ++*launches;
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      table.n_leaves = 0;
      table.block0 = blocks;
    }
    if (i == n_leaves || n[i] == 0) continue;
    Leaf& leaf = table.leaf[table.n_leaves++];
    leaf.w = w[i];
    leaf.m = m[i];
    leaf.out = out ? static_cast<float*>(out[i]) : nullptr;
    leaf.n = n[i];
    leaf.w_run = w_run[i];
    leaf.m_run = m_run[i];
    leaf.m_member = m_member[i];
    leaf.o_run = o_run ? o_run[i] : 0;
    leaf.first_block = blocks;
    bool ok = aligned_to(w[i], vec) && aligned_to(m[i], vec) &&
              (b == 1 || ((w_run[i] * esz) % vec == 0 &&
                          (m_run[i] * esz) % vec == 0)) &&
              (c == 1 || (m_member[i] * esz) % vec == 0);
    if (out)
      ok = ok && aligned_to(out[i], vec) &&
           (b == 1 || (o_run[i] * esz) % vec == 0);
    leaf.aligned = ok;
    blocks += (n[i] + CHUNK - 1) / CHUNK;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int pool_distance_f32_chunk() { return static_cast<int>(CHUNK); }

// Forward. w, m: host arrays of n_leaves device pointers (run 0's w and
// member 0 of each leaf; f32, or bf16 when bf16 != 0); n, w_run, m_run,
// m_member: host arrays of sizes and strides in elements. stats: (B, 4, C)
// f32 (sq, l1, dot, norm); wsq: (B,) f32; part: the workspace; counters: B
// zeroed ints. Empty leaves are skipped; at least one leaf is not empty.
extern "C" int pool_distance_f32(const void* const* w, const void* const* m,
                                 const int64_t* n, const int64_t* w_run,
                                 const int64_t* m_run,
                                 const int64_t* m_member, int n_leaves,
                                 int b, int c, int bf16, float* stats,
                                 float* wsq, float* part, int* counters,
                                 void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t total = 0;
  for (int i = 0; i < n_leaves; ++i) total += (n[i] + CHUNK - 1) / CHUNK;
  return for_each_table(
      w, m, nullptr, n, w_run, m_run, m_member, nullptr, n_leaves, b, c,
      bf16 ? 2 : 4,
      [&](const Table& table, int64_t blocks) {
        pool_distance_kernel<<<dim3(static_cast<unsigned>(blocks),
                                    static_cast<unsigned>(b)),
                               THREADS, 0, s>>>(table, c, bf16, total, stats,
                                                wsq, part, counters);
      },
      launches);
}

// Backward (f32). out: host array of device pointers to each leaf's ∂w of
// run 0, o_run its run stride; g_stats (B, 4, C) and g_wsq (B,) f32 in
// device memory (row 3 of g_stats, ḡnorm, is not read).
extern "C" int pool_distance_bwd_f32(const void* const* w,
                                     const void* const* m, void* const* out,
                                     const int64_t* n, const int64_t* w_run,
                                     const int64_t* m_run,
                                     const int64_t* m_member,
                                     const int64_t* o_run, int n_leaves,
                                     int b, int c, const float* g_stats,
                                     const float* g_wsq, void* stream,
                                     int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return for_each_table(
      w, m, out, n, w_run, m_run, m_member, o_run, n_leaves, b, c, 4,
      [&](const Table& table, int64_t blocks) {
        pool_distance_bwd_kernel<<<dim3(static_cast<unsigned>(blocks),
                                        static_cast<unsigned>(b)),
                                   THREADS, 0, s>>>(table, c, g_stats, g_wsq);
      },
      launches);
}
