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
// gradient. w and the members are read in f32 or bf16 as the forward reads
// them, the sum is formed in f32 in the same order for both, and ∂w is
// written in the leaves' type: a bf16 ∂w is the f32 sum rounded once
// (round to nearest even). The Eq. 9 step's d1 and d2 share one call of each:
// d2's anchor is the pool's member 0, and autograd adds both terms' ḡ into
// the one (4, C) ḡ.
//
// Replaces: src/repro/kernels/pool_distance.py:_pool_distance_stats_batched
// (body _pd_kernel_batched; front pool_distance_stats). The Pallas kernel
// walks one flat parameter vector in blocks of 65,536 on a sequential grid
// axis and adds each block's sums into a resident (C, 1) output, so its
// callers concatenate the whole pool first (ops.tree_pool_distances). Here
// nothing is copied: the launch carries a table of leaves by value (each
// leaf's w, its member 0 and the strides between members and runs), and
// each block finds the leaf of each of its chunks in that table.
//
// Bound on an H100 SXM: bytes. The forward reads w and the C members once,
// (C + 1)·P·4 bytes at f32 (the paper CNN's P = 1,422,218 at capacity 4:
// 28.4 MB, 8.5 µs at 3.35 TB/s) for ~8 operations an element and member;
// the backward reads them again and writes ∂w, (C + 2)·P·4 bytes (half
// that in bf16: llama3.2-1b's 1.236 B parameters at C = 1 are 7.4 GB, 2.2
// ms). What the design does about it:
//
// * One resident wave of blocks that walk the chunks. A launch has
//   min(chunks, 2·132) blocks (__launch_bounds__ keeps two on each SM);
//   block j takes the chunks j, j + gridDim.x, … of its table and keeps
//   its sums in registers across them, so it pays its reduction once.
// * Every byte of a chunk in flight before any arithmetic. A chunk is
//   1,024·G elements of one leaf; thread i owns its four-element groups
//   i + k·256 (k < G). For each chunk it issues the loads of its w and of
//   every member of the pass (MC members: C itself up to 8, passes of 8
//   above) and only then adds: 16-byte (f32) or 8-byte (bf16) vectors where
//   every pointer of the leaf is aligned and the group lies inside the
//   leaf, element by element otherwise (the CNN's fc2.b has 10 elements),
//   in the same order either way, so alignment never changes a bit. MC and
//   G are template parameters; pool_distance.py `sweep_plan` picks the
//   widest G whose (MC + 1)·4·G loaded values stay within 48 registers.
// * One block reduction for all 4C + 1 sums: each warp adds its lanes' sums
//   by a shuffle tree, lane 0 puts them in shared memory, and after one
//   barrier thread j adds sum j of the 8 warps in order.
// * A parallel tail. Each block writes its 4C + 1 partials to a workspace
//   laid out sum-major, (B, 4C + 1, slots: the blocks of every launch); the
//   last block of each run to finish — counted with an integer atomic on a
//   counter that it then sets back to 0, never a float atomic — adds the
//   partials with one warp per sum, four sums a warp at a time: lane l
//   takes slots l, l + 32, … in order, then a shuffle tree adds the lanes.
//   The order is fixed, so runs repeat bit for bit, and a run's sums do not
//   depend on the other runs of the batch.
//
// Summation chain (the longest run of dependent f32 roundings of a sum,
// which phase 15 of chip_smoke.py derives its tolerance from;
// pool_distance.py `SweepPlan.chain`): 2 to form a term, 4·G adds a chunk
// over the most chunks a block walks, 5 shuffle levels, 7 warps, then
// ⌈slots/32⌉ in a lane of the tail and 5 shuffle levels.
//
// Plain C interface for ctypes. The caller passes host arrays of the
// leaves' pointers, sizes and strides (in elements), the plan (G; the
// grid's cap), a workspace of B · slots · (4C + 1) floats and B int32
// counters that are 0 (the kernel leaves them 0); the entry packs the
// leaves into tables of MAX_LEAVES and launches once per table on the
// caller's stream (the last block of the last launch adds every slot). It
// returns cudaGetLastError() and writes the number of launches.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <vector>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEAVES = 40;   // table < 4 KB of params
constexpr int MAX_MEMBERS = 63;  // 4C + 1 ≤ THREADS (pool_distance.py too)
constexpr int ROUND = 8;         // members a pass holds, at most
constexpr int BLOCKS_PER_SM = 2;

// The (MC, G) instances: members a pass and four-element groups a thread,
// for each MC the widest G whose (MC + 1)·4·G loaded values stay within
// 48 registers (pool_distance.py GROUPS).
#define SWEEP_INSTANCES(X) \
  X(1, 4) X(2, 4) X(3, 2) X(4, 2) X(5, 2) X(6, 1) X(7, 1) X(8, 1)

struct Leaf {
  const void* w;        // run 0's w
  const void* m;        // run 0's member 0
  void* out;            // run 0's ∂w (backward), of the leaves' type
  int64_t n;            // elements of the leaf
  int64_t w_run;        // elements between two runs' w
  int64_t m_run;        // … between two runs' member 0
  int64_t m_member;     // … between two members
  int64_t o_run;        // … between two runs' ∂w
  int64_t first_chunk;  // index of the leaf's first chunk in its table
  int aligned;          // every pointer the leaf reads (and writes) aligned
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n_leaves;
  int64_t chunks;       // chunks of the table's leaves
  int64_t slot0;        // partial slot of this launch's block 0
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four elements as one streaming load (ld.global.cs): each byte is read
// once, so it may leave the cache first.
__device__ __forceinline__ void vec4(const float* p, float v[4]) {
  const float4 f = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}

__device__ __forceinline__ void vec4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// This thread's 4·G elements of the chunk at p (len elements of it inside
// the leaf; zeros past them): group k is elements 4(tid + k·256) … + 3.
template <typename T, int G>
__device__ __forceinline__ void load_chunk(const T* p, int64_t len,
                                           int aligned, float v[4 * G]) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int64_t e = 4 * (threadIdx.x + k * THREADS);
    if (aligned && e + 3 < len) {
      vec4(p + e, v + 4 * k);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[4 * k + j] = e + j < len ? to_f32(p[e + j]) : 0.f;
    }
  }
}

__device__ __forceinline__ void from_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

// Four elements as one store: 16 bytes of f32, or 8 bytes of bf16, each
// value rounded once to nearest even.
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&a);
  raw.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// This thread's 4·G values of the chunk at p, as load_chunk lays them out
// (the len elements inside the leaf; nothing past them).
template <typename T, int G>
__device__ __forceinline__ void store_chunk(T* p, int64_t len, int aligned,
                                            const float v[4 * G]) {
#pragma unroll
  for (int k = 0; k < G; ++k) {
    const int64_t e = 4 * (threadIdx.x + k * THREADS);
    if (aligned && e + 3 < len) {
      store4(p + e, v + 4 * k);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < len) from_f32(v[4 * k + j], p + e + j);
    }
  }
}

// Chunk k of the table: its leaf (the leaves in chunk order), its first
// element and the elements of it inside the leaf.
struct Place {
  const Leaf* leaf;
  int64_t start, len;
};

template <int G>
__device__ __forceinline__ Place place(const Table& t, int64_t k) {
  constexpr int64_t CHUNK = 4 * THREADS * G;
  int li = 0;
  while (li + 1 < t.n_leaves && t.leaf[li + 1].first_chunk <= k) ++li;
  const Leaf& leaf = t.leaf[li];
  const int64_t start = (k - leaf.first_chunk) * CHUNK;
  return {&leaf, start, leaf.n - start < CHUNK ? leaf.n - start : CHUNK};
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int MC, int G>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
pool_distance_kernel(const __grid_constant__ Table table, int c,
                     int64_t slots, float* __restrict__ stats,
                     float* __restrict__ wsq, float* __restrict__ part,
                     int* __restrict__ counters) {
  constexpr int E = 4 * G;                    // elements a thread a chunk
  extern __shared__ float red[];              // [WARPS][4C + 1]
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t b = blockIdx.y;
  const int n_out = 4 * c + 1;
  float* mine = red + warp * n_out;

  // this thread's sums over its elements of the block's chunks, in chunk
  // order: per member sq, l1, dot, norm; Σ w² in the first pass
  float sw = 0.f;
  for (int t0 = 0; t0 < c; t0 += MC) {
    float s[MC][4];
#pragma unroll
    for (int u = 0; u < MC; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[u][q] = 0.f;
    for (int64_t k = blockIdx.x; k < table.chunks; k += gridDim.x) {
      const Place p = place<G>(table, k);
      const Leaf& l = *p.leaf;
      const T* wp = static_cast<const T*>(l.w) + b * l.w_run + p.start;
      const T* mp = static_cast<const T*>(l.m) + b * l.m_run + p.start +
                    t0 * l.m_member;
      float w[E], m[MC][E];
      load_chunk<T, G>(wp, p.len, l.aligned, w);
#pragma unroll
      for (int u = 0; u < MC; ++u)
        if (t0 + u < c)
          load_chunk<T, G>(mp + u * l.m_member, p.len, l.aligned, m[u]);
#pragma unroll
      for (int u = 0; u < MC; ++u) {
        if (t0 + u >= c) break;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float x = w[e], y = m[u][e], r = x - y;
          s[u][0] = fmaf(r, r, s[u][0]);
          s[u][1] += fabsf(r);
          s[u][2] = fmaf(x, y, s[u][2]);
          s[u][3] = fmaf(y, y, s[u][3]);
        }
      }
      if (t0 == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) sw = fmaf(w[e], w[e], sw);
      }
    }
#pragma unroll
    for (int u = 0; u < MC; ++u) {
      if (t0 + u >= c) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float v = warp_sum(s[u][q]);
        if (lane == 0) mine[q * c + t0 + u] = v;
      }
    }
  }
  sw = warp_sum(sw);
  if (lane == 0) mine[4 * c] = sw;
  __syncthreads();

  // the block's partials, the 8 warps added in order, sum-major
  float* run_part = part + b * n_out * slots;
  if (tid < n_out) {
    float acc = red[tid];
#pragma unroll
    for (int v = 1; v < WARPS; ++v) acc += red[v * n_out + tid];
    run_part[tid * slots + table.slot0 + blockIdx.x] = acc;
  }

  // the last block of run b adds the slots' partials: a warp a sum, four
  // sums a warp at a time. Thread 0 counts the block in with an atomic
  // that releases the partials the barrier ordered before it and, in the
  // last block, acquires every other block's for the threads after the
  // next barrier.
  __syncthreads();
  if (tid == 0) {
    int before;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(before) : "l"(counters + b) : "memory");
    is_last = before == slots - 1;
    if (is_last) counters[b] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  for (int j0 = warp; j0 < n_out; j0 += 4 * WARPS) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
    for (int64_t i = lane; i < slots; i += 32) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (j0 + q * WARPS < n_out)
          acc[q] += __ldcg(run_part + (j0 + q * WARPS) * slots + i);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q * WARPS;
      const float v = warp_sum(acc[q]);
      if (lane == 0 && j < n_out) {
        if (j < 4 * c) stats[b * 4 * c + j] = v;
        else wsq[b] = v;
      }
    }
  }
}

template <typename T, int MC, int G>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
pool_distance_bwd_kernel(const __grid_constant__ Table table, int c,
                         const float* __restrict__ g_stats,
                         const float* __restrict__ g_wsq) {
  constexpr int E = 4 * G;
  const int64_t b = blockIdx.y;
  // ḡsq, ḡl1, ḡdot of run b's members: rows 0–2 of its (4, C) block, the
  // same addresses in every thread
  const float* g = g_stats + b * 4 * c;
  const float two_gw = 2.f * __ldg(g_wsq + b);
  for (int64_t k = blockIdx.x; k < table.chunks; k += gridDim.x) {
    const Place p = place<G>(table, k);
    const Leaf& l = *p.leaf;
    const T* wp = static_cast<const T*>(l.w) + b * l.w_run + p.start;
    const T* mp = static_cast<const T*>(l.m) + b * l.m_run + p.start;
    float w[E], acc[E];
    load_chunk<T, G>(wp, p.len, l.aligned, w);
    for (int t0 = 0; t0 < c; t0 += MC) {
      float m[MC][E], gs2[MC], gl[MC], gd[MC];
#pragma unroll
      for (int u = 0; u < MC; ++u) {
        if (t0 + u < c) {
          load_chunk<T, G>(mp + (t0 + u) * l.m_member, p.len, l.aligned,
                           m[u]);
          gs2[u] = 2.f * __ldg(g + t0 + u);
          gl[u] = __ldg(g + c + t0 + u);
          gd[u] = __ldg(g + 2 * c + t0 + u);
        }
      }
      if (t0 == 0) {
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = two_gw * w[e];
      }
#pragma unroll
      for (int u = 0; u < MC; ++u) {
        if (t0 + u >= c) break;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float r = w[e] - m[u][e];
          float a = fmaf(gs2[u], r, acc[e]);
          a += r >= 0.f ? gl[u] : -gl[u];
          acc[e] = fmaf(gd[u], m[u][e], a);
        }
      }
    }
    store_chunk<T, G>(static_cast<T*>(l.out) + b * l.o_run + p.start, p.len,
                      l.aligned, acc);
  }
}

bool aligned_to(const void* p, int64_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

struct Args {
  const void* const* w;
  const void* const* m;
  void* const* out;
  const int64_t* n;
  const int64_t* w_run;
  const int64_t* m_run;
  const int64_t* m_member;
  const int64_t* o_run;
  int n_leaves, b, c;
  int64_t max_grid;     // blocks a launch, at most
  cudaStream_t stream;
  int* launches;
};

// Packs the non-empty leaves into tables of MAX_LEAVES, chunks of `chunk`
// elements; each table's launch has min(its chunks, max_grid) blocks, and
// its blocks' partial slots follow those of the tables before it.
std::vector<Table> pack(const Args& a, int esz, int64_t chunk) {
  std::vector<Table> tables;
  const int64_t vec = 4 * esz;  // bytes of a 4-element group
  for (int i = 0; i < a.n_leaves; ++i) {
    if (a.n[i] == 0) continue;
    if (tables.empty() || tables.back().n_leaves == MAX_LEAVES) {
      Table t;
      t.n_leaves = 0;
      t.chunks = 0;
      t.slot0 = tables.empty() ? 0
                               : tables.back().slot0 +
                                     std::min(tables.back().chunks,
                                              a.max_grid);
      tables.push_back(t);
    }
    Table& t = tables.back();
    Leaf& leaf = t.leaf[t.n_leaves++];
    leaf.w = a.w[i];
    leaf.m = a.m[i];
    leaf.out = a.out ? a.out[i] : nullptr;
    leaf.n = a.n[i];
    leaf.w_run = a.w_run[i];
    leaf.m_run = a.m_run[i];
    leaf.m_member = a.m_member[i];
    leaf.o_run = a.o_run ? a.o_run[i] : 0;
    leaf.first_chunk = t.chunks;
    bool ok = aligned_to(a.w[i], vec) && aligned_to(a.m[i], vec) &&
              (a.b == 1 || ((a.w_run[i] * esz) % vec == 0 &&
                            (a.m_run[i] * esz) % vec == 0)) &&
              (a.c == 1 || (a.m_member[i] * esz) % vec == 0);
    if (a.out)
      ok = ok && aligned_to(a.out[i], vec) &&
           (a.b == 1 || (a.o_run[i] * esz) % vec == 0);
    leaf.aligned = ok;
    t.chunks += (a.n[i] + chunk - 1) / chunk;
  }
  return tables;
}

// Launches `launch(table, blocks)` once per table; returns the first
// error.
template <typename Launch>
int launch_all(const Args& a, const std::vector<Table>& tables,
               Launch launch) {
  for (const Table& t : tables) {
    launch(t, std::min(t.chunks, a.max_grid));
    ++*a.launches;
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int MC, int G>
int forward(const Args& a, float* stats, float* wsq, float* part,
            int64_t part_floats, int* counters) {
  const std::vector<Table> tables = pack(a, sizeof(T), 4 * THREADS * G);
  if (tables.empty()) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t slots = tables.back().slot0 +
                        std::min(tables.back().chunks, a.max_grid);
  const int n_out = 4 * a.c + 1;
  if (a.b * slots * n_out > part_floats)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * WARPS * n_out;
  return launch_all(a, tables, [&](const Table& t, int64_t blocks) {
    pool_distance_kernel<T, MC, G>
        <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(a.b)),
           THREADS, smem, a.stream>>>(t, a.c, slots, stats, wsq, part,
                                      counters);
  });
}

template <typename T, int MC, int G>
int backward(const Args& a, const float* g_stats, const float* g_wsq) {
  const std::vector<Table> tables = pack(a, sizeof(T), 4 * THREADS * G);
  return launch_all(a, tables, [&](const Table& t, int64_t blocks) {
    pool_distance_bwd_kernel<T, MC, G>
        <<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(a.b)),
           THREADS, 0, a.stream>>>(t, a.c, g_stats, g_wsq);
  });
}

// A plan the kernels take: G of the instance for MC = min(C, 8), at least
// one block a launch.
bool valid_plan(int c, int g, int64_t grid) {
  if (c < 1 || c > MAX_MEMBERS || grid < 1 || grid > INT32_MAX) return false;
  const int mc = std::min(c, ROUND);
#define SWEEP_VALID(MC, G) \
  if (mc == MC && g == G) return true;
  SWEEP_INSTANCES(SWEEP_VALID)
#undef SWEEP_VALID
  return false;
}

}  // namespace

// Forward. w, m: host arrays of n_leaves device pointers (run 0's w and
// member 0 of each leaf; f32, or bf16 when bf16 != 0); n, w_run, m_run,
// m_member: host arrays of sizes and strides in elements; g, grid: the
// plan's groups a thread and blocks a launch, at most. stats: (B, 4, C)
// f32 (sq, l1, dot, norm); wsq: (B,) f32; part: the workspace of
// part_floats floats; counters: B ints that are 0. Empty leaves are
// skipped; at least one leaf is not empty.
extern "C" int pool_distance_f32(const void* const* w, const void* const* m,
                                 const int64_t* n, const int64_t* w_run,
                                 const int64_t* m_run,
                                 const int64_t* m_member, int n_leaves,
                                 int b, int c, int bf16, int g, int64_t grid,
                                 float* stats, float* wsq, float* part,
                                 int64_t part_floats, int* counters,
                                 void* stream, int* launches) {
  *launches = 0;
  if (!valid_plan(c, g, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{w, m, nullptr, n, w_run, m_run, m_member, nullptr, n_leaves,
               b, c, grid, static_cast<cudaStream_t>(stream), launches};
  const int mc = std::min(c, ROUND);
#define SWEEP_FORWARD(MC, G)                                                \
  if (mc == MC && g == G)                                                   \
    return bf16 ? forward<__nv_bfloat16, MC, G>(a, stats, wsq, part,        \
                                                part_floats, counters)      \
                : forward<float, MC, G>(a, stats, wsq, part, part_floats,   \
                                        counters);
  SWEEP_INSTANCES(SWEEP_FORWARD)
#undef SWEEP_FORWARD
  return static_cast<int>(cudaErrorInvalidValue);
}

// Backward. w, m as the forward's (f32, or bf16 when bf16 != 0); out: host
// array of device pointers to each leaf's ∂w of run 0, of the leaves' type,
// o_run its run stride; g_stats (B, 4, C) and g_wsq (B,) f32 in device
// memory (row 3 of g_stats, ḡnorm, is not read); g, grid as above.
extern "C" int pool_distance_bwd_f32(const void* const* w,
                                     const void* const* m, void* const* out,
                                     const int64_t* n, const int64_t* w_run,
                                     const int64_t* m_run,
                                     const int64_t* m_member,
                                     const int64_t* o_run, int n_leaves,
                                     int b, int c, int bf16, int g,
                                     int64_t grid,
                                     const float* g_stats,
                                     const float* g_wsq, void* stream,
                                     int* launches) {
  *launches = 0;
  if (!valid_plan(c, g, grid)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{w, m, out, n, w_run, m_run, m_member, o_run, n_leaves, b, c,
               grid, static_cast<cudaStream_t>(stream), launches};
  const int mc = std::min(c, ROUND);
#define SWEEP_BACKWARD(MC, G)                                             \
  if (mc == MC && g == G)                                                 \
    return bf16 ? backward<__nv_bfloat16, MC, G>(a, g_stats, g_wsq)       \
                : backward<float, MC, G>(a, g_stats, g_wsq);
  SWEEP_INSTANCES(SWEEP_BACKWARD)
#undef SWEEP_BACKWARD
  return static_cast<int>(cudaErrorInvalidValue);
}
