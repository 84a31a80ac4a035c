// Fused SGD update for Hopper (sm_90a): out_i = p_i − lr·(g_i + wd·p_i) over
// every parameter leaf of a model in one launch, in f32.
//
// Replaces: src/repro/kernels/local_step.py:sgd_update_flat (Pallas sweep,
// body _sgd_kernel; front sgd_update_tree). The TPU kernel needs one flat
// array for its grid, so the reference concatenates the leaves, sweeps
// blocks of 65,536 and splits the result back. Here nothing is copied: the
// launch carries a table of (p, g, out, n) per leaf by value in its
// parameters, and each block finds its leaf and its chunk in that table, as
// PyTorch's multi-tensor apply does.
//
// Bound on an H100 SXM: bytes. Each element is read twice (p, g) and
// written once, 12 bytes for 2 FMA: the paper CNN's 1,422,218 parameters
// move 17.07 MB, 5.1 µs at 3.35 TB/s, against 0.09 µs of f32 FMA at
// 67 TFLOP/s. The design therefore only has to stream: 256 threads a block,
// CHUNK = 2,048 elements a block, float4 loads and stores where the leaf's
// three pointers are 16-byte aligned, a scalar loop otherwise and for the
// ragged tail of each leaf.
//
// Arithmetic: __fmaf_rn(-lr, __fmaf_rn(wd, p, g), p) — g + wd·p and then
// p + (−lr)·(…), each rounded once. That is how the plain version
// (`ref.sgd_update_ref`, torch.add with alpha) and XLA's CPU update round,
// so the three agree bitwise.
//
// Plain C interface for ctypes: the caller passes host arrays of leaf
// pointers and sizes; the entry packs them into tables of MAX_LEAVES and
// launches once per table on the caller's stream (the paper CNN's 10 leaves
// take one launch). It returns cudaGetLastError() (0 = launched) and writes
// the number of launches to *launches.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC_PER_THREAD = 2;
constexpr int64_t CHUNK = THREADS * VEC_PER_THREAD * 4;  // 2,048 elements
constexpr int MAX_LEAVES = 48;  // keeps the table well inside 4 KB of params

struct Leaf {
  const float* p;
  const float* g;
  float* out;
  int64_t n;
  int64_t first_block;  // first block of the grid that works on this leaf
  int aligned;          // p, g and out all 16-byte aligned
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int n_leaves;
};

__device__ __forceinline__ float sgd(float p, float g, float lr, float wd) {
  return __fmaf_rn(-lr, __fmaf_rn(wd, p, g), p);
}

__global__ void __launch_bounds__(THREADS)
sgd_f32_kernel(const __grid_constant__ Table table, float lr, float wd) {
  const int64_t b = blockIdx.x;
  int li = 0;  // the leaf whose blocks hold b (the table is in block order)
  while (li + 1 < table.n_leaves && table.leaf[li + 1].first_block <= b) ++li;
  const Leaf& leaf = table.leaf[li];
  const int64_t start = (b - leaf.first_block) * CHUNK;
  const int64_t len = leaf.n - start < CHUNK ? leaf.n - start : CHUNK;
  const float* p = leaf.p + start;
  const float* g = leaf.g + start;
  float* out = leaf.out + start;

  int64_t done = 0;
  if (leaf.aligned) {  // start is a multiple of 4, so the chunk is aligned too
    const int64_t n4 = len / 4;
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (int64_t i = threadIdx.x; i < n4; i += THREADS) {
      const float4 pv = p4[i];
      const float4 gv = g4[i];
      o4[i] = make_float4(sgd(pv.x, gv.x, lr, wd), sgd(pv.y, gv.y, lr, wd),
                          sgd(pv.z, gv.z, lr, wd), sgd(pv.w, gv.w, lr, wd));
    }
    done = n4 * 4;
  }
  for (int64_t i = done + threadIdx.x; i < len; i += THREADS)
    out[i] = sgd(p[i], g[i], lr, wd);
}

}  // namespace

extern "C" int sgd_f32_max_leaves() { return MAX_LEAVES; }

// p, g, out: host arrays of n_leaves device pointers (f32, contiguous);
// n: host array of the leaves' element counts. Empty leaves are skipped.
extern "C" int sgd_f32(const void* const* p, const void* const* g,
                       void* const* out, const int64_t* n, int n_leaves,
                       float lr, float wd, void* stream, int* launches) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launches = 0;
  Table table;
  table.n_leaves = 0;
  int64_t blocks = 0;
  for (int i = 0; i <= n_leaves; ++i) {
    const bool flush = i == n_leaves || table.n_leaves == MAX_LEAVES;
    if (flush && table.n_leaves > 0) {
      sgd_f32_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
          table, lr, wd);
      ++*launches;
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      table.n_leaves = 0;
      blocks = 0;
    }
    if (i == n_leaves || n[i] == 0) continue;
    Leaf& leaf = table.leaf[table.n_leaves++];
    leaf.p = static_cast<const float*>(p[i]);
    leaf.g = static_cast<const float*>(g[i]);
    leaf.out = static_cast<float*>(out[i]);
    leaf.n = n[i];
    leaf.first_block = blocks;
    leaf.aligned = ((reinterpret_cast<uintptr_t>(p[i]) |
                     reinterpret_cast<uintptr_t>(g[i]) |
                     reinterpret_cast<uintptr_t>(out[i])) & 15) == 0;
    blocks += (n[i] + CHUNK - 1) / CHUNK;
  }
  return static_cast<int>(cudaGetLastError());
}
