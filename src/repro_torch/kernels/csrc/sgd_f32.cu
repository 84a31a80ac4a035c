// Fused SGD update for Hopper (sm_90a): out_i = p_i − lr·(g_i + wd·p_i) over
// every parameter leaf of a model in one launch, in f32 arithmetic; each
// leaf's p (and out) and g may be f32 or bf16, mixed in one launch.
//
// Replaces: src/repro/kernels/local_step.py:sgd_update_flat (Pallas sweep,
// body _sgd_kernel; front sgd_update_tree). The TPU kernel needs one flat
// array for its grid, so the reference concatenates the leaves, sweeps
// blocks of 65,536 and splits the result back. Here nothing is copied: the
// launch carries a table of (p, g, out, n) per leaf by value in its
// parameters.
//
// Bound on an H100 SXM: bytes. Each element is read twice (p, g) and
// written once, 12 bytes for 2 FMA: the paper CNN's 1,422,218 parameters
// move 17.07 MB, 5.1 µs at 3.35 TB/s, against 0.09 µs of f32 FMA at
// 67 TFLOP/s. So the whole of the time is memory latency and bandwidth,
// and the design keeps every byte in flight at once:
//
// * One balanced wave. The leaves' slots (four elements each; a leaf's
//   last slot may be short) are numbered through the table, and a plan
//   (kernels/local_step.sgd_plan) splits them evenly over a resident grid
//   of 2 × 132 blocks; a block's range may cross leaf boundaries, so no
//   block waits on a leaf's ragged end.
// * Every load before the first FMA. A thread takes the slots tid,
//   tid + 256, … of its block's range (up to UNROLL of them at a time),
//   issues all their loads — 16-byte streaming loads (ld.global.cs) where
//   the leaf is aligned, scalar ones for a misaligned leaf or a short
//   slot — then computes, then stores with streaming stores. __restrict__
//   pointers let the loads run ahead of the stores.
// * Gradients read in place. Autograd hands the native CNN's conv weight
//   gradients as permuted views (the forward's w.permute(3, 2, 0, 1)); a
//   leaf's gradient may be such a view of up to 4 dims, read through its
//   sizes and strides, so no copy runs before the update.
//
// Arithmetic: __fmaf_rn(-lr, __fmaf_rn(wd, p, g), p) — g + wd·p and then
// p + (−lr)·(…), each rounded once. That is how the plain version
// (`ref.sgd_update_ref`, torch.add with alpha) and XLA's CPU update round,
// so the three agree bitwise. A bf16 leaf is widened to f32 exactly (its
// bits shifted up), updated in f32 and stored rounded to nearest even, as
// the plain version's `.to(bfloat16)` and the reference's `astype` do; its
// vector loads and stores move a slot's 8 bytes.
//
// Plain C interface for ctypes: the caller passes one table (its leaves,
// its gradient views, its slots and the slots a block) and the grid; the
// entry launches once on the caller's stream and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int SGD_MAX_LEAVES = 64;  // leaves a table holds
constexpr int SGD_MAX_VIEWS = 8;    // gradient views a table holds

// the table's entries have external linkage: the C entry takes them
struct SgdLeaf {
  const void* p;
  const void* g;
  void* out;
  int64_t n;      // elements
  int64_t slot0;  // the leaf's first slot in the table
  int vec;        // bit 0: p and out aligned to a slot (16 bytes in f32,
                  // 8 in bf16); bit 1: g too
  int view;       // -1: g contiguous; else its index in SgdTable::view
  int bf16;       // bit 0: p and out are bf16; bit 1: g is (else f32)
};

struct SgdView {  // g as a view of p's shape, padded to 4 dims
  int size[4];
  int64_t stride[4];
};

struct SgdTable {
  SgdLeaf leaf[SGD_MAX_LEAVES];
  SgdView view[SGD_MAX_VIEWS];
  int64_t slots;      // slots of the table
  int64_t per_block;  // slots a block
  int n_leaves;
};

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;        // slots a thread has in flight

__device__ __forceinline__ float sgd(float p, float g, float lr, float wd) {
  return __fmaf_rn(-lr, __fmaf_rn(wd, p, g), p);
}

// offset of element e (row-major in p's shape) in a gradient view
__device__ __forceinline__ int64_t view_offset(const SgdView& v, uint32_t e) {
  int64_t off = 0;
#pragma unroll
  for (int d = 3; d > 0; --d) {
    const uint32_t s = static_cast<uint32_t>(v.size[d]);
    off += static_cast<int64_t>(e % s) * v.stride[d];
    e /= s;
  }
  return off + static_cast<int64_t>(e) * v.stride[0];
}

__device__ __forceinline__ float widen(unsigned short h) {
  return __uint_as_float(static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ unsigned short narrow(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// the cnt (1..4) elements at element offset e of x, f32 or bf16
__device__ __forceinline__ float4 load4(const void* __restrict__ x,
                                        int64_t e, int cnt, bool vec,
                                        bool bf16) {
  float4 r = make_float4(0.f, 0.f, 0.f, 0.f);
  if (bf16) {
    const unsigned short* h = static_cast<const unsigned short*>(x) + e;
    if (vec && cnt == 4) {
      const uint2 u = __ldcs(reinterpret_cast<const uint2*>(h));
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    }
    r.x = widen(__ldcs(h));
    if (cnt > 1) r.y = widen(__ldcs(h + 1));
    if (cnt > 2) r.z = widen(__ldcs(h + 2));
    if (cnt > 3) r.w = widen(__ldcs(h + 3));
    return r;
  }
  const float* f = static_cast<const float*>(x) + e;
  if (vec && cnt == 4) return __ldcs(reinterpret_cast<const float4*>(f));
  r.x = __ldcs(f);
  if (cnt > 1) r.y = __ldcs(f + 1);
  if (cnt > 2) r.z = __ldcs(f + 2);
  if (cnt > 3) r.w = __ldcs(f + 3);
  return r;
}

// element off of a gradient view, f32 or bf16
__device__ __forceinline__ float load1(const void* __restrict__ x,
                                       int64_t off, bool bf16) {
  return bf16 ? widen(__ldcs(static_cast<const unsigned short*>(x) + off))
              : __ldcs(static_cast<const float*>(x) + off);
}

// the cnt (1..4) results at element offset e of out, f32 or bf16
__device__ __forceinline__ void store4(void* __restrict__ out, int64_t e,
                                       int cnt, bool vec, bool bf16,
                                       float4 r) {
  if (bf16) {
    unsigned short* h = static_cast<unsigned short*>(out) + e;
    const unsigned short hx = narrow(r.x), hy = narrow(r.y),
                         hz = narrow(r.z), hw = narrow(r.w);
    if (vec && cnt == 4) {
      __stcs(reinterpret_cast<uint2*>(h),
             make_uint2(hx | static_cast<uint32_t>(hy) << 16,
                        hz | static_cast<uint32_t>(hw) << 16));
      return;
    }
    __stcs(h, hx);
    if (cnt > 1) __stcs(h + 1, hy);
    if (cnt > 2) __stcs(h + 2, hz);
    if (cnt > 3) __stcs(h + 3, hw);
    return;
  }
  float* f = static_cast<float*>(out) + e;
  if (vec && cnt == 4) {
    __stcs(reinterpret_cast<float4*>(f), r);
    return;
  }
  __stcs(f, r.x);
  if (cnt > 1) __stcs(f + 1, r.y);
  if (cnt > 2) __stcs(f + 2, r.z);
  if (cnt > 3) __stcs(f + 3, r.w);
}

__global__ void __launch_bounds__(THREADS)
sgd_f32_kernel(const __grid_constant__ SgdTable t, float lr, float wd) {
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * t.per_block;
  const int64_t hi = min(lo + t.per_block, t.slots);
  int64_t base = lo + threadIdx.x;
  if (base >= hi) return;
  int li = 0;  // the leaf of the thread's next slot (slots only go up)
  for (int step = SGD_MAX_LEAVES / 2; step > 0; step /= 2)
    if (li + step < t.n_leaves && t.leaf[li + step].slot0 <= base)
      li += step;

  for (; base < hi; base += static_cast<int64_t>(THREADS) * UNROLL) {
    float4 pv[UNROLL], gv[UNROLL];
    int lk[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t slot = base + static_cast<int64_t>(u) * THREADS;
      lk[u] = -1;
      if (slot >= hi) continue;
      while (li + 1 < t.n_leaves && t.leaf[li + 1].slot0 <= slot) ++li;
      lk[u] = li;
      const SgdLeaf& L = t.leaf[li];
      const int64_t e = (slot - L.slot0) * 4;
      const int cnt = static_cast<int>(min(static_cast<int64_t>(4), L.n - e));
      pv[u] = load4(L.p, e, cnt, L.vec & 1, L.bf16 & 1);
      if (L.view < 0) {
        gv[u] = load4(L.g, e, cnt, L.vec & 2, L.bf16 & 2);
      } else {
        const SgdView& v = t.view[L.view];
        const uint32_t e32 = static_cast<uint32_t>(e);
        const bool gb = L.bf16 & 2;
        gv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        gv[u].x = load1(L.g, view_offset(v, e32), gb);
        if (cnt > 1) gv[u].y = load1(L.g, view_offset(v, e32 + 1), gb);
        if (cnt > 2) gv[u].z = load1(L.g, view_offset(v, e32 + 2), gb);
        if (cnt > 3) gv[u].w = load1(L.g, view_offset(v, e32 + 3), gb);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (lk[u] < 0) continue;
      const SgdLeaf& L = t.leaf[lk[u]];
      const int64_t slot = base + static_cast<int64_t>(u) * THREADS;
      const int64_t e = (slot - L.slot0) * 4;
      const int cnt = static_cast<int>(min(static_cast<int64_t>(4), L.n - e));
      const float4 r = make_float4(sgd(pv[u].x, gv[u].x, lr, wd),
                                   sgd(pv[u].y, gv[u].y, lr, wd),
                                   sgd(pv[u].z, gv[u].z, lr, wd),
                                   sgd(pv[u].w, gv[u].w, lr, wd));
      store4(L.out, e, cnt, L.vec & 1, L.bf16 & 1, r);
    }
  }
}

}  // namespace

extern "C" int sgd_f32_max_leaves() { return SGD_MAX_LEAVES; }
extern "C" int sgd_f32_max_views() { return SGD_MAX_VIEWS; }
extern "C" int sgd_f32_leaf_bytes() {
  return static_cast<int>(sizeof(SgdLeaf));
}
extern "C" int sgd_f32_view_bytes() {
  return static_cast<int>(sizeof(SgdView));
}

// leaves: n_leaves (≥ 1, non-empty) in slot order; views: n_views gradient
// views; slots and per_block from the plan; grid = ⌈slots / per_block⌉.
extern "C" int sgd_f32(const SgdLeaf* leaves, int n_leaves,
                       const SgdView* views, int n_views, int64_t slots,
                       int64_t per_block, int grid, float lr, float wd,
                       void* stream) {
  if (n_leaves < 1 || n_leaves > SGD_MAX_LEAVES || n_views < 0 ||
      n_views > SGD_MAX_VIEWS || per_block < 1 ||
      (slots + per_block - 1) / per_block != grid)
    return static_cast<int>(cudaErrorInvalidValue);
  SgdTable table;
  for (int i = 0; i < n_leaves; ++i) table.leaf[i] = leaves[i];
  for (int i = 0; i < n_views; ++i) table.view[i] = views[i];
  table.slots = slots;
  table.per_block = per_block;
  table.n_leaves = n_leaves;
  sgd_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, lr, wd);
  return static_cast<int>(cudaGetLastError());
}
