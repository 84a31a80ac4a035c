// Factor Gram for Hopper (sm_90a): G = A·Aᵀ over the long trailing axis
// for every stack of a call in one launch, A (B, M, P) f32 → G (B, M, M)
// f32, M = pool capacity × rank ≤ 256.
//
// Replaces: src/repro/kernels/pool_distance.py:factor_gram (body
// _gram_kernel). The Pallas kernel walks P in blocks of 2,048 on a
// sequential grid axis and adds each block's (M, M) product into one
// resident tile, one call per stack. `lowrank_pairwise_sq` makes two such
// calls a leaf: 20 at the full-width llama3.2-1b pool, with P from 16 to
// 128,256.
//
// Bound on an H100 SXM: bytes. A pairwise call of the full-width pool reads
// 134.2 MB (0.040 ms at 3.35 TB/s); its distinct outputs — the upper
// triangle with the diagonal, 820 of the 1,600 at M = 40 — take 1.38 GFLOP
// of f32 FMA (0.021 ms at 67 TFLOP/s). What the design does about it:
//
// * One launch a call. The caller passes a table of stacks by value; a
//   plan computed from the shapes alone (kernels/pool_distance.gram_plan)
//   gives each stack its chunk width, its place in the grid, its
//   workspace and its counters, so the small stacks ride along with the
//   large ones and the grid fills the SMs.
// * The exact M and the upper triangle. Rows go in 8 strided groups (group
//   g holds rows g, g + n, …, g + 7n, n = ⌈M/8⌉; rows from M are zero in
//   shared memory). A thread owns an item: a pair of groups (gi ≤ gj)
//   against half of gj's rows, 32 elements of G, 128 FMAs for 12 16-byte
//   loads from shared memory a quad of columns. The pairs cover every
//   element of the triangle once (a pair gi < gj holds (i, j) and (j, i)
//   of no other pair); a thread writes its elements on or above the
//   diagonal and their mirrors, so G is symmetric bit for bit.
// * Loads that the warp shares. The warps of a team take the same quads,
//   so a warp's load of one row group for all its items reads a handful
//   of addresses: shared memory feeds the FMAs instead of limiting them.
// * Columns through cp.async. A block stages its chunk's columns, w at a
//   time, in a 4-slot ring in shared memory, row-major, a row's pitch an
//   odd number of 16-byte units (loads of one quad from consecutive rows
//   fall in distinct banks), with 16-byte copies (4-byte ones where a row
//   does not start 16-byte aligned) while it sums an earlier slot.
// * The teams split the columns (quad j of a chunk to team j mod T, T =
//   8 / the warps a team); each sums its quads in order, and the teams are
//   added in order through shared memory.
// * A deterministic split over P. A stack whose chunks number k > 1 writes
//   each chunk's partial to the workspace; integer counters (from
//   kernels/build.counters, reset by the block that finds itself last,
//   never a float atomic) find the last block of each subgroup of f
//   chunks (one subgroup of all k where k ≤ 16), which adds them in
//   order, and the last of those adds the subgroups in order. Two
//   launches on one input give the same bits.
//
// Arithmetic: f32 FMA chains, as the plain version's matmul. Plain TF32
// (three digits) cannot meet the 1e-5 the pairwise distances are held to;
// a 3×TF32 mma.sync form (big·big + big·small + small·big) met it but read
// slower than these FMAs on an H100.
//
// Plain C interface for ctypes; the caller passes the table (stacks in
// block order), the grid and the dynamic shared memory. Returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int GRAM_MAX_STACKS = 32;  // stacks a launch's table holds

// the table's entries have external linkage: the C entry takes them
struct GramStack {
  const float* a;   // (B, M, P), contiguous
  float* out;       // (B, M, M)
  float* part;      // the chunks' partials (k > 1)
  float* part2;     // the subgroups' partials (nsub > 1)
  int* counters;    // groups × (nsub > 1 ? nsub + 1 : 1), all 0
  int64_t p;        // columns
  int64_t pc;       // columns a chunk
  int b, m;
  int w;            // columns a stage (a multiple of 4)
  int pitch;        // floats a row of a ring slot (a multiple of 4)
  int ib, nq;       // items a block (its stride in the partials), item groups
  int wpt, teams;   // warps a team, teams
  int k, f, nsub;   // chunks a (b, item group), chunks a subgroup, subgroups
  int first_block;
};

struct GramTable {
  GramStack s[GRAM_MAX_STACKS];
  int n;
};

namespace {

constexpr int THREADS = 256;
constexpr int R = 8;             // rows a group
constexpr int H = R / 2;         // rows of gj an item takes
constexpr int STAGES = 4;        // ring slots
constexpr int ITEM = R * H;      // an item's sums
constexpr int RED_PITCH = 36;    // floats between two (team, item) sums
constexpr int MAX_F = 16;        // chunks a subgroup, subgroups a group

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes, of which the first `bytes` are copied and the rest zeroed
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Every value v < nv of the block (v = tid, tid + 256, …) as the sum of
// its n terms load(t, v) added in term order, handed to emit(v, sum): VB
// values a thread at a time, LB terms loaded ahead of their adds, so the
// loads overlap while the order of the adds stays fixed.
template <int VB, int LB, class Load, class Emit>
__device__ __forceinline__ void ordered_sums(int nv, int n, Load load,
                                             Emit emit) {
  for (int v0 = threadIdx.x; v0 < nv; v0 += VB * THREADS) {
    float sum[VB];
    for (int t0 = 0; t0 < n; t0 += LB) {
      float x[VB][LB];
#pragma unroll
      for (int i = 0; i < VB; ++i)
#pragma unroll
        for (int u = 0; u < LB; ++u)
          x[i][u] = v0 + i * THREADS < nv && t0 + u < n
              ? load(t0 + u, v0 + i * THREADS) : 0.f;
#pragma unroll
      for (int i = 0; i < VB; ++i)
#pragma unroll
        for (int u = 0; u < LB; ++u)
          if (t0 + u < n) sum[i] = t0 + u == 0 ? x[i][u] : sum[i] + x[i][u];
    }
#pragma unroll
    for (int i = 0; i < VB; ++i)
      if (v0 + i * THREADS < nv) emit(v0 + i * THREADS, sum[i]);
  }
}

// After this block's partials are stored: one arrival on `counter`, of
// `arrivals` expected; true in the last block to arrive, which resets the
// counter for the next launch. Thread 0's atomic releases the partials the
// barrier ordered before it and, in the last block, acquires every other
// block's for the threads after the next barrier.
__device__ __forceinline__ bool last_arrival(int* counter, int arrivals,
                                             int* is_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    int before;
    asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;\n"
                 : "=r"(before) : "l"(counter) : "memory");
    *is_last = before == arrivals - 1;
    if (*is_last) *counter = 0;
  }
  __syncthreads();
  return *is_last;
}

__global__ void __launch_bounds__(THREADS, 2)
factor_gram_kernel(const __grid_constant__ GramTable table) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ int3 items[THREADS];
  __shared__ int is_last;

  int si = 0;  // the block's stack: the table is in block order
  while (si + 1 < table.n &&
         table.s[si + 1].first_block <= static_cast<int>(blockIdx.x))
    ++si;
  const GramStack& st = table.s[si];
  const int local = blockIdx.x - st.first_block;
  const int chunk = local % st.k, group = local / st.k;
  const int b = group / st.nq, q = group % st.nq;
  const int m = st.m, mr = (m + R - 1) / R * R, ng = mr / R;
  const int item0 = q * st.ib;
  const int nib = min(st.ib, ng * (ng + 1) - item0);  // this block's items
  const int tid = threadIdx.x;

  if (tid < nib) {  // item 2p + h → pair p's (gi, gj), the triangle row by
    int idx = (item0 + tid) / 2, gi = 0;  // row, and its half h of gj's rows
    while (idx >= ng - gi) idx -= ng - gi++;
    items[tid] = make_int3(gi, gi + idx, (item0 + tid) % 2);
  }

  const int64_t c0 = static_cast<int64_t>(chunk) * st.pc;
  const int cols = static_cast<int>(min(st.pc, st.p - c0));
  const int w = st.w, wq = w / 4, pitch = st.pitch;
  const int n_quads = (cols + 3) / 4, n_stages = (cols + w - 1) / w;
  const float* src = st.a + static_cast<int64_t>(b) * m * st.p + c0;
  // 16-byte copies where every row of the chunk starts 16-byte aligned
  const bool vec = st.p % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(st.a) % 16 == 0;

  // stage s → ring slot, row-major (pitch floats a row): rows 0..mr-1
  // (zero from m) of the chunk's columns [s·w, s·w + w) (zero from
  // `cols`). Thread tid copies the units tid, tid + 256, … of the slot in
  // row order: 16-byte quads of columns, or single columns where the rows
  // are not aligned; consecutive threads take consecutive units of a row.
  const int units = vec ? wq : w;
  const int row0 = tid / units, unit0 = tid % units;
  const int d_row = THREADS / units, d_unit = THREADS % units;
  auto load = [&](int s, int slot) {
    float* dst = smem + slot * mr * pitch;
    const int j0 = s * w;
    int row = row0, u = unit0;
    if (vec) {
      while (row < mr) {
        const int col = 4 * u;
        const int bytes = row < m ? 4 * max(0, min(4, cols - j0 - col)) : 0;
        cp_async16(dst + row * pitch + col,
                   bytes ? src + static_cast<int64_t>(row) * st.p + j0 + col
                         : st.a,
                   bytes);
        row += d_row;
        u += d_unit;
        if (u >= units) { u -= units; ++row; }
      }
    } else {
      while (row < mr) {
        const bool ok = row < m && j0 + u < cols;
        cp_async4(dst + row * pitch + u,
                  ok ? src + static_cast<int64_t>(row) * st.p + j0 + u : st.a,
                  ok);
        row += d_row;
        u += d_unit;
        if (u >= units) { u -= units; ++row; }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_stages) load(s, s);
    cp_async_commit();
  }
  __syncthreads();  // the item table

  // warp → team (the warps of a team take the same quads), lane → item
  const int team = tid / 32 / st.wpt;
  const int it = tid / 32 % st.wpt * 32 + tid % 32;
  const bool active = team < st.teams && it < nib;
  int gi = 0, gj = 0;
  if (active) {
    gi = items[it].x;
    gj = items[it].y + H * ng * items[it].z;
  }
  float acc[R][H];
#pragma unroll
  for (int x = 0; x < R; ++x)
#pragma unroll
    for (int y = 0; y < H; ++y) acc[x][y] = 0.f;

  int qd = team;  // the team's next quad of four columns of the chunk
  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<STAGES - 2>();  // stage s has landed (this thread's part)
    __syncthreads();              // ... every thread's; stage s-1 is summed
    if (s + STAGES - 1 < n_stages)
      load(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();
    if (!active) continue;
    const float* slot = smem + (s % STAGES) * mr * pitch;
    const int end = min((s + 1) * wq, n_quads);
    for (; qd < end; qd += st.teams) {
      const float* quad = slot + 4 * (qd - s * wq);
      float4 xa[R];
#pragma unroll
      for (int x = 0; x < R; ++x)
        xa[x] = *reinterpret_cast<const float4*>(quad + (gi + ng * x) * pitch);
#pragma unroll
      for (int y = 0; y < H; ++y) {
        const float4 yb =
            *reinterpret_cast<const float4*>(quad + (gj + ng * y) * pitch);
#pragma unroll
        for (int x = 0; x < R; ++x) {
          acc[x][y] = fmaf(xa[x].x, yb.x, acc[x][y]);
          acc[x][y] = fmaf(xa[x].y, yb.y, acc[x][y]);
          acc[x][y] = fmaf(xa[x].z, yb.z, acc[x][y]);
          acc[x][y] = fmaf(xa[x].w, yb.w, acc[x][y]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the teams' sums now

  if (active) {
    float* mine = smem + (team * st.ib + it) * RED_PITCH;
#pragma unroll
    for (int x = 0; x < R; ++x)
      *reinterpret_cast<float4*>(mine + x * H) =
          make_float4(acc[x][0], acc[x][1], acc[x][2], acc[x][3]);
  }
  __syncthreads();

  // value v of the block: item v / 32, element (x, y) = (v % 32 / 4, v % 4)
  // of its 8 × 4 sums
  const int nv = nib * ITEM, pv = st.ib * ITEM;
  auto write_out = [&](int v, float sum) {
    const int3 g = items[v / ITEM];
    const int x = v % ITEM / H, y = H * g.z + v % H;
    const int i = g.x + ng * x, jj = g.y + ng * y;
    if (i >= m || jj >= m || (g.x == g.y && x > y)) return;
    float* ob = st.out + static_cast<int64_t>(b) * m * m;
    ob[i * m + jj] = sum;
    ob[jj * m + i] = sum;
  };
  float* mine = st.k > 1
      ? st.part + (static_cast<int64_t>(group) * st.k + chunk) * pv : nullptr;
  ordered_sums<4, 8>(
      nv, st.teams,
      [&](int t, int v) {
        return smem[(t * st.ib + v / ITEM) * RED_PITCH + v % ITEM];
      },
      [&](int v, float sum) {
        if (st.k == 1)
          write_out(v, sum);
        else
          mine[v] = sum;
      });
  if (st.k == 1) return;

  // the last block of the chunk's subgroup adds its chunks in order
  const int per_group = st.nsub > 1 ? st.nsub + 1 : 1;
  const int sub = chunk / st.f;
  const int lo = sub * st.f, hi = min(st.k, lo + st.f);
  if (!last_arrival(st.counters + group * per_group + sub, hi - lo, &is_last))
    return;
  const float* all = st.part + static_cast<int64_t>(group) * st.k * pv;
  float* sub_sum = st.nsub > 1
      ? st.part2 + (static_cast<int64_t>(group) * st.nsub + sub) * pv
      : nullptr;
  ordered_sums<2, MAX_F>(
      nv, hi - lo,
      [&](int c, int v) {
        return __ldcg(all + static_cast<int64_t>(lo + c) * pv + v);
      },
      [&](int v, float sum) {
        if (st.nsub == 1)
          write_out(v, sum);
        else
          sub_sum[v] = sum;
      });
  if (st.nsub == 1) return;

  // the last subgroup's block adds the subgroups in order
  if (!last_arrival(st.counters + group * per_group + st.nsub, st.nsub,
                    &is_last))
    return;
  const float* subs = st.part2 + static_cast<int64_t>(group) * st.nsub * pv;
  ordered_sums<2, MAX_F>(
      nv, st.nsub,
      [&](int c, int v) {
        return __ldcg(subs + static_cast<int64_t>(c) * pv + v);
      },
      write_out);
}

}  // namespace

extern "C" int factor_gram_f32_stack_bytes() {
  return static_cast<int>(sizeof(GramStack));
}

extern "C" int factor_gram_f32_max_stacks() { return GRAM_MAX_STACKS; }

// stacks: host array of n GramStack entries in block order (the plan's);
// grid blocks, smem bytes of dynamic shared memory.
extern "C" int factor_gram_f32(const GramStack* stacks, int n, int grid,
                               int smem, void* stream) {
  if (n < 1 || n > GRAM_MAX_STACKS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      factor_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  GramTable table;
  for (int i = 0; i < n; ++i) table.s[i] = stacks[i];
  table.n = n;
  factor_gram_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}
