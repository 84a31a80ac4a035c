// Batched low-rank correction (BGMV) for Hopper (sm_90a): for every pool
// member s, y_s = (x_s · u_s) · v_sᵀ in f32.
//
//   x (S, N, d_in) per member, or (N, d_in) shared by all members; f32 or
//   bf16 (converted to f32 as it is loaded)
//   u (S, d_in, r), v (S, d_out, r) f32, r ≤ 64  →  y (S, N, d_out) f32
//
// Replaces: src/repro/kernels/bgmv.py:bgmv_pallas (body _bgmv_kernel). The
// Pallas grid is (S, N-blocks) with each member's whole factor panels
// resident in VMEM; here one call runs a shrink and an expand kernel on
// the caller's stream, the expand under a programmatic dependent launch.
//
// Bound on an H100 SXM: bytes, and at the serving shapes (N = 32 rows,
// 5 members, rank 8) not even those: a layer site moves 1–3 MB (under a
// microsecond at 3.35 TB/s). What a call costs is fixed latency: two
// kernels, each a single wave, whose loads, reductions and launch gap
// follow one another. The design cuts that chain:
//
// * shrink, grid (splits, N / 32, S), plan from the wrapper
//   (`kernels/bgmv.bgmv_plan`: the split width is chosen so that every
//   site puts ≥ 132 blocks on the card). A block takes 32 rows × one split
//   of d_in; each warp owns 4 rows, 8 lanes a row, and a lane reads 8
//   columns at a time as one 16-byte load (bf16) or two (f32). Every load
//   is issued before the first product: the split's u rows go to shared
//   memory as float4s (padded so that a row's 8 lanes read 8 different
//   bank groups), x into registers. A lane keeps its row's r sums in
//   registers; the 8 lanes of a row add them with xor shuffles (every lane
//   ends with the same bits).
//   The split's partial (32 × r) goes to a workspace; an integer atomic on
//   the (member, row block) counter finds the last block, which adds the
//   splits in index order, writes t = x·u (32 × r) once and resets the
//   counter for the next call (no memset launch). A call repeated is
//   bitwise equal.
// * expand, grid (d_out / cols, N / 32, S), launched with
//   cudaLaunchAttributeProgrammaticStreamSerialization: the shrink blocks
//   trigger `griddepcontrol.launch_dependents` once their partials are
//   stored, so the expand is scheduled while the shrink finishes; each
//   expand thread loads its 4 columns of v into registers, and only then
//   waits (`griddepcontrol.wait`, which returns once the shrink grid has
//   completed and its stores are visible) and reads t. It writes 4
//   adjacent outputs of each of its rows as one float4.
//
// Arithmetic: f32 FMAs in a fixed order, no float atomics. Each t sum is
// a lane's sequential FMAs over its columns, a 3-level shuffle tree and
// the splits in index order; each y sum runs over j in order. It differs
// from the plain version (`ref.bgmv_ref`, two cuBLAS products) by the
// order of the d_in summation only.
//
// Plain C interface for ctypes; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NB = 32;            // activation rows per block
constexpr int ROW_LANES = 8;      // shrink: lanes that share a row
constexpr int LANE_COLS = 8;      // d_in columns a lane loads at a time
constexpr int PASS = ROW_LANES * LANE_COLS;  // columns a row takes a pass
constexpr int MAX_R = 64;         // largest rank the kernel takes
constexpr int JC = 8;             // expand: ranks held in registers at once
constexpr int MAX_U = 8192;       // floats of u a shrink block stages

__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// The raw 16 bytes of 8 columns [d, d + 8) of a row: one 16-byte load
// (bf16) or two (f32) when `vec`, else one guarded load a column (columns
// ≥ c1 read 0); `unpack8` converts them to f32.
struct Raw8 {
  uint4 a, b;   // b: the second half of an f32 row's 8 columns
};
__device__ __forceinline__ Raw8 load8(const __nv_bfloat16* row, int d,
                                      int c1, bool vec) {
  Raw8 out;
  out.a = out.b = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    out.a = __ldg(reinterpret_cast<const uint4*>(row + d));
  } else {
    const unsigned short* src = reinterpret_cast<const unsigned short*>(row);
    unsigned h[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int i = 0; i < LANE_COLS; ++i)
      if (d + i < c1) h[i / 2] |= unsigned(src[d + i]) << (16 * (i % 2));
    out.a = make_uint4(h[0], h[1], h[2], h[3]);
  }
  return out;
}
__device__ __forceinline__ Raw8 load8(const float* row, int d, int c1,
                                      bool vec) {
  Raw8 out;
  out.a = out.b = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    out.a = __ldg(reinterpret_cast<const uint4*>(row + d));
    out.b = __ldg(reinterpret_cast<const uint4*>(row + d + 4));
  } else {
    const unsigned* src = reinterpret_cast<const unsigned*>(row);
    unsigned w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) w[i] = d + i < c1 ? __ldg(src + d + i) : 0u;
    out.a = make_uint4(w[0], w[1], w[2], w[3]);
    out.b = make_uint4(w[4], w[5], w[6], w[7]);
  }
  return out;
}
__device__ __forceinline__ void unpack8(const Raw8& raw, __nv_bfloat16,
                                        float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw.a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack8(const Raw8& raw, float, float* out) {
  out[0] = __uint_as_float(raw.a.x); out[1] = __uint_as_float(raw.a.y);
  out[2] = __uint_as_float(raw.a.z); out[3] = __uint_as_float(raw.a.w);
  out[4] = __uint_as_float(raw.b.x); out[5] = __uint_as_float(raw.b.y);
  out[6] = __uint_as_float(raw.b.z); out[7] = __uint_as_float(raw.b.w);
}

// Shared-memory offset of row d of a staged u slice: rows of r floats,
// 4 floats of padding after every 8 rows, so that the 8 lanes of a row,
// which read rows 8c + i (c = 0..7) together, hit 8 different 16-byte
// bank groups
__host__ __device__ __forceinline__ int u_offset(int d, int r) {
  return d * r + (d / LANE_COLS) * 4;
}

// Shrink: t[s][rows of nb] = x[rows, :] · u[s] for one (split of
// `split_cols` columns, block of NB rows, member), through the split
// partials `part` and the last block of the (member, row block). RC is
// the rank capacity of the accumulators (r ≤ RC). Every load of the
// block is issued before the first product: u's slice into shared memory
// (16-byte loads), x in batches of XB passes into registers.
constexpr int XB = 4;             // x passes a lane holds at once
constexpr int SB = 16;            // split partials the last block loads at once
template <typename T, int RC>
__global__ void __launch_bounds__(THREADS)
bgmv_shrink_kernel(const T* __restrict__ x, const float* __restrict__ u,
                   float* __restrict__ part, float* __restrict__ t,
                   int* __restrict__ counters, int n, int d_in, int r,
                   int shared_x, int split_cols, int vec_x, int vec_u) {
  extern __shared__ float us[];
  const int tid = threadIdx.x, lane = tid & 31;
  const int c = lane % ROW_LANES;
  const int row = (tid >> 5) * (32 / ROW_LANES) + lane / ROW_LANES;
  const int split = blockIdx.x, nb = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.x;
  const int gn = nb * NB + row;
  const int c0 = split * split_cols, c1 = min(d_in, c0 + split_cols);
  const T* xr = x + (shared_x ? 0 : (size_t)s * n * d_in) +
                (size_t)min(gn, n - 1) * d_in;
  const int passes = (c1 - c0 + PASS - 1) / PASS;

  // x: the first batch of passes, in flight while u is staged
  Raw8 xraw[XB];
#pragma unroll
  for (int b = 0; b < XB; ++b) {
    const int d = c0 + b * PASS + c * LANE_COLS;
    xraw[b] = gn < n && b < passes && d < c1 ? load8(xr, d, c1, vec_x)
                                            : Raw8{};
  }
  // u[c0 .. c1) into shared memory, 4 float4 a thread in flight at once
  {
    const float* usrc = u + ((size_t)s * d_in + c0) * r;
    const int nu = (c1 - c0) * r;
    if (vec_u) {
      const float4* u4 = reinterpret_cast<const float4*>(usrc);
      for (int e0 = tid; e0 < nu / 4; e0 += 4 * THREADS) {
        float4 w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (e0 + m * THREADS < nu / 4) w[m] = __ldg(u4 + e0 + m * THREADS);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = 4 * (e0 + m * THREADS);
          if (e < nu)
            *reinterpret_cast<float4*>(us + u_offset(e / r, r) + e % r) = w[m];
        }
      }
    } else {
      for (int e0 = tid; e0 < nu; e0 += 4 * THREADS) {
        float w[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          if (e0 + m * THREADS < nu) w[m] = __ldg(usrc + e0 + m * THREADS);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int e = e0 + m * THREADS;
          if (e < nu) us[u_offset(e / r, r) + e % r] = w[m];
        }
      }
    }
  }
  __syncthreads();

  float acc[RC];
#pragma unroll
  for (int j = 0; j < RC; ++j) acc[j] = 0.f;
  for (int b0 = 0; b0 < passes; b0 += XB) {
    if (b0) {
#pragma unroll
      for (int b = 0; b < XB; ++b) {
        const int d = c0 + (b0 + b) * PASS + c * LANE_COLS;
        xraw[b] = gn < n && b0 + b < passes && d < c1
                      ? load8(xr, d, c1, vec_x) : Raw8{};
      }
    }
#pragma unroll
    for (int b = 0; b < XB; ++b) {
      if (b0 + b >= passes) break;
      float xv[LANE_COLS];
      unpack8(xraw[b], T(), xv);
      const int dl = (b0 + b) * PASS + c * LANE_COLS;   // local column
#pragma unroll
      for (int i = 0; i < LANE_COLS; ++i) {
        if (c0 + dl + i >= c1) break;   // u's rows past the split: unstaged
        const float* ur = us + u_offset(dl + i, r);
        if (vec_u) {
#pragma unroll
          for (int m = 0; m < RC / 4; ++m) {
            if (4 * m >= r) break;
            const float4 w = reinterpret_cast<const float4*>(ur)[m];
            acc[4 * m] = fmaf(xv[i], w.x, acc[4 * m]);
            acc[4 * m + 1] = fmaf(xv[i], w.y, acc[4 * m + 1]);
            acc[4 * m + 2] = fmaf(xv[i], w.z, acc[4 * m + 2]);
            acc[4 * m + 3] = fmaf(xv[i], w.w, acc[4 * m + 3]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < RC; ++j)
            if (j < r) acc[j] = fmaf(xv[i], ur[j], acc[j]);
        }
      }
    }
  }
  // the row's 8 lanes add their sums (a + b and b + a round alike, so
  // every lane ends with the same bits)
#pragma unroll
  for (int j = 0; j < RC; ++j) {
    if (j >= r) break;
#pragma unroll
    for (int off = ROW_LANES / 2; off; off >>= 1)
      acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], off);
  }
  const size_t group = (size_t)s * gridDim.y + nb;   // (member, row block)
  float* dst = splits == 1 ? t + group * NB * r
                           : part + (group * splits + split) * NB * r;
#pragma unroll
  for (int j = 0; j < RC; ++j)
    if (j < r && j % ROW_LANES == c) dst[row * r + j] = gn < n ? acc[j] : 0.f;
  if (splits == 1) {
    pdl_trigger();
    return;
  }

  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  pdl_trigger();
  if (tid == 0) {
    is_last = atomicAdd(counters + group, 1) == splits - 1;
    if (is_last) counters[group] = 0;  // ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last block: the splits' partials in index order, SB of them in
  // flight at once
  const float* all = part + group * splits * NB * r;
  float* tg = t + group * NB * r;
  for (int e = tid; e < NB * r; e += THREADS) {
    float sum = 0.f;
    for (int k0 = 0; k0 < splits; k0 += SB) {
      float pv[SB];
#pragma unroll
      for (int k = 0; k < SB; ++k)
        pv[k] = k0 + k < splits ? __ldcg(all + (size_t)(k0 + k) * NB * r + e)
                                : 0.f;
#pragma unroll
      for (int k = 0; k < SB; ++k)
        if (k0 + k < splits) sum = k0 + k ? sum + pv[k] : pv[k];
    }
    tg[e] = sum;
  }
}

// Expand: y[n, o] = Σ_j t[n, j]·v[o, j] for one (tile of 32·ROWS output
// columns, block of NB rows, member). A thread takes 4 adjacent columns
// of ROWS rows; the column tile's 8·ROWS threads share a row group.
template <int ROWS>
__global__ void __launch_bounds__(THREADS)
bgmv_expand_kernel(const float* __restrict__ t, const float* __restrict__ v,
                   float* __restrict__ y, int n, int d_out, int r,
                   int vec_v, int vec_y) {
  constexpr int TPR = 8 * ROWS;          // threads of a row group
  constexpr int RG = THREADS / TPR;      // row groups: NB = RG · ROWS
  __shared__ float ts[NB * MAX_R];
  const int tid = threadIdx.x;
  const int q = tid % TPR, rg = tid / TPR;
  const int nb = blockIdx.y, s = blockIdx.z;
  const int o = blockIdx.x * 4 * TPR + 4 * q;
  const float* vb = v + ((size_t)s * d_out + o) * r;

  // ranks [j0, j0 + JC) of the thread's 4 columns (0 past d_out or r)
  float vr[4][JC];
  auto load_v = [&](int j0) {
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const bool in = o + cc < d_out;
      if (vec_v) {
#pragma unroll
        for (int m = 0; m < JC / 4; ++m) {
          float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in && j0 + 4 * m < r)
            w = __ldg(reinterpret_cast<const float4*>(vb + cc * r + j0) + m);
          vr[cc][4 * m] = w.x; vr[cc][4 * m + 1] = w.y;
          vr[cc][4 * m + 2] = w.z; vr[cc][4 * m + 3] = w.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < JC; ++j)
          vr[cc][j] = in && j0 + j < r ? __ldg(vb + cc * r + j0 + j) : 0.f;
      }
    }
  };
  load_v(0);
  pdl_wait();   // the shrink grid has completed: t is written
  const float* tg = t + ((size_t)s * gridDim.y + nb) * NB * r;
  for (int e = tid; e < NB * r; e += THREADS) ts[e] = __ldcg(tg + e);
  __syncthreads();

  float acc[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) acc[i][cc] = 0.f;
  for (int j0 = 0; j0 < r; j0 += JC) {
    if (j0) load_v(j0);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const float* trow = ts + (rg + i * RG) * r + j0;
#pragma unroll
      for (int j = 0; j < JC; ++j) {
        if (j0 + j >= r) break;
        const float tv = trow[j];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          acc[i][cc] = fmaf(tv, vr[cc][j], acc[i][cc]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int gn = nb * NB + rg + i * RG;
    if (gn >= n) continue;
    float* yr = y + ((size_t)s * n + gn) * d_out + o;
    if (vec_y && o < d_out) {
      *reinterpret_cast<float4*>(yr) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        if (o + cc < d_out) yr[cc] = acc[i][cc];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int RC>
cudaError_t launch_shrink(dim3 grid, const void* x, const float* u,
                          float* part, float* t, int* counters, int64_t n,
                          int64_t d_in, int64_t r, int shared_x,
                          int64_t split_cols, int vec_x, int vec_u,
                          cudaStream_t st) {
  const size_t smem = sizeof(float) * (u_offset((int)split_cols, (int)r));
  bgmv_shrink_kernel<T, RC><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), u, part, t, counters, (int)n, (int)d_in,
      (int)r, shared_x, (int)split_cols, vec_x, vec_u);
  return cudaGetLastError();
}

template <typename T>
cudaError_t shrink_by_rank(dim3 grid, const void* x, const float* u,
                           float* part, float* t, int* counters, int64_t n,
                           int64_t d_in, int64_t r, int shared_x,
                           int64_t split_cols, int vec_x, int vec_u,
                           cudaStream_t st) {
  if (r <= 8)
    return launch_shrink<T, 8>(grid, x, u, part, t, counters, n, d_in, r,
                               shared_x, split_cols, vec_x, vec_u, st);
  if (r <= 16)
    return launch_shrink<T, 16>(grid, x, u, part, t, counters, n, d_in, r,
                                shared_x, split_cols, vec_x, vec_u, st);
  if (r <= 32)
    return launch_shrink<T, 32>(grid, x, u, part, t, counters, n, d_in, r,
                                shared_x, split_cols, vec_x, vec_u, st);
  return launch_shrink<T, 64>(grid, x, u, part, t, counters, n, d_in, r,
                              shared_x, split_cols, vec_x, vec_u, st);
}

template <int ROWS>
cudaError_t launch_expand(dim3 grid, const float* t, const float* v,
                          float* y, int64_t n, int64_t d_out, int64_t r,
                          int vec_v, int vec_y, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bgmv_expand_kernel<ROWS>, t, v, y, (int)n,
                            (int)d_out, (int)r, vec_v, vec_y);
}

}  // namespace

// One call: shrink then expand on `stream`. The plan (`kernels/bgmv.py`
// `bgmv_plan`): `split_cols` columns of d_in a shrink block (a multiple of
// 64), `out_cols` columns of d_out an expand block (32, 64, 128, 256 or
// 512). `part` holds S·⌈N/32⌉·splits·32·r floats (unused when one split
// covers d_in), `t` S·⌈N/32⌉·32·r, `counters` S·⌈N/32⌉ ints, all 0 before
// the first call and left 0 by every call.
extern "C" int bgmv_f32(const void* x, int x_bf16, const float* u,
                        const float* v, float* y, float* part, float* t,
                        int* counters, int64_t s, int64_t n, int64_t d_in,
                        int64_t d_out, int64_t r, int shared_x,
                        int64_t split_cols, int64_t out_cols, void* stream) {
  if (s < 1 || n < 1 || d_in < 1 || d_out < 1 || r < 1 || r > MAX_R ||
      split_cols < PASS || split_cols % PASS || split_cols * r > MAX_U ||
      n > INT32_MAX ||
      d_in > INT32_MAX || d_out > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_blocks = (n + NB - 1) / NB;
  const int64_t splits = (d_in + split_cols - 1) / split_cols;
  const size_t xsize = x_bf16 ? 2 : 4;
  const int vec_x = aligned16(x) && (d_in * (int64_t)xsize) % 16 == 0 &&
                    d_in % LANE_COLS == 0;
  const int vec_u = aligned16(u) && r % 4 == 0;
  const dim3 sgrid((unsigned)splits, (unsigned)n_blocks, (unsigned)s);
  cudaError_t err =
      x_bf16 ? shrink_by_rank<__nv_bfloat16>(sgrid, x, u, part, t, counters,
                                             n, d_in, r, shared_x,
                                             split_cols, vec_x, vec_u, st)
             : shrink_by_rank<float>(sgrid, x, u, part, t, counters, n,
                                     d_in, r, shared_x, split_cols, vec_x,
                                     vec_u, st);
  if (err != cudaSuccess) return (int)err;
  const int vec_v = aligned16(v) && r % 4 == 0;
  const int vec_y = aligned16(y) && d_out % 4 == 0;
  const dim3 egrid((unsigned)((d_out + out_cols - 1) / out_cols),
                   (unsigned)n_blocks, (unsigned)s);
  switch (out_cols) {
    case 32: err = launch_expand<1>(egrid, t, v, y, n, d_out, r, vec_v, vec_y, st); break;
    case 64: err = launch_expand<2>(egrid, t, v, y, n, d_out, r, vec_v, vec_y, st); break;
    case 128: err = launch_expand<4>(egrid, t, v, y, n, d_out, r, vec_v, vec_y, st); break;
    case 256: err = launch_expand<8>(egrid, t, v, y, n, d_out, r, vec_v, vec_y, st); break;
    case 512: err = launch_expand<16>(egrid, t, v, y, n, d_out, r, vec_v, vec_y, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
