// Flash attention, forward, for Hopper (sm_90a): causal or sliding-window
// GQA softmax attention with an online softmax, f32 scores and
// accumulators, inputs and output in bf16 or f32.
//
//   q (B, Tq, H, hd); k, v (B, Tk, KV, hd); query head h reads kv head
//   h / (H / KV); out (B, Tq, H, hd) in q's dtype
//
// Replaces: src/repro/kernels/flash_attention.py:flash_attention_pallas
// (body _fa_kernel). What it computes is the Pallas kernel's: scores
// (q·scale)·kᵀ in f32, scale = hd^-1/2 as the caller rounds it; a key is
// masked (score −1e30) when it lies at or past Tk, after the query
// (causal), or `window` or more positions before it;
// the running max m, sum l and output accumulator are rescaled per key
// tile; out = acc / max(l, 1e-30). The TPU kernel runs a sequential grid
// axis over key blocks with (m, l, acc) in VMEM scratch; here one block
// owns (b, h, 64 query rows) and loops over key tiles itself. Key tiles
// that are masked for every row of the block (above the causal diagonal,
// wholly outside the window) are skipped: for a row that has a valid key
// in some tile they add exactly nothing to (m, l, acc). A row with no valid
// key at all (not possible in causal self-attention, where each query sees
// itself) gets 0 here where the Pallas kernel averages the values of the
// padded key blocks.
//
// Layout of a block: 256 threads, 4 per query row. Each thread keeps its
// row of q (scaled) in registers, computes the scores of 16 of the tile's
// 64 keys (keys l, l+4, …), shares max and sum over its 4 lanes with warp
// shuffles, writes its probabilities to shared memory, and accumulates
// p·v for 16 of the hd columns (columns l, l+4, …) over all 64 keys.
// K (padded rows: no bank conflicts), V and P tiles live in dynamic shared
// memory.
//
// Bound on an H100 SXM: operations at the serving shape's head counts and
// long sequences (4·hd FLOP per (query, key) pair against the bytes of q,
// k, v and o); this first kernel computes in f32 FFMA, not the tensor
// cores, so it stays well above that bound.
//
// Plain C interface for ctypes; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 64;               // query rows per block
constexpr int BK = 64;               // keys per tile
constexpr int LANES = 4;             // threads per query row
constexpr int KEYS = BK / LANES;     // scores per thread per tile
constexpr int PS = BK + 4;           // row stride of the P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)BK * (HD + 1) + (size_t)BK * HD +
                          (size_t)BQ * PS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int tq, int tk,
                  int h, int kv, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                          // [BK][HD + 1]
  float* vs = ks + BK * (HD + 1);            // [BK][HD]
  float* ps = vs + BK * HD;                  // [BQ][PS]

  constexpr int COLS = HD / LANES;
  const int tid = threadIdx.x;
  const int row = tid / LANES, lane = tid % LANES;
  const int q0 = blockIdx.x * BQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kvh = hh / (h / kv);
  const int qpos = q0 + row;
  const bool live = qpos < tq;

  float qr[HD];
  const T* qrow = q + (((size_t)b * tq + (live ? qpos : 0)) * h + hh) * HD;
#pragma unroll
  for (int c = 0; c < HD; ++c) qr[c] = live ? to_f32(qrow[c]) * scale : 0.f;

  float m = NEG_INF, l = 0.f, acc[COLS];
#pragma unroll
  for (int c = 0; c < COLS; ++c) acc[c] = 0.f;

  const int n_kt = (tk + BK - 1) / BK;
  const int q_last = min(q0 + BQ, tq) - 1;
  const int kt_end = causal ? min(n_kt, q_last / BK + 1) : n_kt;
  const int kt_begin = window > 0 ? max(0, q0 - window + 1) / BK : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V are no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int key = i / HD, c = i % HD;
      const int kpos = k0 + key;
      float kx = 0.f, vx = 0.f;
      if (kpos < tk) {
        const size_t off = (((size_t)b * tk + kpos) * kv + kvh) * HD + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[key * (HD + 1) + c] = kx;
      vs[key * HD + c] = vx;
    }
    __syncthreads();

    float s[KEYS];
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const int key = lane + LANES * j;
      const int kpos = k0 + key;
      const float* kr = ks + key * (HD + 1);
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < HD; ++c) dot = fmaf(qr[c], kr[c], dot);
      bool valid = kpos < tk;
      if (causal) valid = valid && qpos >= kpos;
      if (window > 0) valid = valid && qpos - kpos < window;
      s[j] = valid ? dot : NEG_INF;
      mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      const float p = expf(s[j] - m_new);
      ps[row * PS + lane + LANES * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's 4 lanes have written its probabilities
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[c] *= corr;
    const float* prow = ps + row * PS;
    for (int key = 0; key < BK; ++key) {
      const float p = prow[key];
      const float* vr = vs + key * HD + lane;
#pragma unroll
      for (int c = 0; c < COLS; ++c) acc[c] = fmaf(p, vr[LANES * c], acc[c]);
    }
    __syncwarp();  // done reading the row's probabilities
  }

  if (live) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = o + (((size_t)b * tq + qpos) * h + hh) * HD + lane;
#pragma unroll
    for (int c = 0; c < COLS; ++c) orow[LANES * c] = from_f32<T>(acc[c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int64_t b,
           int64_t tq, int64_t tk, int64_t h, int64_t kv, int causal,
           int64_t window, float scale, cudaStream_t st) {
  // the attribute is per device: one bit per device it was set on
  static uint64_t configured = 0;
  constexpr size_t smem = smem_bytes<HD>();
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? uint64_t(1) << dev : 0;
  if (!(configured & bit)) {
    err = cudaFuncSetAttribute(
        flash_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured |= bit;
  }
  const dim3 grid((unsigned)((tq + BQ - 1) / BQ), (unsigned)h, (unsigned)b);
  flash_attn_kernel<T, HD><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), (int)tq, (int)tk, (int)h,
      (int)kv, causal, (int)window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int64_t b,
             int64_t tq, int64_t tk, int64_t h, int64_t kv, int64_t hd,
             int causal, int64_t window, float scale, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, tq, tk, h, kv, causal, window,
                           scale, st);
    case 64:
      return launch<T, 64>(q, k, v, o, b, tq, tk, h, kv, causal, window,
                           scale, st);
    case 112:  // zamba2's shared attention block, 3584 / 32 heads
      return launch<T, 112>(q, k, v, o, b, tq, tk, h, kv, causal, window,
                            scale, st);
    case 128:
      return launch<T, 128>(q, k, v, o, b, tq, tk, h, kv, causal, window,
                            scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int bf16, int64_t b, int64_t tq,
                              int64_t tk, int64_t h, int64_t kv, int64_t hd,
                              int causal, int64_t window, float scale,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(q, k, v, o, b, tq, tk, h, kv, hd,
                                        causal, window, scale, st)
              : dispatch<float>(q, k, v, o, b, tq, tk, h, kv, hd, causal,
                                window, scale, st);
}
