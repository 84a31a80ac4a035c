// Chunked gated linear attention (GLA), backward, for Hopper (sm_90a): the
// gradients of what gla_chunk_f32.cu computes forward, for Mamba2 (scalar
// decay per head, "post") and RWKV6 (per-channel decay, "pre" with the
// current-token bonus), q/k/v/dy in bf16 or f32, f32 arithmetic (FFMA).
//
//   q, k (B, T, H, K); v, dy (B, T, H, V); log_decay (B, T, H) or
//   (B, T, H, K) f32; bonus (H, K) f32 or none; the states each chunk
//   entered with, S_c (B·H, chunks, K, V) f32, from the forward's state
//   pass  →  dq, dk (B, T, H, K), dv (B, T, H, V) in q's dtype;
//   d log_decay f32 in log_decay's shape; d bonus (H, K) f32
//
// Replaces no TPU kernel: the reference's Pallas GLA is forward-only and
// its training differentiates the jnp chunked form
// (src/repro/models/ssm.py:gla_chunked) with jax.grad. This kernel
// computes that gradient from the forward's chunked form (lc the running
// sum of the log decay inside the chunk, lq = lc, or lc shifted by one
// under "pre"; L the chunk's length; dS_{c+1} the cotangent of the state
// chunk c leaves with, 0 after the last chunk):
//
//   dq_i = e^{lq_i} ⊙ (S_c·dy_i) + Σ_{j≤i} (dy_i·v_j) k_j ⊙ e^{lq_i − lc_j}
//   dk_j = e^{lc_L − lc_j} ⊙ (dS_{c+1}·v_j)
//          + Σ_{i≥j} (dy_i·v_j) q_i ⊙ e^{lq_i − lc_j}
//   dv_j = (k_j ⊙ e^{lc_L − lc_j})·dS_{c+1} + Σ_{i≥j} s_ij dy_i
//   dS_c = e^{lc_L} ⊙ dS_{c+1} + Σ_i (q_i ⊙ e^{lq_i})ᵀ dy_i
//
// (j < i under "pre", s_ij the forward's masked scores), plus under "pre"
// the bonus diagonal: dq_i += u ⊙ k_i (dy_i·v_i), dk_i += u ⊙ q_i
// (dy_i·v_i), dv_i += (q_i ⊙ u ⊙ k_i)·1 dy_i, d bonus = Σ_{b,t} q_t ⊙ k_t
// (dy_t·v_t). With G the running sum of the log decay over the whole
// sequence, ∂/∂G_t = q_t ⊙ dq_t − k_t ⊙ dk_t ("post") or q_{t+1} ⊙
// dq_{t+1} − k_t ⊙ dk_t ("pre"), dq and dk without the bonus terms, and
// d log_decay_t = Σ_{t' ≥ t} ∂/∂G_{t'} (summed over K for a scalar decay),
// taken inside chunk c token by token and over all later tokens at once:
// raising G from chunk c + 1 on scales the state S_{c+1} that chunk
// enters with, so that part is ⟨dS_{c+1}, S_{c+1}⟩ (over V), under "pre"
// with q ⊙ dq of the next chunk's first token in it. (A running sum over
// all T tokens in f32 carries T·2⁻²⁴ of its partial sums into whatever
// sums the decay gradient over T: Mamba2's A_log read 3.8e-4 from the CPU
// on an H100 that way.)
// Every exponent is a difference ≤ 0, taken as one expf; a masked pair is
// skipped, never multiplied by 0. A ragged tail (T % L ≠ 0) reads the
// forward's inert padding (q = k = v = dy = 0, log decay 0) and writes
// nothing past T.
//
// Design: the forward's chunk-parallel shape, six launches a call on the
// caller's stream, each sum taken by one thread in a fixed order (no
// float atomics: a call repeated is bitwise equal).
//  (1) dq, grid (B·H, chunks × row tiles of 32 queries): a block stages
//      its queries' q and dy and the keys before them, dP = dy·vᵀ over the
//      mask, and dq by the formula above (S_c read from the forward's
//      workspace: kept, not recomputed; the wrapper saves B·H·chunks·K·V
//      floats a call), then q ⊙ dq into d log_decay (at t − 1 inside the
//      chunk under "pre", whose last token's slot starts at 0) and the
//      tile's bonus partial q ⊙ k (dy·v) summed over its rows.
//  (2) the reverse state pass: a block a chunk forms Q_c = Σ_i (q_i ⊙
//      e^{lq_i})ᵀ dy_i and e^{lc_L}; (3) a block a (b, h) then runs dS
//      backwards over the chunks from 0, storing each dS_{c+1} over Q_c.
//  (4) dk and dv, grid (B·H, chunks × tiles of 32 keys): a block stages
//      its keys and the queries at or after them, the scores s and dP
//      (each pair's per-channel exponent one expf), dk and dv by the
//      formulas above, and subtracts k ⊙ dk from d log_decay.
//  (5) the decay's reverse sums, a block a chunk, a thread a channel
//      (scalar decay: one): ⟨dS_{c+1}, S_{c+1}⟩, then the chunk's tokens
//      from its end.
//  (6) "pre": d bonus, a thread an (h, channel), the partials summed over
//      b and then the tiles in order.
//
// Bound on an H100 SXM: operations. Per chunk and (b, h) the function
// needs, for each of the mask's pairs, the scores (2·K FLOP), dP (2·V),
// dq's and dk's intra-chunk terms (2·K each) and dv's (2·V), and per
// channel K exponentials a pair; and four products of 2·L·K·V FLOP (dq's
// and dk's state terms, dv's, Q_c); against 2 bytes a bf16 element of q,
// k, v, dy read once and dq, dk, dv written once, 4 a decay element read
// and written. With bf16 inputs the products of two of them (dP, the
// scalar decay's scores, the bonus's dy·v) count at the bf16 peak, the
// rest (an f32 operand: S, dS, a decay factor) at the f32 peak. This kernel recomputes dP in (4) and, per channel, each
// pair's exponentials in (1) and twice in (4): it is the simple form,
// right first.
//
// Instances: chunk capacity 32 (RWKV6) and 128 (Mamba2's chunk, or any
// chunk of 33–128), scalar or per-channel decay, bf16 or f32.
//
// Plain C interface for ctypes; returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_KV = 64;     // largest K and V
constexpr int QR = 32;         // rows of a tile: queries in (1), keys in (4)
constexpr int THREADS = 128;   // (1) and (4)
constexpr int S_THREADS = 256; // (2) and (3): a 4 × 4 piece of K × V each

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dy;
  const float* ld;
  const float* bonus;    // null: "post" convention, no bonus
  const float* states;   // S_c (B·H, chunks, K, V)
  void* dq;
  void* dk;
  void* dv;
  float* dld;
  float* dbonus;
  float* ds;             // Q_c, then dS_{c+1} (B·H, chunks, K, V)
  float* dc;             // e^{lc_L} (B·H, chunks, K)
  float* part;           // bonus partials (B·H, chunks × tiles, K)
  int64_t t_len, n_chunks;
  int b, h, kd, vd, chunk, tiles;   // tiles: row tiles a chunk
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t y_sb, y_st, y_sh;
  int64_t l_sb, l_st, l_sh;
};

// rows × round_up(w, 4) of a strided array (unit column stride, row
// stride rs) into f32 shared rows of pitch `pitch`: rows < valid and
// columns < w from src, the rest 0
template <typename T>
__device__ __forceinline__ void stage(float* dst, int pitch, const T* src,
                                     int64_t rs, int rows, int valid, int w,
                                     int tid, int nthreads) {
  const int wp = round_up(w, 4);
  for (int e = tid; e < rows * wp; e += nthreads) {
    const int r = e / wp, c = e % wp;
    dst[r * pitch + c] = r < valid && c < w ? to_f32(src[r * rs + c]) : 0.f;
  }
}

// The chunk's log decay into `lz` (row 0 zeros, row r + 1 token r, zeros
// past `valid`), then its inclusive running sums in token order, in
// place: one thread a channel walks its column (scalar decay: one).
template <bool PERCH>
__device__ __forceinline__ void decay_sums(float* lz, int lp, const float* ld,
                                           int64_t l_st, int len, int valid,
                                           int kd, int tid, int nthreads) {
  const int w = PERCH ? kd : 1;
  for (int e = tid; e < (len + 1) * w; e += nthreads) {
    const int r = e / w, c = e % w;
    lz[r * lp + c] = r >= 1 && r - 1 < valid ? ld[(r - 1) * l_st + c] : 0.f;
  }
  __syncthreads();
  for (int c = tid; c < w; c += nthreads) {
    float acc = 0.f;
    for (int r = 1; r <= len; ++r) {
      acc += lz[r * lp + c];
      lz[r * lp + c] = acc;
    }
  }
  __syncthreads();
}

// pointers of (b, h) and token t0 in a strided (B, T, H, ·) array
template <typename T>
__device__ __forceinline__ const T* at(const void* p, int b, int hh,
                                       int64_t t0, int64_t sb, int64_t st,
                                       int64_t sh) {
  return static_cast<const T*>(p) + b * sb + hh * sh + t0 * st;
}

// ---------------------------------------------------------------------------
// (1) dq
// ---------------------------------------------------------------------------

// Shared floats of a dq block (chunk capacity LT): k and v of the keys
// [LT][KP], [LT][VP]; q and dy of the queries [QR][KP], [QR][VP]; the log
// decay [LT + 1][KP] or [LT + 1]; S_c [K][VP]; dP [QR][LT + 4]; q ⊙ dq
// [QR][KP]; dy_i·v_i [QR]; the bonus [K].
struct DqSmem {
  int kp, vp, lp, dpp, lt, kd;
  bool perch;
  __host__ __device__ DqSmem(int lt_, int kd_, int vd, bool perch_)
      : kp(round_up(kd_, 4) + 4), vp(round_up(vd, 4) + 4),
        lp(perch_ ? round_up(kd_, 4) + 4 : 1), dpp(lt_ + 4), lt(lt_),
        kd(kd_), perch(perch_) {}
  __host__ __device__ int k() const { return 0; }
  __host__ __device__ int v() const { return k() + lt * kp; }
  __host__ __device__ int q() const { return v() + lt * vp; }
  __host__ __device__ int dy() const { return q() + QR * kp; }
  __host__ __device__ int l() const { return dy() + QR * vp; }
  __host__ __device__ int s() const {
    return l() + round_up((lt + 1) * lp, 4);
  }
  __host__ __device__ int dp() const { return s() + kd * vp; }
  __host__ __device__ int a() const { return dp() + QR * dpp; }
  __host__ __device__ int dg() const { return a() + QR * kp; }
  __host__ __device__ int u() const { return dg() + QR; }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)(u() + MAX_KV);
  }
};

template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(THREADS) gla_bwd_dq_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const DqSmem lay(LT, kd, vd, PERCH);
  const int kp = lay.kp, vp = lay.vp, lp = lay.lp, dpp = lay.dpp;
  float* kf = sm + lay.k();
  float* vf = sm + lay.v();
  float* qf = sm + lay.q();
  float* yf = sm + lay.dy();
  float* lz = sm + lay.l();       // row 0 zeros, row r + 1: lc_r
  float* S = sm + lay.s();
  float* dP = sm + lay.dp();
  float* ar = sm + lay.a();
  float* dg = sm + lay.dg();
  float* us = sm + lay.u();

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y / a.tiles;
  const int rb = blockIdx.y % a.tiles;
  const bool pre = a.bonus != nullptr;
  const int64_t t_len = a.t_len, t0 = ch * len;
  const int valid = (int)min((int64_t)len, t_len - t0);   // rows before T
  const int i0 = rb * QR;
  const int nq = min(QR, len - i0);   // query rows i0 .. i0 + nq − 1
  const int nk = i0 + nq;             // keys 0 .. nk − 1
  float* part = a.part + ((size_t)bh * a.n_chunks * a.tiles + blockIdx.y) * kd;
  if (i0 >= valid) {                  // rows wholly past T
    if (pre)
      for (int kk = tid; kk < kd; kk += THREADS) part[kk] = 0.f;
    return;
  }
  const int qvalid = min(nq, valid - i0);   // query rows before T

  // 1. stage keys, queries, the log decay, S_c and the bonus
  stage(kf, kp, at<T>(a.k, b, hh, t0, a.k_sb, a.k_st, a.k_sh), a.k_st, nk,
        valid, kd, tid, THREADS);
  stage(vf, vp, at<T>(a.v, b, hh, t0, a.v_sb, a.v_st, a.v_sh), a.v_st, nk,
        valid, vd, tid, THREADS);
  stage(qf, kp, at<T>(a.q, b, hh, t0 + i0, a.q_sb, a.q_st, a.q_sh), a.q_st,
        nq, qvalid, kd, tid, THREADS);
  stage(yf, vp, at<T>(a.dy, b, hh, t0 + i0, a.y_sb, a.y_st, a.y_sh),
        a.y_st, nq, qvalid, vd, tid, THREADS);
  stage(S, vp, a.states + ((size_t)bh * a.n_chunks + ch) * kd * vd,
        (int64_t)vd, kd, kd, vd, tid, THREADS);
  if (pre)
    for (int kk = tid; kk < kd; kk += THREADS)
      us[kk] = a.bonus[(size_t)hh * kd + kk];
  decay_sums<PERCH>(lz, lp, a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st,
                    a.l_st, len, valid, kd, tid, THREADS);

  // lq_i is row i (pre) or i + 1 (post) of lz, lc_j row j + 1
  const int qoff = pre ? 0 : 1;

  // 2. dP_ij = dy_i·v_j over the mask (scalar decay: times e^{lq_i − lc_j});
  //    dy_i·v_i for the bonus
  for (int e = tid; e < nq * nk; e += THREADS) {
    const int il = e / nk, j = e % nk, i = i0 + il;
    float val = 0.f;
    if (pre ? j < i : j <= i) {
      for (int c = 0; c < vd; ++c)
        val = fmaf(yf[il * vp + c], vf[j * vp + c], val);
      if (!PERCH) val *= expf(lz[i + qoff] - lz[j + 1]);
    }
    dP[il * dpp + j] = val;
  }
  if (pre)
    for (int il = tid; il < nq; il += THREADS) {
      float d = 0.f;
      for (int c = 0; c < vd; ++c)
        d = fmaf(yf[il * vp + c], vf[(i0 + il) * vp + c], d);
      dg[il] = d;
    }
  __syncthreads();

  // 3. dq = e^{lq}⊙(S_c·dy) + Σ_j dP_ij k_j ⊙ e^{lq_i − lc_j} [+ bonus]
  T* dq = static_cast<T*>(a.dq) + ((size_t)b * t_len * a.h + hh) * kd;
  const int64_t o_st = (int64_t)a.h * kd;
  for (int e = tid; e < nq * kd; e += THREADS) {
    const int il = e / kd, kk = e % kd, i = i0 + il;
    const float lq = lz[(i + qoff) * lp + (PERCH ? kk : 0)];
    float inter = 0.f;
    for (int c = 0; c < vd; ++c)
      inter = fmaf(S[kk * vp + c], yf[il * vp + c], inter);
    float acc = expf(lq) * inter;
    const int jend = pre ? i : i + 1;
    if (PERCH) {
      for (int j = 0; j < jend; ++j)
        acc = fmaf(dP[il * dpp + j] * kf[j * kp + kk],
                   expf(lq - lz[(j + 1) * lp + kk]), acc);
    } else {
      for (int j = 0; j < jend; ++j)
        acc = fmaf(dP[il * dpp + j], kf[j * kp + kk], acc);
    }
    ar[il * kp + kk] = qf[il * kp + kk] * acc;
    if (pre) acc = fmaf(us[kk] * kf[i * kp + kk], dg[il], acc);
    if (il < qvalid) dq[(t0 + i) * o_st + kk] = from_f32<T>(acc);
  }
  __syncthreads();

  // 4. q ⊙ dq into d log_decay at t ("post") or, inside the chunk, t − 1
  //    ("pre": the chunk's first token's goes to the chunk before through
  //    its carry, and its last token's slot starts at 0); the tile's bonus
  //    partial, rows in order
  const int64_t tq = t0 + i0;
  if (PERCH) {
    float* dld = a.dld + ((size_t)b * t_len * a.h + hh) * kd;
    for (int e = tid; e < qvalid * kd; e += THREADS) {
      const int il = e / kd, kk = e % kd, i = i0 + il;
      const int64_t t = tq + il;
      if (!pre) dld[t * o_st + kk] = ar[il * kp + kk];
      else if (i > 0) dld[(t - 1) * o_st + kk] = ar[il * kp + kk];
      if (pre && i == valid - 1) dld[t * o_st + kk] = 0.f;
    }
  } else {
    float* dld = a.dld + (size_t)b * t_len * a.h + hh;
    for (int il = tid; il < qvalid; il += THREADS) {
      float s = 0.f;
      for (int kk = 0; kk < kd; ++kk) s += ar[il * kp + kk];
      const int i = i0 + il;
      const int64_t t = tq + il;
      if (!pre) dld[t * a.h] = s;
      else if (i > 0) dld[(t - 1) * a.h] = s;
      if (pre && i == valid - 1) dld[t * a.h] = 0.f;
    }
  }
  if (pre)
    for (int kk = tid; kk < kd; kk += THREADS) {
      float s = 0.f;
      for (int il = 0; il < qvalid; ++il)
        s = fmaf(qf[il * kp + kk] * kf[(i0 + il) * kp + kk], dg[il], s);
      part[kk] = s;
    }
}

// ---------------------------------------------------------------------------
// (2), (3) the reverse state pass
// ---------------------------------------------------------------------------

// Shared floats of a chunk's block: q then q ⊙ e^{lq} [LT][KP], dy
// [LT][VP], the log decay [LT + 1][KP] or [LT + 1].
template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(S_THREADS) gla_bwd_qc_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const int kp = round_up(kd, 4) + 4, vp = round_up(vd, 4) + 4;
  const int lp = PERCH ? kp : 1;
  float* qf = sm;
  float* yf = qf + LT * kp;
  float* lz = yf + LT * vp;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y;
  const bool pre = a.bonus != nullptr;
  const int64_t t0 = ch * len;
  const int valid = (int)min((int64_t)len, a.t_len - t0);

  stage(qf, kp, at<T>(a.q, b, hh, t0, a.q_sb, a.q_st, a.q_sh), a.q_st, len,
        valid, kd, tid, S_THREADS);
  stage(yf, vp, at<T>(a.dy, b, hh, t0, a.y_sb, a.y_st, a.y_sh), a.y_st,
        len, valid, vd, tid, S_THREADS);
  decay_sums<PERCH>(lz, lp, a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st,
                    a.l_st, len, valid, kd, tid, S_THREADS);
  const int qoff = pre ? 0 : 1;
  for (int e = tid; e < len * kd; e += S_THREADS) {
    const int i = e / kd, kk = e % kd;
    qf[i * kp + kk] *= expf(lz[(i + qoff) * lp + (PERCH ? kk : 0)]);
  }
  float* dc = a.dc + ((size_t)bh * a.n_chunks + ch) * kd;
  for (int kk = tid; kk < kd; kk += S_THREADS)
    dc[kk] = expf(lz[len * lp + (PERCH ? kk : 0)]);
  __syncthreads();

  // Q_c = Σ_i (q_i ⊙ e^{lq_i})ᵀ dy_i, rows in order: 4 × 4 a thread
  const int k0 = 4 * (tid / 16), v0 = 4 * (tid % 16);
  if (k0 >= kd || v0 >= vd) return;
  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
  for (int i = 0; i < len; ++i) {
    float xa[4], xb[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) xa[m] = qf[i * kp + k0 + m];   // padded: 0
#pragma unroll
    for (int n = 0; n < 4; ++n) xb[n] = yf[i * vp + v0 + n];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(xa[m], xb[n], acc[m][n]);
  }
  float* w = a.ds + ((size_t)bh * a.n_chunks + ch) * kd * vd;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
      if (k0 + m < kd && v0 + n < vd)
        w[(k0 + m) * vd + v0 + n] = acc[m][n];
}

// A block a (b, h): dS runs backwards over the chunks from 0, each
// chunk's slot taking the cotangent of the state the chunk leaves with:
// g ← 0; for c = chunks − 1 … 0: read Q_c, store g, g ← Q_c + e^{lc_L} ⊙ g.
__global__ void __launch_bounds__(S_THREADS) gla_bwd_scan_kernel(Args a) {
  const int tid = threadIdx.x, bh = blockIdx.x;
  const int kd = a.kd, vd = a.vd;
  const int k0 = 4 * (tid / 16), v0 = 4 * (tid % 16);
  if (k0 >= kd || v0 >= vd) return;
  float* w = a.ds + (size_t)bh * a.n_chunks * kd * vd;
  const float* dh = a.dc + (size_t)bh * a.n_chunks * kd;
  float g[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) g[m][n] = 0.f;
  for (int64_t c = a.n_chunks - 1; c >= 0; --c) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int kk = k0 + m;
      if (kk >= kd) continue;
      const float d = dh[c * kd + kk];
      float* row = w + (c * kd + kk) * vd + v0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        if (v0 + n >= vd) continue;
        const float qc = row[n];
        row[n] = g[m][n];
        g[m][n] = fmaf(d, g[m][n], qc);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (4) dk and dv
// ---------------------------------------------------------------------------

// Shared floats of a dk/dv block: q and dy of the queries [LT][KP],
// [LT][VP]; k, v and k ⊙ e^{lc_L − lc} of the keys [QR][KP], [QR][VP],
// [QR][KP]; the log decay [LT + 1][KP] or [LT + 1]; dS_{c+1} [K][VP]; the
// scores and dP [LT][QR + 4] each; k ⊙ dk [QR][KP]; the bonus diagonal
// and dy_j·v_j [QR] each; the bonus [K].
struct DkvSmem {
  int kp, vp, lp, sp, lt, kd;
  __host__ __device__ DkvSmem(int lt_, int kd_, int vd, bool perch)
      : kp(round_up(kd_, 4) + 4), vp(round_up(vd, 4) + 4),
        lp(perch ? round_up(kd_, 4) + 4 : 1), sp(QR + 4), lt(lt_), kd(kd_) {}
  __host__ __device__ int q() const { return 0; }
  __host__ __device__ int dy() const { return q() + lt * kp; }
  __host__ __device__ int k() const { return dy() + lt * vp; }
  __host__ __device__ int v() const { return k() + QR * kp; }
  __host__ __device__ int kt() const { return v() + QR * vp; }
  __host__ __device__ int l() const { return kt() + QR * kp; }
  __host__ __device__ int s() const {
    return l() + round_up((lt + 1) * lp, 4);
  }
  __host__ __device__ int sc() const { return s() + kd * vp; }
  __host__ __device__ int dp() const { return sc() + lt * sp; }
  __host__ __device__ int b() const { return dp() + lt * sp; }
  __host__ __device__ int dg() const { return b() + QR * kp; }
  __host__ __device__ int dd() const { return dg() + QR; }
  __host__ __device__ int u() const { return dd() + QR; }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (size_t)(u() + MAX_KV);
  }
};

template <typename T, int LT, bool PERCH>
__global__ void __launch_bounds__(THREADS) gla_bwd_dkv_kernel(Args a) {
  extern __shared__ __align__(16) float sm[];
  const int kd = a.kd, vd = a.vd, len = a.chunk;
  const DkvSmem lay(LT, kd, vd, PERCH);
  const int kp = lay.kp, vp = lay.vp, lp = lay.lp, sp = lay.sp;
  float* qf = sm + lay.q();
  float* yf = sm + lay.dy();
  float* kf = sm + lay.k();
  float* vf = sm + lay.v();
  float* kt = sm + lay.kt();
  float* lz = sm + lay.l();
  float* dS = sm + lay.s();
  float* sc = sm + lay.sc();
  float* dP = sm + lay.dp();
  float* br = sm + lay.b();
  float* dg = sm + lay.dg();
  float* dd = sm + lay.dd();
  float* us = sm + lay.u();

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y / a.tiles;
  const int rb = blockIdx.y % a.tiles;
  const bool pre = a.bonus != nullptr;
  const int64_t t_len = a.t_len, t0 = ch * len;
  const int valid = (int)min((int64_t)len, t_len - t0);
  const int j0 = rb * QR;
  if (j0 >= valid) return;            // keys wholly past T
  const int nj = min(QR, len - j0);   // keys j0 .. j0 + nj − 1
  const int nq = len - j0;            // queries j0 .. len − 1
  const int rvalid = valid - j0;      // of both, the rows before T

  // 1. stage
  stage(qf, kp, at<T>(a.q, b, hh, t0 + j0, a.q_sb, a.q_st, a.q_sh), a.q_st,
        nq, rvalid, kd, tid, THREADS);
  stage(yf, vp, at<T>(a.dy, b, hh, t0 + j0, a.y_sb, a.y_st, a.y_sh),
        a.y_st, nq, rvalid, vd, tid, THREADS);
  stage(kf, kp, at<T>(a.k, b, hh, t0 + j0, a.k_sb, a.k_st, a.k_sh), a.k_st,
        nj, rvalid, kd, tid, THREADS);
  stage(vf, vp, at<T>(a.v, b, hh, t0 + j0, a.v_sb, a.v_st, a.v_sh), a.v_st,
        nj, rvalid, vd, tid, THREADS);
  stage(dS, vp, a.ds + ((size_t)bh * a.n_chunks + ch) * kd * vd,
        (int64_t)vd, kd, kd, vd, tid, THREADS);
  if (pre)
    for (int kk = tid; kk < kd; kk += THREADS)
      us[kk] = a.bonus[(size_t)hh * kd + kk];
  decay_sums<PERCH>(lz, lp, a.ld + b * a.l_sb + hh * a.l_sh + t0 * a.l_st,
                    a.l_st, len, valid, kd, tid, THREADS);
  const int qoff = pre ? 0 : 1;

  // 2. per pair (query i = j0 + iq, key j = j0 + jl) over the mask: the
  //    score s_ij and dP_ij (scalar decay: both times e^{lq_i − lc_j});
  //    k ⊙ e^{lc_L − lc}; under "pre" the bonus diagonal and dy_j·v_j
  for (int e = tid; e < nq * nj; e += THREADS) {
    const int iq = e / nj, jl = e % nj;
    float s = 0.f, p = 0.f;
    if (pre ? iq > jl : iq >= jl) {
      const int i = j0 + iq, j = j0 + jl;
      for (int c = 0; c < vd; ++c)
        p = fmaf(yf[iq * vp + c], vf[jl * vp + c], p);
      if (PERCH) {
        for (int kk = 0; kk < kd; ++kk)
          s = fmaf(qf[iq * kp + kk] * kf[jl * kp + kk],
                   expf(lz[(i + qoff) * lp + kk] - lz[(j + 1) * lp + kk]), s);
      } else {
        for (int kk = 0; kk < kd; ++kk)
          s = fmaf(qf[iq * kp + kk], kf[jl * kp + kk], s);
        const float ex = expf(lz[i + qoff] - lz[j + 1]);
        s *= ex;
        p *= ex;
      }
    }
    sc[iq * sp + jl] = s;
    dP[iq * sp + jl] = p;
  }
  for (int e = tid; e < nj * kd; e += THREADS) {
    const int jl = e / kd, kk = e % kd, j = j0 + jl;
    kt[jl * kp + kk] = kf[jl * kp + kk] *
        expf(lz[len * lp + (PERCH ? kk : 0)] - lz[(j + 1) * lp + (PERCH ? kk : 0)]);
  }
  if (pre)
    for (int jl = tid; jl < nj; jl += THREADS) {
      float g = 0.f, d = 0.f;
      for (int kk = 0; kk < kd; ++kk)
        g = fmaf(qf[jl * kp + kk] * us[kk], kf[jl * kp + kk], g);
      for (int c = 0; c < vd; ++c)
        d = fmaf(yf[jl * vp + c], vf[jl * vp + c], d);
      dg[jl] = g;
      dd[jl] = d;
    }
  __syncthreads();

  // 3. dv = (k ⊙ e^{lc_L − lc})·dS_{c+1} + Σ_i s_ij dy_i [+ bonus]
  T* dv = static_cast<T*>(a.dv) + ((size_t)b * t_len * a.h + hh) * vd;
  T* dk = static_cast<T*>(a.dk) + ((size_t)b * t_len * a.h + hh) * kd;
  const int64_t v_st = (int64_t)a.h * vd, k_st = (int64_t)a.h * kd;
  const int64_t tj = t0 + j0;
  const int i_from = pre ? 1 : 0;
  for (int e = tid; e < nj * vd; e += THREADS) {
    const int jl = e / vd, c = e % vd;
    float acc = 0.f;
    for (int kk = 0; kk < kd; ++kk)
      acc = fmaf(kt[jl * kp + kk], dS[kk * vp + c], acc);
    for (int iq = jl + i_from; iq < nq; ++iq)
      acc = fmaf(sc[iq * sp + jl], yf[iq * vp + c], acc);
    if (pre) acc = fmaf(dg[jl], yf[jl * vp + c], acc);
    if (jl < rvalid) dv[(tj + jl) * v_st + c] = from_f32<T>(acc);
  }

  // 4. dk = e^{lc_L − lc_j}⊙(dS_{c+1}·v_j) + Σ_i dP_ij q_i ⊙ e^{lq_i − lc_j}
  //    [+ bonus]; k ⊙ dk without the bonus
  for (int e = tid; e < nj * kd; e += THREADS) {
    const int jl = e / kd, kk = e % kd, j = j0 + jl;
    float inter = 0.f;
    for (int c = 0; c < vd; ++c)
      inter = fmaf(dS[kk * vp + c], vf[jl * vp + c], inter);
    const float lcj = lz[(j + 1) * lp + (PERCH ? kk : 0)];
    float acc = expf(lz[len * lp + (PERCH ? kk : 0)] - lcj) * inter;
    if (PERCH) {
      for (int iq = jl + i_from; iq < nq; ++iq)
        acc = fmaf(dP[iq * sp + jl] * qf[iq * kp + kk],
                   expf(lz[(j0 + iq + qoff) * lp + kk] - lcj), acc);
    } else {
      for (int iq = jl + i_from; iq < nq; ++iq)
        acc = fmaf(dP[iq * sp + jl], qf[iq * kp + kk], acc);
    }
    br[jl * kp + kk] = kf[jl * kp + kk] * acc;
    if (pre) acc = fmaf(us[kk] * qf[jl * kp + kk], dd[jl], acc);
    if (jl < rvalid) dk[(tj + jl) * k_st + kk] = from_f32<T>(acc);
  }
  __syncthreads();

  // 5. d log_decay −= k ⊙ dk (its slot holds (1)'s q ⊙ dq)
  const int rows = min(nj, rvalid);
  if (PERCH) {
    float* dld = a.dld + ((size_t)b * t_len * a.h + hh) * kd;
    for (int e = tid; e < rows * kd; e += THREADS) {
      const int jl = e / kd, kk = e % kd;
      float* p = dld + (tj + jl) * k_st + kk;
      *p = *p - br[jl * kp + kk];
    }
  } else {
    float* dld = a.dld + (size_t)b * t_len * a.h + hh;
    for (int jl = tid; jl < rows; jl += THREADS) {
      float s = 0.f;
      for (int kk = 0; kk < kd; ++kk) s += br[jl * kp + kk];
      float* p = dld + (tj + jl) * a.h;
      *p = *p - s;
    }
  }
}

// ---------------------------------------------------------------------------
// (5) the decay's reverse sum, (6) d bonus
// ---------------------------------------------------------------------------

// d log_decay_t = Σ_{t' ≥ t} ∂/∂G_{t'}, in place: a block a (b, h, chunk),
// a thread a channel (scalar decay: one). The carry over every later
// chunk, ⟨dS_{c+1}, S_{c+1}⟩ (0 for the last chunk), then the chunk's
// slots summed from its last token back, each token's sum plus the carry.
__global__ void __launch_bounds__(MAX_KV) gla_bwd_decay_kernel(Args a,
                                                               int perch) {
  const int tid = threadIdx.x, bh = blockIdx.x, b = bh / a.h, hh = bh % a.h;
  const int64_t ch = blockIdx.y;
  const int kd = a.kd, vd = a.vd, w = perch ? kd : 1;
  if (tid >= w) return;
  float carry = 0.f;
  if (ch + 1 < a.n_chunks) {
    const size_t kv = (size_t)kd * vd;
    const float* g = a.ds + ((size_t)bh * a.n_chunks + ch) * kv;
    const float* sn = a.states + ((size_t)bh * a.n_chunks + ch + 1) * kv;
    for (int kk = perch ? tid : 0; kk < (perch ? tid + 1 : kd); ++kk)
      for (int c = 0; c < vd; ++c)
        carry = fmaf(g[kk * vd + c], sn[kk * vd + c], carry);
  }
  const int64_t t0 = ch * a.chunk;
  const int valid = (int)min((int64_t)a.chunk, a.t_len - t0);
  const int64_t st = (int64_t)a.h * w;
  float* p = a.dld + ((size_t)b * a.t_len * a.h + hh) * w + tid + t0 * st;
  float r = 0.f;
  for (int i = valid - 1; i >= 0; --i) {
    r += p[i * st];
    p[i * st] = r + carry;
  }
}

// d bonus (H, K): a thread an (h, channel), the tiles' partials summed
// over b, then over the tiles in sequence order
__global__ void __launch_bounds__(MAX_KV) gla_bwd_bonus_kernel(Args a) {
  const int kk = threadIdx.x, hh = blockIdx.x, kd = a.kd;
  if (kk >= kd) return;
  const int64_t n = a.n_chunks * a.tiles;
  float acc = 0.f;
  for (int b = 0; b < a.b; ++b) {
    const float* p = a.part + (size_t)(b * a.h + hh) * n * kd + kk;
    for (int64_t i = 0; i < n; ++i) acc += p[i * kd];
  }
  a.dbonus[(size_t)hh * kd + kk] = acc;
}

// the dynamic shared memory attribute of a kernel, per device: one bit
// per device it was set on, to the device's opt-in limit less the
// kernel's static shared memory
template <typename Kernel>
cudaError_t configure(Kernel kernel, uint64_t& configured, int* max_smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  const uint64_t bit = uint64_t(1) << dev;
  if (!(configured & bit)) {
    int optin = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    max_smem[dev] = optin - (int)attr.sharedSizeBytes;
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               max_smem[dev]);
    if (err != cudaSuccess) return err;
    configured |= bit;
  }
  return cudaSuccess;
}

template <typename T, int LT, bool PERCH>
int launch(const Args& a, cudaStream_t st) {
  static uint64_t dq_conf = 0, qc_conf = 0, dkv_conf = 0;
  static int dq_max[64], qc_max[64], dkv_max[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int kp = round_up(a.kd, 4) + 4, vp = round_up(a.vd, 4) + 4;
  const size_t dq_smem = DqSmem(LT, a.kd, a.vd, PERCH).bytes();
  const size_t dkv_smem = DkvSmem(LT, a.kd, a.vd, PERCH).bytes();
  const size_t qc_smem = sizeof(float) *
      ((size_t)LT * (kp + vp) + round_up((LT + 1) * (PERCH ? kp : 1), 4));
  err = configure(gla_bwd_dq_kernel<T, LT, PERCH>, dq_conf, dq_max);
  if (err == cudaSuccess)
    err = configure(gla_bwd_qc_kernel<T, LT, PERCH>, qc_conf, qc_max);
  if (err == cudaSuccess)
    err = configure(gla_bwd_dkv_kernel<T, LT, PERCH>, dkv_conf, dkv_max);
  if (err != cudaSuccess) return (int)err;
  if (dq_smem > (size_t)dq_max[dev] || qc_smem > (size_t)qc_max[dev] ||
      dkv_smem > (size_t)dkv_max[dev])
    return (int)cudaErrorInvalidValue;
  const unsigned bh = (unsigned)a.b * a.h;
  const dim3 tiled(bh, (unsigned)(a.n_chunks * a.tiles));
  const dim3 chunks(bh, (unsigned)a.n_chunks);
  gla_bwd_dq_kernel<T, LT, PERCH><<<tiled, THREADS, dq_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gla_bwd_qc_kernel<T, LT, PERCH><<<chunks, S_THREADS, qc_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gla_bwd_scan_kernel<<<bh, S_THREADS, 0, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gla_bwd_dkv_kernel<T, LT, PERCH><<<tiled, THREADS, dkv_smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  gla_bwd_decay_kernel<<<chunks, MAX_KV, 0, st>>>(a, PERCH ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (a.bonus) gla_bwd_bonus_kernel<<<a.h, MAX_KV, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool PERCH>
int dispatch_len(const Args& a, cudaStream_t st) {
  // RWKV6 chunks by 32, Mamba2 by its config's 128 (or a shorter T)
  if (a.chunk <= 32) return launch<T, 32, PERCH>(a, st);
  if (a.chunk <= 128) return launch<T, 128, PERCH>(a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One call: the six launches. `ws` holds B·H·⌈T/chunk⌉·K·V floats (Q_c,
// then dS), then B·H·⌈T/chunk⌉·K (the chunks' decays), then
// B·H·⌈T/chunk⌉·⌈chunk/32⌉·K (the bonus partials), none with an initial
// value; dq, dk, dv, dld contiguous.
extern "C" int gla_chunk_bwd_f32(
    const void* q, const void* k, const void* v, const void* dy,
    const float* ld, const float* bonus, const float* states, void* dq,
    void* dk, void* dv, float* dld, float* dbonus, float* ws, int bf16,
    int per_channel, int64_t b, int64_t t_len, int64_t h, int64_t kd,
    int64_t vd, int64_t chunk, const int64_t* q_strides,
    const int64_t* k_strides, const int64_t* v_strides,
    const int64_t* y_strides, const int64_t* l_strides, void* stream) {
  if (kd < 1 || kd > MAX_KV || vd < 1 || vd > MAX_KV || chunk < 1 ||
      chunk > 128 || b < 1 || h < 1 || t_len < 1 || b * h > INT32_MAX ||
      (t_len + chunk - 1) / chunk * ((chunk + QR - 1) / QR) > 65535)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q; a.k = k; a.v = v; a.dy = dy; a.ld = ld; a.bonus = bonus;
  a.states = states; a.dq = dq; a.dk = dk; a.dv = dv; a.dld = dld;
  a.dbonus = dbonus;
  a.t_len = t_len; a.n_chunks = (t_len + chunk - 1) / chunk;
  a.b = (int)b; a.h = (int)h; a.kd = (int)kd; a.vd = (int)vd;
  a.chunk = (int)chunk; a.tiles = (int)((chunk + QR - 1) / QR);
  const size_t n_chunks = (size_t)(b * h) * a.n_chunks;
  a.ds = ws;
  a.dc = ws + n_chunks * kd * vd;
  a.part = a.dc + n_chunks * kd;
  a.q_sb = q_strides[0]; a.q_st = q_strides[1]; a.q_sh = q_strides[2];
  a.k_sb = k_strides[0]; a.k_st = k_strides[1]; a.k_sh = k_strides[2];
  a.v_sb = v_strides[0]; a.v_st = v_strides[1]; a.v_sh = v_strides[2];
  a.y_sb = y_strides[0]; a.y_st = y_strides[1]; a.y_sh = y_strides[2];
  a.l_sb = l_strides[0]; a.l_st = l_strides[1]; a.l_sh = l_strides[2];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return per_channel ? dispatch_len<__nv_bfloat16, true>(a, st)
                       : dispatch_len<__nv_bfloat16, false>(a, st);
  return per_channel ? dispatch_len<float, true>(a, st)
                     : dispatch_len<float, false>(a, st);
}
