// Shared device code of the jvp decode kernels (decode_jvp_v4s.cu,
// decode_bwd_v4s.cu, decode_jvp_v4.cu, decode_bwd_v4.cu, decode_jvp_v2.cu and
// residual_sums.cu):
// type conversion with the TPU kernels' rounding rule, a block-level matrix
// product on the CUDA cores, the block's input rows, the forward chain of one
// variable (primal_stages, tangent_stage), and the backward kernels'
// contraction of the point axis with its atomic add into global memory.
// attention.cu and encoder.cu take the conversions and copy_vectors.
//
// Rounding rule (deepphysinet_tpu/ops/decode_kernel.py, every `dot`): both
// operands of a product are rounded to the compute type T (bf16 for the
// flagship, float for parity runs), the products are summed in f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpn {

constexpr int HID = 256;     // hidden width; the wrappers check it
constexpr int KT = 32;       // weight rows per shared-memory tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = 8;        // accumulator columns per thread, strided by 32

static_assert(32 * TN == HID, "one lane per column of each 32-column group");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Value of x after a round trip through T (round to nearest even, as XLA's
// and PyTorch's float32 -> bfloat16 conversion).
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A block copies n 16-byte vectors: load(i) -> uint4, then store(i, v), CHUNK vectors a
// thread at a time with all CHUNK loads issued before the first store, so that their
// latencies overlap instead of adding up.
template <int CHUNK, typename Load, typename Store>
__device__ __forceinline__ void copy_vectors(int n, Load load, Store store) {
  for (int base = threadIdx.x; base < n; base += CHUNK * blockDim.x) {
    uint4 buf[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) buf[u] = load(i);
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int i = base + u * blockDim.x;
      if (i < n) store(i, buf[u]);
    }
  }
}

// The VEC = 16 / sizeof(T) values of T in a 16-byte vector, as float.
template <typename T, int VEC = 16 / sizeof(T)>
__device__ __forceinline__ void unpack(const uint4& v, float (&out)[VEC]) {
  const T* p = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int j = 0; j < VEC; ++j) out[j] = to_f32(p[j]);
}

// Register tile of the row-times-weight products ("gemm layout"): thread
// (tx = lane, ty = warp) holds rows ty*TM + r and columns tx + 32*c.
template <int TM> __device__ __forceinline__ void zero_tile(float (&acc)[TM][TN]) {
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
}

// acc += A[block rows, 0:K] . W[0:K, 0:HID].  A lives in shared memory (row
// stride lda, element type TA, rounded to T as it is read); W [K, HID] of T
// lives in global memory and is staged through Ws one KT-row tile at a time.
// The barrier at the top of each tile also publishes the caller's shared
// writes and protects Ws and A from the previous stage's readers.
// With WT, W [HID, K] is read transposed: acc += A . W^T, each tile gathered column by column.
template <typename T, typename TA, int TM, bool WT = false>
__device__ __forceinline__ void block_gemm(const TA* As, int lda, const T* __restrict__ W,
                                           int K, T* Ws, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  constexpr int NVEC = KT * HID * (int)sizeof(T) / 16;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    if constexpr (WT) {
      for (int i = tid; i < KT * HID; i += THREADS) {
        const int col = i / KT, kk = i - col * KT;
        Ws[kk * HID + col] = W[(size_t)col * K + k0 + kk];
      }
    } else {
      const uint4* src = reinterpret_cast<const uint4*>(W + (size_t)k0 * HID);
      uint4* dst = reinterpret_cast<uint4*>(Ws);
      for (int i = tid; i < NVEC; i += THREADS) dst[i] = src[i];
    }
    __syncthreads();
#pragma unroll 2
    for (int kk = 0; kk < KT; ++kk) {
      float a[TM], w[TN];
#pragma unroll
      for (int r = 0; r < TM; ++r) a[r] = round_to<T>(to_f32(As[(ty * TM + r) * lda + k0 + kk]));
#pragma unroll
      for (int c = 0; c < TN; ++c) w[c] = to_f32(Ws[kk * HID + tx + 32 * c]);
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], w[c], acc[r][c]);
    }
  }
}

// The block's rows of the two point inputs; rows past n are zero.
template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ pe, const T* __restrict__ cd,
                                          T* pe_s, T* cd_s, int64_t n0, int64_t n, int nb,
                                          int in_ch) {
  const T zero = from_f32<T>(0.0f);
  for (int i = threadIdx.x; i < nb * in_ch; i += THREADS) {
    const bool live = n0 + i / in_ch < n;
    const size_t g = (size_t)n0 * in_ch + i;
    pe_s[i] = live ? pe[g] : zero;
    cd_s[i] = live ? cd[g] : zero;
  }
}

// The same for a direction-major operand trig [3, n, two_f] (the v6 kernels'):
// the block's rows land channel-major, pe_s[row, k * two_f + j] = trig[k, n0 + row, j],
// which is the row of the v4s operand, so everything after the load is shared.
template <typename T>
__device__ __forceinline__ void load_rows_dm(const T* __restrict__ trig, const T* __restrict__ cd,
                                             T* pe_s, T* cd_s, int64_t n0, int64_t n, int nb,
                                             int in_ch) {
  const T zero = from_f32<T>(0.0f);
  const int two_f = in_ch / 3;
  for (int i = threadIdx.x; i < nb * in_ch; i += THREADS) {
    const int row = i / in_ch, col = i - row * in_ch;
    const int k = col / two_f, j = col - k * two_f;
    const bool live = n0 + row < n;
    pe_s[i] = live ? trig[((size_t)k * n + n0 + row) * two_f + j] : zero;
    cd_s[i] = live ? cd[(size_t)n0 * in_ch + i] : zero;
  }
}

// Offset of (point, v) in a primal-shaped array and of (k, point, v) in a
// tangent-shaped one: var-major [V, N] / [3, V, N] or point-major [N, V] / [3, N, V].
__device__ __forceinline__ int64_t primal_at(bool t_layout, int64_t point, int v, int64_t n,
                                             int n_vars) {
  return t_layout ? (int64_t)v * n + point : point * n_vars + v;
}
__device__ __forceinline__ int64_t tangent_at(bool t_layout, int k, int64_t point, int v,
                                              int64_t n, int n_vars) {
  return t_layout ? ((int64_t)k * n_vars + v) * n + point : ((int64_t)k * n + point) * n_vars + v;
}

// ---- forward kernels: one variable's chain for the block's points ------------
//
// Both functions work on the block's NB = WARPS * TM points with the thread
// layout of block_gemm; every weight pointer is already offset to the variable.
// The two relu masks live in registers as bits of the thread's own TM x TN tile
// (the tangent products land on the same tile positions as z and r).  p is kept
// in shared memory (p_s, [NB, HID] f32) only until r is done; one direction's
// tangent block (t_s, [NB, HID] of T) then reuses that space.  Barriers: every
// block_gemm starts each tile with one, which publishes the shared writes made
// before the call and protects p_s / t_s / Ws from the previous product's readers.

// Stages 1 and 2:  z = pe . w1 + b1,  p = relu(z) (f32),
// r = T(p) . w2f1 + cd . wdf1 + rbias, and per point
// o = sum(relu(r) * fw2) + 2 (sum(p * w2wo) + sum(cd * wdwo)), in every lane of
// the point's warp.  The caller adds obias and the reference value.  r is summed as
// (T(p) . w2f1 + cd . wdf1) + rbias in one accumulator, or with SPLIT as v5 sums it,
// T(p) . w2f1 + (cd . wdf1 + rbias), cd . wdf1 in an accumulator of its own.
template <typename T, int TM, bool SPLIT = false>
__device__ __forceinline__ void primal_stages(
    const T* pe_s, int lda, int k1, const T* __restrict__ w1, const T* cd_s, int in_ch,
    const float* __restrict__ b1, const T* __restrict__ w2f1, const T* __restrict__ wdf1,
    const float* __restrict__ rbias, const float* __restrict__ fw2,
    const float* __restrict__ w2wo, const float* __restrict__ wdwo, float* p_s, T* Ws,
    uint32_t (&mask)[TM], uint32_t (&maskr)[TM], float (&o)[TM]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[TM][TN];

  // stage 1: p = relu(pe . w1 + b1) in shared memory (f32); sum(p * w2wo)
  float s_p[TM];
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(pe_s, lda, w1, k1, Ws, acc);
#pragma unroll
  for (int r = 0; r < TM; ++r) { mask[r] = 0u; s_p[r] = 0.0f; }
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float bias = b1[col], wo = w2wo[col];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float z = acc[r][c] + bias;
      if (z > 0.0f) mask[r] |= 1u << c;
      const float p = fmaxf(z, 0.0f);
      p_s[(ty * TM + r) * HID + col] = p;
      s_p[r] = fmaf(p, wo, s_p[r]);
    }
  }

  // stage 2: r = T(p) . w2f1 + cd . wdf1 + rbias
  float acc_cd[TM][TN];  // SPLIT only
  zero_tile<TM>(acc);
  block_gemm<T, float, TM>(p_s, HID, w2f1, HID, Ws, acc);
  if constexpr (SPLIT) {
    zero_tile<TM>(acc_cd);
    block_gemm<T, T, TM>(cd_s, in_ch, wdf1, in_ch, Ws, acc_cd);
  } else {
    block_gemm<T, T, TM>(cd_s, in_ch, wdf1, in_ch, Ws, acc);
  }
  float s_r[TM], s_c[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) { maskr[r] = 0u; s_r[r] = s_c[r] = 0.0f; }
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float rb = rbias[col], f = fw2[col];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float rv = SPLIT ? acc[r][c] + (acc_cd[r][c] + rb) : acc[r][c] + rb;
      if (rv > 0.0f) maskr[r] |= 1u << c;
      s_r[r] = fmaf(fmaxf(rv, 0.0f), f, s_r[r]);
    }
  }
  for (int k = tx; k < in_ch; k += 32) {
    const float wd = wdwo[k];
#pragma unroll
    for (int r = 0; r < TM; ++r) s_c[r] = fmaf(to_f32(cd_s[(ty * TM + r) * in_ch + k]), wd, s_c[r]);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r)
    o[r] = warp_sum(s_r[r]) + 2.0f * (warp_sum(s_p[r]) + warp_sum(s_c[r]));
}

// One direction's tangent:  t = T(1[z > 0] * (tin . w1k)) -> shared (over p_s),
// to = sum(1[r > 0] * (t . w2f1) * fw2) + 2 sum(t * w2wo) per point, in every
// lane of the point's warp.  tin_s [NB, kt] (row stride ldt) is the direction's
// tangent operand and w1k [kt, HID] its layer-1 rows.
template <typename T, int TM>
__device__ __forceinline__ void tangent_stage(
    const T* tin_s, int ldt, int kt, const T* __restrict__ w1k, const T* __restrict__ w2f1,
    const float* __restrict__ fw2, const float* __restrict__ w2wo, T* t_s, T* Ws,
    const uint32_t (&mask)[TM], const uint32_t (&maskr)[TM], float (&to)[TM]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  float acc[TM][TN];
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(tin_s, ldt, w1k, kt, Ws, acc);
  float s_t[TM], s_tr[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) s_t[r] = s_tr[r] = 0.0f;
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float wo = w2wo[col];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const T t16 = from_f32<T>((mask[r] >> c) & 1u ? acc[r][c] : 0.0f);
      t_s[(ty * TM + r) * HID + col] = t16;
      s_t[r] = fmaf(to_f32(t16), wo, s_t[r]);
    }
  }
  // 1[r > 0] * (t . w2f1), reduced against fw2
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(t_s, HID, w2f1, HID, Ws, acc);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const float f = fw2[tx + 32 * c];
#pragma unroll
    for (int r = 0; r < TM; ++r)
      if ((maskr[r] >> c) & 1u) s_tr[r] = fmaf(acc[r][c], f, s_tr[r]);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) to[r] = warp_sum(s_tr[r]) + 2.0f * warp_sum(s_t[r]);
}

// ---- backward kernels: sums over the block's points -------------------------

__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);  // bf16 is the top half of an f32
  o[0] = __uint_as_float(v.x << 16); o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16); o[3] = __uint_as_float(v.y & 0xffff0000u);
}

// out[0:4] += v[0:4] in global memory; out is 16-byte aligned.
__device__ __forceinline__ void global_add4(float* out, const float* v) {
  atomicAdd(reinterpret_cast<float4*>(out), make_float4(v[0], v[1], v[2], v[3]));
}

// out[0:rows, 0:HID] += A[0:nb, 0:rows]^T . G[0:nb, 0:HID], contracting the
// block's points.  A (row stride lda, rounded to T as it is read) and G (of T)
// live in shared memory; out [rows, HID] lives in global memory; rows is a
// multiple of 64.  Per pass of 64 output rows, thread (tx, ty) sums rows
// ty*8 + r and columns tx*4 + q and 128 + tx*4 + q over the points, then adds
// its tile into out.  Reads shared memory only: the caller's barriers publish
// A and G before and protect them after.
template <typename T, typename TA>
__device__ __forceinline__ void point_contraction(const TA* As, int lda, int rows, const T* Gs,
                                                  int nb, float* __restrict__ out) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  for (int i0 = 0; i0 < rows; i0 += 64) {
    float acc[8][8];
    zero_tile<8>(acc);
#pragma unroll 2
    for (int pnt = 0; pnt < nb; ++pnt) {
      float a[8], g[8];
      load4(As + pnt * lda + i0 + ty * 8, a);
      load4(As + pnt * lda + i0 + ty * 8 + 4, a + 4);
      load4(Gs + pnt * HID + tx * 4, g);
      load4(Gs + pnt * HID + 128 + tx * 4, g + 4);
#pragma unroll
      for (int r = 0; r < 8; ++r) a[r] = round_to<T>(a[r]);
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], g[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* row = out + (size_t)(i0 + ty * 8 + r) * HID + tx * 4;
      global_add4(row, &acc[r][0]);
      global_add4(row + 128, &acc[r][4]);
    }
  }
}

}  // namespace dpn
