// Primal-only collapsed decode, var-major output, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepphysinet_tpu/ops/decode_kernel.py::
// _decode_kernel_v4_primal (called through decode_primal_v4t).  Per point n
// and output variable v (FusedDecodeWeights, collapsed v4 algebra):
//
//   p   = relu(pe[n] . w1[v] + b1[v])                       [HID], f32
//   r   = T(p) . w2f1[v] + cd[n] . wdf1[v] + rbias[v]       [HID], f32
//   out = sum(relu(r) * fw2[v]) + 2 (sum(p * w2wo[v]) + sum(cd[n] * wdwo[v]))
//         + obias[v] + ref_t[v, n]
//
// with the TPU kernel's rounding points: matmul inputs in the compute type T
// (bf16 for the flagship, float for parity runs), products accumulated in
// f32, p kept in f32 for the w2wo sum and rounded to T only as the w2f1
// product's input (decode_kernel.py:986-996).
//
// What bounds it: 1.97 MFLOP per point (6 variables x 163,840 MACs) against
// about 800 bytes of point I/O, so it is compute bound; this first version
// runs the products on the CUDA cores (FMA), not the tensor cores.  Design:
// each block owns NB = 64 points and computes all six variables for them, so
// blocks are independent and no cross-block reduction exists.  The block's
// pe / cd rows and p [NB, HID] stay in shared memory between the two stages;
// the weights (1.9 MB in bf16 for all six variables, resident in L2) are
// streamed through shared memory in KT-row tiles.  Each of the 256 threads
// holds an 8 x 8 accumulator tile (rows ty*8.., columns tx + 32c); relu(r) is
// folded into the output sums in registers, so r is never stored.  The ragged
// last block is masked here (zero rows in, no stores out) instead of padding
// N on the host.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HID = 256;     // hidden width; the wrapper checks it
constexpr int NB = 64;       // points per block
constexpr int KT = 32;       // weight rows per shared-memory tile
constexpr int THREADS = 256;
constexpr int TM = 8;        // accumulator rows per thread
constexpr int TN = 8;        // accumulator columns per thread, strided by 32

static_assert(THREADS / 32 * TM == NB, "one warp per TM rows");
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

// acc += A[block rows, 0:K] . W[0:K, 0:HID].  A lives in shared memory (row
// stride lda, element type TA, rounded to T as it is read); W [K, HID] of T
// lives in global memory and is staged through Ws one KT-row tile at a time.
// The barrier at the top of each tile also publishes the caller's shared
// writes and protects Ws and A from the previous stage's readers.
template <typename T, typename TA>
__device__ __forceinline__ void block_gemm(const TA* As, int lda, const T* __restrict__ W,
                                           int K, T* Ws, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  constexpr int NVEC = KT * HID * (int)sizeof(T) / 16;
  for (int k0 = 0; k0 < K; k0 += KT) {
    __syncthreads();
    const uint4* src = reinterpret_cast<const uint4*>(W + (size_t)k0 * HID);
    uint4* dst = reinterpret_cast<uint4*>(Ws);
    for (int i = tid; i < NVEC; i += THREADS) dst[i] = src[i];
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

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
decode_primal_kernel(const T* __restrict__ pe, const T* __restrict__ cd,
                     const float* __restrict__ ref_t, const T* __restrict__ w1,
                     const float* __restrict__ b1, const T* __restrict__ w2f1,
                     const T* __restrict__ wdf1, const float* __restrict__ rbias,
                     const float* __restrict__ fw2, const float* __restrict__ w2wo,
                     const float* __restrict__ wdwo, const float* __restrict__ obias,
                     float* __restrict__ out, int64_t n, int in_ch, int n_vars) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);                  // [NB, HID]
  T* Ws = reinterpret_cast<T*>(p_s + NB * HID);                  // [KT, HID]
  T* pe_s = Ws + KT * HID;                                       // [NB, in_ch]
  T* cd_s = pe_s + NB * in_ch;                                   // [NB, in_ch]

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int64_t n0 = (int64_t)blockIdx.x * NB;

  // this block's input rows; rows past n are zero and never stored
  const T zero = from_f32<T>(0.0f);
  for (int i = tid; i < NB * in_ch; i += THREADS) {
    const int row = i / in_ch;
    const bool live = n0 + row < n;
    const size_t g = (size_t)n0 * in_ch + i;
    pe_s[i] = live ? pe[g] : zero;
    cd_s[i] = live ? cd[g] : zero;
  }

  for (int v = 0; v < n_vars; ++v) {
    float acc[TM][TN];
    // stage 1: p = relu(pe . w1 + b1), kept in shared memory in f32
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
    block_gemm<T, T>(pe_s, in_ch, w1 + (size_t)v * in_ch * HID, in_ch, Ws, acc);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const float bias = b1[v * HID + tx + 32 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        p_s[(ty * TM + r) * HID + tx + 32 * c] = fmaxf(acc[r][c] + bias, 0.0f);
    }

    // stage 2: r = T(p) . w2f1 + cd . wdf1 (+ rbias below)
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
    block_gemm<T, float>(p_s, HID, w2f1 + (size_t)v * HID * HID, HID, Ws, acc);
    block_gemm<T, T>(cd_s, in_ch, wdf1 + (size_t)v * in_ch * HID, in_ch, Ws, acc);

    // epilogue: the three lane reductions; every value read below was
    // written by this thread (p_s) or was published by the gemms' barriers
    float s_r[TM], s_p[TM], s_c[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) s_r[r] = s_p[r] = s_c[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx + 32 * c;
      const float rb = rbias[v * HID + col], f = fw2[v * HID + col], wo = w2wo[v * HID + col];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        s_r[r] = fmaf(fmaxf(acc[r][c] + rb, 0.0f), f, s_r[r]);
        s_p[r] = fmaf(p_s[(ty * TM + r) * HID + col], wo, s_p[r]);
      }
    }
    for (int k = tx; k < in_ch; k += 32) {
      const float wd = wdwo[v * in_ch + k];
#pragma unroll
      for (int r = 0; r < TM; ++r) s_c[r] = fmaf(to_f32(cd_s[(ty * TM + r) * in_ch + k]), wd, s_c[r]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      s_r[r] = warp_sum(s_r[r]);
      s_p[r] = warp_sum(s_p[r]);
      s_c[r] = warp_sum(s_c[r]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t point = n0 + ty * TM + r;
      if (tx == r && point < n) {
        const int64_t o = (int64_t)v * n + point;
        out[o] = s_r[r] + 2.0f * (s_p[r] + s_c[r]) + obias[v] + ref_t[o];
      }
    }
  }
}

template <typename T>
int launch(const void* pe, const void* cd, const float* ref_t, const void* w1,
           const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
           const float* fw2, const float* w2wo, const float* wdwo, const float* obias,
           float* out, int64_t n, int in_ch, int n_vars, cudaStream_t stream) {
  const size_t smem = (size_t)NB * HID * sizeof(float) + (size_t)KT * HID * sizeof(T) +
                      2 * (size_t)NB * in_ch * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(decode_primal_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + NB - 1) / NB);
  decode_primal_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(pe), static_cast<const T*>(cd), ref_t, static_cast<const T*>(w1),
      b1, static_cast<const T*>(w2f1), static_cast<const T*>(wdf1), rbias, fw2, w2wo, wdwo,
      obias, out, n, in_ch, n_vars);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Hidden width, points per block and tile depth the kernel was built for.
int dpn_decode_primal_hid() { return HID; }
int dpn_decode_primal_k_tile() { return KT; }
int dpn_decode_primal_block() { return NB; }

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  Returns cudaGetLastError()
// after the launch (0 on success).
int dpn_decode_primal_v4t(int is_bf16, const void* pe, const void* cd, const float* ref_t,
                          const void* w1, const float* b1, const void* w2f1, const void* wdf1,
                          const float* rbias, const float* fw2, const float* w2wo,
                          const float* wdwo, const float* obias, float* out, int64_t n,
                          int in_ch, int n_vars, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(pe, cd, ref_t, w1, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo,
                                 obias, out, n, in_ch, n_vars, s);
  return launch<float>(pe, cd, ref_t, w1, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, out,
                       n, in_ch, n_vars, s);
}

}  // extern "C"
