// Multi-head softmax attention for Hopper (sm_90a): the single-tile kernel and the
// flash kernel of deepphysinet_tpu/ops/attention.py, as one template.
//
// Replaces two TPU kernels:
//
// * _attn_kernel / _attention_pallas (:48-92), FLASH = false: exact softmax over all
//   L keys, a = T(e / sum(e)), out = T(sum a v).  On the TPU one (batch, head) tile
//   holds the whole [L, L] score matrix in VMEM.  Here a block owns 64 query rows,
//   and at L = 1,024 their f32 scores alone (256 KB) exceed a block's 227 KB, so the
//   kernel takes two passes over the keys: the first keeps each row's running max
//   and sum (the sum rescaled when the max grows), the second recomputes the scores,
//   normalises them with the final max and sum and adds a . v.  Any L runs.
// * _flash_kernel / _attention_flash (:95-167), FLASH = true: online softmax.  The
//   TPU grid's sequential key axis becomes a loop inside the block; m, l and the
//   output sum of the block's rows stay in shared memory and registers.  Per key
//   block p = exp(s - m_cur) is rounded to T for the product and l sums the
//   unrounded p, as on the TPU, so the key block must be the TPU kernel's: 256.
//
// Rounding: q, k, v, out in T (bf16 or float); products of two T values summed in
// f32 (exact products for bf16); scores, softmax and the output sums in f32.
//
// What bounds it: 4 L^2 E flops per (batch, head) against 8 L E bytes (bf16), so the
// flagship's L = 287, E = 32 is bytes-bound on paper (0.59 MB, about 0.2 us) and,
// at 8 heads, launch-bound in practice; at L = 4,096 the operations bound it (17.2
// GFLOP).  This first version runs the products on the CUDA cores (FMA).  Design: a
// block of 256 threads owns (batch x head, 64 query rows) and walks the keys in
// blocks of 256; the block's q rows, one key block of k and v, and the [64, 256]
// f32 score tile live in shared memory (rows padded by one float so that threads
// reading different rows hit different banks); each thread holds a 4 x 16 tile of
// the scores and a 4 x E/16 tile of the output.  Masked keys past L get -inf scores
// (weight 0) and their rows of v are not read; query rows past L are zeros in and
// are not stored.

#include "decode_common.cuh"

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 256;      // keys per block: the TPU flash kernel's block_k
constexpr int THREADS = 256; // 16 x 16 thread grid over the score tile
constexpr int SK = BK + 1;   // row stride of the score tile

template <int E> constexpr size_t smem_bytes() {
  // q [BQ, E+1], k [BK, E+1], v [BK, E], scores [BQ, SK], m, l and alpha [BQ]
  return sizeof(float) * ((size_t)BQ * (E + 1) + (size_t)BK * (E + 1) + (size_t)BK * E +
                          (size_t)BQ * SK + 3 * BQ);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Rows r0 .. r0 + n - 1 of head h of batch item b, [B, L, H, E] in global memory,
// as float into dst (row stride ld); rows past L are zeros.  16-byte loads, eight a
// thread in flight.
template <typename T, int E>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, float* dst, int ld, int b,
                                          int h, int r0, int n, int L, int H) {
  constexpr int VEC = 16 / sizeof(T), PER_ROW = E / VEC;
  dpn::copy_vectors<8>(
      n * PER_ROW,
      [&](int i) {
        const int s = r0 + i / PER_ROW;
        return s < L ? *reinterpret_cast<const uint4*>(src + (((size_t)b * L + s) * H + h) * E +
                                                        (i % PER_ROW) * VEC)
                     : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int i, const uint4& v) {
        float f[VEC];
        dpn::unpack<T>(v, f);
        float* d = dst + (i / PER_ROW) * ld + (i % PER_ROW) * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) d[j] = f[j];
      });
}

// S[r][c] = (q[r] . k[c]) * scale for the block's rows and the key block's keys;
// -inf for keys at or past nkeys.  Thread (tx, ty) owns rows ty + 16 i, keys tx + 16 j.
template <int E>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks, float* S, float scale,
                                           int nkeys) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][BK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    float qv[4], kv[BK / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (E + 1) + e];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) kv[j] = Ks[(tx + 16 * j) * (E + 1) + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const int c = tx + 16 * j;
      S[(ty + 16 * i) * SK + c] = c < nkeys ? acc[i][j] * scale : -INFINITY;
    }
}

// One warp per row of S: the running max m and sum l over the keys so far, the sum
// rescaled by alpha = exp(m_old - m_new).  With keep_p, S holds p = exp(s - m_new)
// afterwards and alpha goes to a_s (the flash kernel's step).
__device__ __forceinline__ void update_rows(float* S, float* m_s, float* l_s, float* a_s,
                                            bool keep_p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* row = S + r * SK;
    float mx = -INFINITY;
    for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, row[c]);
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, warp_max(mx));
    float sum = 0.0f;
    for (int c = lane; c < BK; c += 32) {
      const float p = expf(row[c] - m_new);
      if (keep_p) row[c] = p;
      sum += p;
    }
    sum = dpn::warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
  }
}

// The single-tile kernel's second pass: S holds a = exp(s - m) / l with the final m, l.
__device__ __forceinline__ void normalise_rows(float* S, const float* m_s, const float* l_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* row = S + r * SK;
    const float m = m_s[r], l = l_s[r];
    for (int c = lane; c < BK; c += 32) row[c] = expf(row[c] - m) / l;
  }
}

template <typename T, int E, bool FLASH>
__global__ void __launch_bounds__(THREADS, 1)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int L, int H, float scale) {
  constexpr int EJ = E / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ, E + 1]
  float* Ks = Qs + BQ * (E + 1);    // [BK, E + 1]
  float* Vs = Ks + BK * (E + 1);    // [BK, E]
  float* S = Vs + BK * E;           // [BQ, SK]
  float* m_s = S + BQ * SK;         // [BQ]
  float* l_s = m_s + BQ;            // [BQ]
  float* a_s = l_s + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * BQ;
  const int n_kb = (L + BK - 1) / BK;

  load_rows<T, E>(q, Qs, E + 1, b, h, q0, BQ, L, H);
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }

  if (!FLASH) {  // pass 1: each row's max and sum over all keys
    for (int kb = 0; kb < n_kb; ++kb) {
      const int k0 = kb * BK, nkeys = min(BK, L - k0);
      __syncthreads();
      load_rows<T, E>(k, Ks, E + 1, b, h, k0, BK, L, H);
      __syncthreads();
      score_tile<E>(Qs, Ks, S, scale, nkeys);
      __syncthreads();
      update_rows(S, m_s, l_s, a_s, false);
    }
  }

  float acc[4][EJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < EJ; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK, nkeys = min(BK, L - k0);
    __syncthreads();
    load_rows<T, E>(k, Ks, E + 1, b, h, k0, BK, L, H);
    load_rows<T, E>(v, Vs, E, b, h, k0, nkeys, L, H);
    __syncthreads();
    score_tile<E>(Qs, Ks, S, scale, nkeys);
    __syncthreads();
    if (FLASH)
      update_rows(S, m_s, l_s, a_s, true);
    else
      normalise_rows(S, m_s, l_s);
    __syncthreads();
    // this key block's T(p) . v, summed on its own and then combined (acc * alpha + pv)
    float pv[4][EJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < EJ; ++j) pv[i][j] = 0.0f;
    for (int c = 0; c < nkeys; ++c) {
      float pp[4], vv[EJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = dpn::round_to<T>(S[(ty + 16 * i) * SK + c]);
#pragma unroll
      for (int j = 0; j < EJ; ++j) vv[j] = Vs[c * E + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < EJ; ++j) pv[i][j] = fmaf(pp[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = FLASH ? a_s[ty + 16 * i] : 1.0f;
#pragma unroll
      for (int j = 0; j < EJ; ++j) acc[i][j] = FLASH ? acc[i][j] * alpha + pv[i][j] : acc[i][j] + pv[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= L) continue;
    const float l = FLASH ? l_s[r] : 1.0f;
#pragma unroll
    for (int j = 0; j < EJ; ++j)
      out[(((size_t)b * L + s) * H + h) * E + tx + 16 * j] =
          dpn::from_f32<T>(FLASH ? acc[i][j] / l : acc[i][j]);
  }
}

template <typename T, int E, bool FLASH>
int launch(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<E>();
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T, E, FLASH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  attention_kernel<T, E, FLASH><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), L, H, scale);
  return (int)cudaGetLastError();
}

template <typename T, int E>
int launch_e(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
             float scale, int flash, cudaStream_t stream) {
  return flash ? launch<T, E, true>(q, k, v, out, B, L, H, scale, stream)
               : launch<T, E, false>(q, k, v, out, B, L, H, scale, stream);
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* out, int B, int L, int H, int E,
             float scale, int flash, cudaStream_t stream) {
  switch (E) {
    case 16: return launch_e<T, 16>(q, k, v, out, B, L, H, scale, flash, stream);
    case 32: return launch_e<T, 32>(q, k, v, out, B, L, H, scale, flash, stream);
    case 64: return launch_e<T, 64>(q, k, v, out, B, L, H, scale, flash, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int dpn_attention_supports_head_dim(int e) { return e == 16 || e == 32 || e == 64; }

// is_bf16: 1 for __nv_bfloat16 q, k, v, out, 0 for float; all [B, L, H, E] contiguous.
// flash: 1 for the flash kernel, 0 for the single-tile kernel.  Returns
// cudaGetLastError() after the launch (0 on success).
int dpn_attention(int is_bf16, const void* q, const void* k, const void* v, void* out, int B,
                  int L, int H, int E, float scale, int flash, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_t<__nv_bfloat16>(q, k, v, out, B, L, H, E, scale, flash, s);
  return launch_t<float>(q, k, v, out, B, L, H, E, scale, flash, s);
}

}  // extern "C"
