// v4s and v6 collapsed decode, backward: cotangents of the nine fused weights,
// summed over all points, for Hopper (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/decode_kernel.py that share
// their algebra and their fused weights: _decode_bwd_kernel_v4s (called through
// decode_bwd_kernel_v4s; v6 = 0 here: pe [n, 3 * two_f] channel-major rows,
// cotangents [n_vars, n] and [3, n_vars, n]) and _decode_bwd_kernel_v6
// (decode_bwd_kernel_v6; v6 = 1: trig [3, n, two_f] direction-major, cotangents
// [n, n_vars] and [3, n, n_vars]).  The v6 operand is gathered into the
// channel-major row as it is loaded, and gw1g [n_vars, 3, two_f, HID] has the
// memory of [n_vars, 3 * two_f, HID], so the two forms share everything after the
// loads: g_w1g[v, k] = trig_k^T g_z is rows k * two_f : (k + 1) * two_f of pe^T g_z.
// Per block of points and variable v the kernel recomputes the forward chain (no
// activations are saved by the forward) and forms, with go = g_primal[v],
// gto_k = g_tang[k, v] as per-point columns, a = fw2[v], b = w2wo[v], W = w2f1[v]:
//
//   z, p, t_k, r, pr, tr_k        as the forward; t_k stays f32 here and is
//                                 rounded only as a product's input (:2560-2568,
//                                 :2162-2164), where the forward kernels round it
//   g_rp  = 1[r > 0] go a         g_rt_k = 1[r > 0] gto_k a
//   gfw2  += sum_n pr go + sum_k sum_n tr_k gto_k
//   gw2wo += 2 (sum_n p go + sum_k sum_n t_k gto_k)
//   gwdwo += 2 sum_n cd go        grbias += sum_n g_rp
//   gw2f1 += p^T g_rp + sum_k t_k^T g_rt_k       gwdf1 += cd^T g_rp
//   g_z   = 1[z > 0] (g_rp W^T + 2 go b)   g_tz_k = 1[z > 0] (g_rt_k W^T + 2 gto_k b)
//   gw1g  += pe^T g_z             gb1 += sum_n g_z
//   gw1t[k] += pe[:, block k]^T g_tz_k
//
// Every operand of every product is rounded to the compute type T first, also
// g_rp, g_rt, g_z and g_tz; sums are f32.  g_obias = sum_n go is left to the
// caller, as on the TPU.
//
// What bounds it: 12.98 MFLOP per point (6 variables x 1,081,344 MACs) against about 900 bytes
// of point input, so it is compute bound.  Where the card differs from the TPU: there the grid is
// a sequential loop that adds into accumulators resident in fast memory; here blocks run
// concurrently, and one variable's accumulators (gw2f1 256 x 256, gwdf1 and gw1g 192 x 256, gw1t
// 3 x 64 x 256: 852 KB of f32) fit neither a block's registers nor its shared memory next to the
// block's working set.  A block owns NB = 64 points and ONE variable (grid = blocks x variables);
// each product that contracts the point axis is summed over the block's points and then added
// into the zero-initialised output in global memory with float4 atomic adds.  The order in which
// blocks add is not fixed, so the result is not bit-reproducible from run to run; it is compared
// with the plain version by tolerance.
//
// bf16 (decode_bwd_v4s_tc, the flagship's type): the tensor-core body of decode_bwd_tc.cuh
// (its header gives the design, the shared-memory budget and the atomic traffic), which
// decode_bwd_v4.cu shares with a dpe input; the v4s / v6 rows come through jvp::RowSource.
//
// float (decode_bwd_v4s_kernel, the parity configuration; no TF32): the products on the CUDA
// cores (decode_common.cuh's block_gemm and point_contraction), one direction at a time; W^T is
// gathered from w2f1 tile by tile (block_gemm<..., WT = true>).

#include "decode_common.cuh"
#include "decode_bwd_tc.cuh"

namespace {

using namespace dpn;

// ---- bf16: tensor cores (decode_bwd_tc.cuh) ------------------------------------------------

using jvp::bf16;

__global__ void __launch_bounds__(THREADS, 1)
decode_bwd_v4s_tc(const bf16* __restrict__ pe, const bf16* __restrict__ cd,
                  const float* __restrict__ g_primal, const float* __restrict__ g_tang,
                  const bf16* __restrict__ w1g, const bf16* __restrict__ w1t,
                  const float* __restrict__ b1, const bf16* __restrict__ w2f1,
                  const bf16* __restrict__ wdf1, const float* __restrict__ rbias,
                  const float* __restrict__ fw2, const float* __restrict__ w2wo,
                  float* __restrict__ gw1g, float* __restrict__ gw1t, float* __restrict__ gb1,
                  float* __restrict__ gw2f1, float* __restrict__ gwdf1,
                  float* __restrict__ grbias, float* __restrict__ gfw2,
                  float* __restrict__ gw2wo, float* __restrict__ gwdwo,
                  int64_t n, int in_ch, int n_vars, int v6) {
  const int v = blockIdx.y;
  const jvp::RowSource src{v6 ? nullptr : pe, v6 ? pe : nullptr, n, in_ch};
  bwd::backward_block(src, cd, g_primal, g_tang, w1g + (size_t)v * in_ch * HID, w1t + (size_t)v * in_ch * HID,
                      b1, w2f1, wdf1, rbias, fw2, w2wo, gw1g, gw1t, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo,
                      gwdwo, n_vars, v6 == 0);
}

int launch_tc(const void* pe, const void* cd, const float* g_primal, const float* g_tang, const void* w1g,
              const void* w1t, const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
              const float* fw2, const float* w2wo, float* gw1g, float* gw1t, float* gb1, float* gw2f1,
              float* gwdf1, float* grbias, float* gfw2, float* gw2wo, float* gwdwo, int64_t n, int in_ch,
              int n_vars, int v6, cudaStream_t stream) {
  if (!bwd::bwd_valid(in_ch, false)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd::bwd_smem(in_ch, false).total;
  cudaError_t err = cudaFuncSetAttribute(decode_bwd_v4s_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + jvp::NB - 1) / jvp::NB), (unsigned)n_vars);
  decode_bwd_v4s_tc<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(pe), static_cast<const bf16*>(cd), g_primal, g_tang, static_cast<const bf16*>(w1g),
      static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2f1), static_cast<const bf16*>(wdf1), rbias,
      fw2, w2wo, gw1g, gw1t, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch, n_vars, v6);
  return (int)cudaGetLastError();
}

// ---- float: CUDA cores ------------------------------------------------------------------------

// Column sums of this block, combined in shared memory before they go out.
enum { CS_FW2 = 0, CS_W2WO, CS_RBIAS, CS_B1, CS_COUNT };

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
decode_bwd_v4s_kernel(const T* __restrict__ pe, const T* __restrict__ cd,
                      const float* __restrict__ g_primal, const float* __restrict__ g_tang,
                      const T* __restrict__ w1g, const T* __restrict__ w1t,
                      const float* __restrict__ b1, const T* __restrict__ w2f1,
                      const T* __restrict__ wdf1,
                      const float* __restrict__ rbias, const float* __restrict__ fw2,
                      const float* __restrict__ w2wo,
                      float* __restrict__ gw1g, float* __restrict__ gw1t, float* __restrict__ gb1,
                      float* __restrict__ gw2f1, float* __restrict__ gwdf1,
                      float* __restrict__ grbias, float* __restrict__ gfw2,
                      float* __restrict__ gw2wo, float* __restrict__ gwdwo,
                      int64_t n, int in_ch, int n_vars, int v6) {
  constexpr int NB = WARPS * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);    // [NB, HID] f32: p, then t_k
  T* G_s = reinterpret_cast<T*>(p_s + NB * HID);  // [NB, HID]: g_rp / g_rt_k, then g_z / g_tz_k
  T* Ws = G_s + NB * HID;                         // [KT, HID]
  T* pe_s = Ws + KT * HID;                        // [NB, in_ch]
  T* cd_s = pe_s + NB * in_ch;                    // [NB, in_ch]
  float* go_s = reinterpret_cast<float*>(cd_s + NB * in_ch);  // [4, NB]: go, gto_0..2
  float* cs = go_s + 4 * NB;                      // [CS_COUNT, HID]

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int two_f = in_ch / 3;
  const T* W = w2f1 + (size_t)v * HID * HID;

  const bool var_major = v6 == 0;
  if (v6)
    load_rows_dm<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
  else
    load_rows<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
  for (int i = tid; i < 4 * NB; i += THREADS) {
    const int which = i / NB;  // 0: primal, 1..3: tangent direction which - 1
    const int64_t point = n0 + i % NB;
    float g = 0.0f;
    if (point < n)
      g = which == 0 ? g_primal[primal_at(var_major, point, v, n, n_vars)]
                     : g_tang[tangent_at(var_major, which - 1, point, v, n, n_vars)];
    go_s[i] = g;
  }
  for (int i = tid; i < CS_COUNT * HID; i += THREADS) cs[i] = 0.0f;

  float acc[TM][TN];
  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0

  // ---- primal chain -------------------------------------------------------
  // z, p (f32, shared); sum_n p go.  The product's first barrier publishes the
  // loads above.
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(pe_s, in_ch, w1g + (size_t)v * in_ch * HID, in_ch, Ws, acc);
#pragma unroll
  for (int r = 0; r < TM; ++r) mask[r] = 0u;
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float bias = b1[v * HID + col];
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float z = acc[r][c] + bias;
      if (z > 0.0f) mask[r] |= 1u << c;
      const float p = fmaxf(z, 0.0f);
      p_s[(ty * TM + r) * HID + col] = p;
      s = fmaf(p, go_s[ty * TM + r], s);
    }
    atomicAdd(&cs[CS_W2WO * HID + col], s);
  }

  // r, pr, g_rp (T, shared); sum_n pr go, sum_n g_rp
  zero_tile<TM>(acc);
  block_gemm<T, float, TM>(p_s, HID, W, HID, Ws, acc);
  block_gemm<T, T, TM>(cd_s, in_ch, wdf1 + (size_t)v * in_ch * HID, in_ch, Ws, acc);
#pragma unroll
  for (int r = 0; r < TM; ++r) maskr[r] = 0u;
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float rb = rbias[v * HID + col], a = fw2[v * HID + col];
    float s_f = 0.0f, s_b = 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float rv = acc[r][c] + rb;
      const float go = go_s[ty * TM + r];
      if (rv > 0.0f) maskr[r] |= 1u << c;
      s_f = fmaf(fmaxf(rv, 0.0f), go, s_f);
      const float g_rp = rv > 0.0f ? go * a : 0.0f;
      s_b += g_rp;
      G_s[(ty * TM + r) * HID + col] = from_f32<T>(g_rp);
    }
    atomicAdd(&cs[CS_FW2 * HID + col], s_f);
    atomicAdd(&cs[CS_RBIAS * HID + col], s_b);
  }
  __syncthreads();
  point_contraction<T, float>(p_s, HID, HID, G_s, NB, gw2f1 + (size_t)v * HID * HID);
  point_contraction<T, T>(cd_s, in_ch, in_ch, G_s, NB, gwdf1 + (size_t)v * in_ch * HID);
  for (int i = tid; i < in_ch; i += THREADS) {
    float s = 0.0f;
    for (int pnt = 0; pnt < NB; ++pnt) s = fmaf(to_f32(cd_s[pnt * in_ch + i]), go_s[pnt], s);
    atomicAdd(&gwdwo[v * in_ch + i], 2.0f * s);
  }

  // g_z = 1[z > 0] (g_rp W^T + 2 go b) over g_rp in shared; sum_n g_z
  zero_tile<TM>(acc);
  block_gemm<T, T, TM, true>(G_s, HID, W, HID, Ws, acc);  // W^T
  __syncthreads();  // every thread has read its rows of g_rp
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float b = w2wo[v * HID + col];
    float s = 0.0f;
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float g_p = acc[r][c] + 2.0f * (go_s[ty * TM + r] * b);
      const float g_z = (mask[r] >> c) & 1u ? g_p : 0.0f;
      s += g_z;
      G_s[(ty * TM + r) * HID + col] = from_f32<T>(g_z);
    }
    atomicAdd(&cs[CS_B1 * HID + col], s);
  }
  __syncthreads();
  point_contraction<T, T>(pe_s, in_ch, in_ch, G_s, NB, gw1g + (size_t)v * in_ch * HID);

  // ---- tangent chains, one direction at a time ------------------------------
  for (int k = 0; k < 3; ++k) {
    const float* gto_s = go_s + (k + 1) * NB;
    const T* pe_k = pe_s + k * two_f;
    // t_k = 1[z > 0] (pe[:, block k] . w1t[v, k]) in f32 over p_s; sum_n t_k gto_k.
    // The product's first barrier comes after every thread's last read of
    // p_s / G_s in the contractions above.
    zero_tile<TM>(acc);
    block_gemm<T, T, TM>(pe_k, in_ch, w1t + ((size_t)v * 3 + k) * two_f * HID, two_f, Ws, acc);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx + 32 * c;
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float t = (mask[r] >> c) & 1u ? acc[r][c] : 0.0f;
        p_s[(ty * TM + r) * HID + col] = t;
        s = fmaf(t, gto_s[ty * TM + r], s);
      }
      atomicAdd(&cs[CS_W2WO * HID + col], s);
    }
    // tr_k = 1[r > 0] (T(t_k) . W); sum_n tr_k gto_k; g_rt_k (T, shared)
    zero_tile<TM>(acc);
    block_gemm<T, float, TM>(p_s, HID, W, HID, Ws, acc);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx + 32 * c;
      const float a = fw2[v * HID + col];
      float s = 0.0f;
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const bool on = (maskr[r] >> c) & 1u;
        const float gto = gto_s[ty * TM + r];
        if (on) s = fmaf(acc[r][c], gto, s);
        G_s[(ty * TM + r) * HID + col] = from_f32<T>(on ? gto * a : 0.0f);
      }
      atomicAdd(&cs[CS_FW2 * HID + col], s);
    }
    __syncthreads();
    point_contraction<T, float>(p_s, HID, HID, G_s, NB, gw2f1 + (size_t)v * HID * HID);

    // g_tz_k = 1[z > 0] (g_rt_k W^T + 2 gto_k b)
    zero_tile<TM>(acc);
    block_gemm<T, T, TM, true>(G_s, HID, W, HID, Ws, acc);  // W^T
    __syncthreads();  // every thread has read its rows of g_rt_k
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx + 32 * c;
      const float b = w2wo[v * HID + col];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float g_t = acc[r][c] + 2.0f * (gto_s[ty * TM + r] * b);
        G_s[(ty * TM + r) * HID + col] = from_f32<T>((mask[r] >> c) & 1u ? g_t : 0.0f);
      }
    }
    __syncthreads();
    point_contraction<T, T>(pe_k, in_ch, two_f, G_s, NB,
                            gw1t + ((size_t)v * 3 + k) * two_f * HID);
  }

  // ---- the column sums ---------------------------------------------------------
  __syncthreads();
  for (int i = tid; i < HID; i += THREADS) {
    atomicAdd(&gfw2[v * HID + i], cs[CS_FW2 * HID + i]);
    atomicAdd(&gw2wo[v * HID + i], 2.0f * cs[CS_W2WO * HID + i]);
    atomicAdd(&grbias[v * HID + i], cs[CS_RBIAS * HID + i]);
    atomicAdd(&gb1[v * HID + i], cs[CS_B1 * HID + i]);
  }
}

template <typename T, int TM> size_t shared_bytes(int in_ch) {
  constexpr int NB = WARPS * TM;
  return (size_t)NB * HID * (sizeof(float) + sizeof(T)) + (size_t)KT * HID * sizeof(T) +
         2 * (size_t)NB * in_ch * sizeof(T) + (size_t)(4 * NB + CS_COUNT * HID) * sizeof(float);
}

template <typename T, int TM>
int launch(const void* pe, const void* cd, const float* g_primal, const float* g_tang,
           const void* w1g, const void* w1t, const float* b1, const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
           const float* w2wo, float* gw1g, float* gw1t, float* gb1, float* gw2f1, float* gwdf1,
           float* grbias, float* gfw2, float* gw2wo, float* gwdwo, int64_t n, int in_ch,
           int n_vars, int v6, cudaStream_t stream) {
  constexpr int NB = WARPS * TM;
  const size_t smem = shared_bytes<T, TM>(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_bwd_v4s_kernel<T, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_bwd_v4s_kernel<T, TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pe), static_cast<const T*>(cd), g_primal, g_tang,
      static_cast<const T*>(w1g), static_cast<const T*>(w1t), b1, static_cast<const T*>(w2f1),
      static_cast<const T*>(wdf1), rbias, fw2, w2wo, gw1g, gw1t,
      gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch, n_vars, v6);
  return (int)cudaGetLastError();
}

// Points per block of the float body: 32 (its buffers are twice bf16's).
constexpr int TM_F32 = 4;

}  // namespace

extern "C" {

// Hidden width the kernel was built for; shared memory one block needs at this
// input width.
int dpn_decode_bwd_v4s_hid() { return dpn::HID; }
// Points a block takes.
int dpn_decode_bwd_v4s_block(int is_bf16) { return is_bf16 ? jvp::NB : WARPS * TM_F32; }
// Bytes a block adds into the outputs with atomic adds (bwd::atomic_bytes).
int64_t dpn_decode_bwd_v4s_atomic_bytes(int is_bf16, int in_ch) { return bwd::atomic_bytes(is_bf16, in_ch); }
int dpn_decode_bwd_v4s_shared_bytes(int is_bf16, int in_ch) {
  if (!is_bf16) return (int)shared_bytes<float, TM_F32>(in_ch);
  return bwd::bwd_valid(in_ch, false) ? (int)bwd::bwd_smem(in_ch, false).total : 1 << 30;
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  v6: 0 for pe [n, in_ch],
// g_primal [n_vars, n] and g_tang [3, n_vars, n]; 1 for pe = trig [3, n, in_ch / 3],
// g_primal [n, n_vars] and g_tang [3, n, n_vars].  The nine outputs must be
// zero on entry; the kernel adds into them.  Returns cudaGetLastError() after
// the launch (0 on success).
int dpn_decode_bwd_v4s(int is_bf16, const void* pe, const void* cd, const float* g_primal,
                       const float* g_tang, const void* w1g, const void* w1t, const float* b1,
                       const void* w2f1, const void* wdf1,
                       const float* rbias, const float* fw2, const float* w2wo, float* gw1g,
                       float* gw1t, float* gb1, float* gw2f1, float* gwdf1, float* grbias,
                       float* gfw2, float* gw2wo, float* gwdwo, int64_t n, int in_ch,
                       int n_vars, int v6, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tc(pe, cd, g_primal, g_tang, w1g, w1t, b1, w2f1, wdf1, rbias, fw2, w2wo, gw1g, gw1t, gb1,
                     gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch, n_vars, v6, s);
  return launch<float, TM_F32>(pe, cd, g_primal, g_tang, w1g, w1t, b1, w2f1, wdf1, rbias,
                               fw2, w2wo, gw1g, gw1t, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo,
                               gwdwo, n, in_ch, n_vars, v6, s);
}

}  // extern "C"
