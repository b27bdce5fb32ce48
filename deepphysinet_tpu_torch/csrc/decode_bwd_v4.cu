// v4 collapsed decode, backward: cotangents of the nine fused weights, summed
// over all points, with the two cotangent inputs in either layout, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/decode_kernel.py that share
// one body: _decode_bwd_kernel_v4 with t_layout=False (called through
// decode_bwd_kernel_v4, cotangents [N, 6] / [3, N, 6]) and with t_layout=True
// (decode_bwd_kernel_v4t, [6, N] / [3, 6, N]).  Per block of points and
// variable v it recomputes the forward chain (no activations are saved by the
// forward) and forms, with go = g_primal[., v], gto_k = g_tang[k, ., v] as
// per-point columns, a = fw2[v], b = w2wo[v], W = w2f1[v], ch = in_ch / 3:
//
//   z, p, t_k, r, pr, tr_k        as the forward, except that t_k stays f32 here
//                                 and is rounded only as a product's input
//                                 (:1470-1478); the forward rounds it once
//   g_rp  = 1[r > 0] go a         g_rt_k = 1[r > 0] gto_k a
//   gfw2  += sum_n pr go + sum_k sum_n tr_k gto_k
//   gw2wo += 2 (sum_n p go + sum_k sum_n t_k gto_k)
//   gwdwo += 2 sum_n cd go        grbias += sum_n g_rp
//   gw2f1 += p^T g_rp + sum_k t_k^T g_rt_k       gwdf1 += cd^T g_rp
//   g_z   = 1[z > 0] (g_rp W^T + 2 go b)   g_tz_k = 1[z > 0] (g_rt_k W^T + 2 gto_k b)
//   gw1   += pe^T g_z             gb1 += sum_n g_z
//   gw1c[k] += dpe[k]^T g_tz_k
//
// Every operand of every product is rounded to the compute type T first, also
// g_rp, g_rt, g_z and g_tz; sums are f32.  g_obias = sum_n go is left to the
// caller, as on the TPU.  gw1 and gw1c are separate outputs: w1c is a row
// slice of w1, and the caller's autograd adds the two.
//
// What bounds it: 12.98 MFLOP per point against about 1,200 bytes of point input, so it is
// compute bound.  As for the v4s backward: the TPU's sequential grid adds into accumulators
// resident in fast memory; here blocks run concurrently and the accumulators (5.1 MB of f32) fit
// neither a block's shared memory nor one private copy per block.  A block owns NB points and ONE
// variable (grid = blocks x variables); each product that contracts the point axis is summed over
// the block's points and added into the zero-initialised output in global memory with float4
// atomic adds, which resolve in L2.  The order in which blocks add is not fixed, so the result is
// not bit-reproducible from run to run; it is compared with the plain version by tolerance.
// Points past n enter with zero rows and zero cotangents, and every output is linear in the
// cotangents, so they add nothing.  The layout flag changes only the addresses the two cotangents
// are loaded from.
//
// bf16 (decode_bwd_v4_tc, the flagship's type): the tensor-core body of decode_bwd_tc.cuh, which
// the v4s / v6 backward shares (its header gives the design, the shared-memory budget and the
// atomic traffic), with jvp::RowSource{pe, dm = dpe}: stages 1 and 2 recomputed through
// decode_jvp_tc.cuh with fix_ties, so that the masks and T(p), T(t_k) have the v4 forward
// kernel's bits; g_rp and g_rt_k formed in registers from r's mask bits; gw2f1 as one K = 4 x 64
// product; W^T read by a plain ldmatrix from the row-major w2f1; the dpe rows of the block
// loaded under the row sets' tail for stage 1 and into the ring for gw1c at the end.
//
// float (decode_bwd_v4_kernel, the parity configuration; no TF32): the products on the CUDA
// cores (decode_common.cuh's block_gemm and point_contraction), one direction at a time; W^T is
// gathered from w2f1 tile by tile (block_gemm<..., WT = true>).

#include "decode_common.cuh"
#include "decode_bwd_tc.cuh"

namespace {

using namespace dpn;

// ---- bf16: tensor cores (decode_bwd_tc.cuh) ------------------------------------------------

using jvp::bf16;

__global__ void __launch_bounds__(THREADS, 1)
decode_bwd_v4_tc(const bf16* __restrict__ pe, const bf16* __restrict__ dpe, const bf16* __restrict__ cd,
                 const float* __restrict__ g_primal, const float* __restrict__ g_tang,
                 const bf16* __restrict__ w1, const bf16* __restrict__ w1c, const float* __restrict__ b1,
                 const bf16* __restrict__ w2f1, const bf16* __restrict__ wdf1, const float* __restrict__ rbias,
                 const float* __restrict__ fw2, const float* __restrict__ w2wo, float* __restrict__ gw1,
                 float* __restrict__ gw1c, float* __restrict__ gb1, float* __restrict__ gw2f1,
                 float* __restrict__ gwdf1, float* __restrict__ grbias, float* __restrict__ gfw2,
                 float* __restrict__ gw2wo, float* __restrict__ gwdwo, int64_t n, int in_ch, int n_vars,
                 int t_layout) {
  const int v = blockIdx.y;
  const jvp::RowSource src{pe, dpe, n, in_ch};
  bwd::backward_block(src, cd, g_primal, g_tang, w1 + (size_t)v * in_ch * HID, w1c + (size_t)v * in_ch * HID, b1,
                      w2f1, wdf1, rbias, fw2, w2wo, gw1, gw1c, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo,
                      n_vars, t_layout != 0);
}

int launch_tc(const void* pe, const void* dpe, const void* cd, const float* g_primal, const float* g_tang,
              const void* w1, const void* w1c, const float* b1, const void* w2f1, const void* wdf1,
              const float* rbias, const float* fw2, const float* w2wo, float* gw1, float* gw1c, float* gb1,
              float* gw2f1, float* gwdf1, float* grbias, float* gfw2, float* gw2wo, float* gwdwo, int64_t n,
              int in_ch, int n_vars, int t_layout, cudaStream_t stream) {
  if (!bwd::bwd_valid(in_ch, true)) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd::bwd_smem(in_ch, true).total;
  cudaError_t err = cudaFuncSetAttribute(decode_bwd_v4_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + jvp::NB - 1) / jvp::NB), (unsigned)n_vars);
  decode_bwd_v4_tc<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(pe), static_cast<const bf16*>(dpe), static_cast<const bf16*>(cd), g_primal, g_tang,
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w1c), b1, static_cast<const bf16*>(w2f1),
      static_cast<const bf16*>(wdf1), rbias, fw2, w2wo, gw1, gw1c, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo,
      n, in_ch, n_vars, t_layout);
  return (int)cudaGetLastError();
}

// ---- float: CUDA cores ------------------------------------------------------------------------

// Column sums of this block, combined in shared memory before they go out.
enum { CS_FW2 = 0, CS_W2WO, CS_RBIAS, CS_B1, CS_COUNT };

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
decode_bwd_v4_kernel(const T* __restrict__ pe, const T* __restrict__ dpe,
                     const T* __restrict__ cd,
                     const float* __restrict__ g_primal, const float* __restrict__ g_tang,
                     const T* __restrict__ w1, const T* __restrict__ w1c,
                     const float* __restrict__ b1, const T* __restrict__ w2f1,
                     const T* __restrict__ wdf1,
                     const float* __restrict__ rbias, const float* __restrict__ fw2,
                     const float* __restrict__ w2wo,
                     float* __restrict__ gw1, float* __restrict__ gw1c, float* __restrict__ gb1,
                     float* __restrict__ gw2f1, float* __restrict__ gwdf1,
                     float* __restrict__ grbias, float* __restrict__ gfw2,
                     float* __restrict__ gw2wo, float* __restrict__ gwdwo,
                     int64_t n, int in_ch, int n_vars, int t_layout) {
  constexpr int NB = WARPS * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);    // [NB, HID] f32: p, then t_k
  T* G_s = reinterpret_cast<T*>(p_s + NB * HID);  // [NB, HID]: g_rp / g_rt_k, then g_z / g_tz_k
  T* Ws = G_s + NB * HID;                         // [KT, HID]
  T* pe_s = Ws + KT * HID;                        // [NB, in_ch]
  T* cd_s = pe_s + NB * in_ch;                    // [NB, in_ch]
  T* d_s = cd_s + NB * in_ch;                     // [3, NB, ch]
  float* go_s = reinterpret_cast<float*>(d_s + NB * in_ch);  // [4, NB]: go, gto_0..2
  float* cs = go_s + 4 * NB;                      // [CS_COUNT, HID]

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3;
  const bool tl = t_layout != 0;
  const T* W = w2f1 + (size_t)v * HID * HID;

  load_rows<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
  {
    const T zero = from_f32<T>(0.0f);
    const int per_dir = NB * ch;
    for (int i = tid; i < 3 * per_dir; i += THREADS) {
      const int k = i / per_dir, j = i - k * per_dir;
      const bool live = n0 + j / ch < n;
      d_s[i] = live ? dpe[((size_t)k * n + n0) * ch + j] : zero;
    }
  }
  for (int i = tid; i < 4 * NB; i += THREADS) {
    const int which = i / NB;  // 0: primal, 1..3: tangent direction which - 1
    const int64_t point = n0 + i % NB;
    float g = 0.0f;
    if (point < n) {
      if (which == 0)
        g = g_primal[tl ? (int64_t)v * n + point : point * n_vars + v];
      else
        g = g_tang[tl ? ((int64_t)(which - 1) * n_vars + v) * n + point
                      : ((int64_t)(which - 1) * n + point) * n_vars + v];
    }
    go_s[i] = g;
  }
  for (int i = tid; i < CS_COUNT * HID; i += THREADS) cs[i] = 0.0f;

  float acc[TM][TN];
  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0

  // ---- primal chain -------------------------------------------------------
  // z, p (f32, shared); sum_n p go.  The product's first barrier publishes the
  // loads above.
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(pe_s, in_ch, w1 + (size_t)v * in_ch * HID, in_ch, Ws, acc);
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
  point_contraction<T, T>(pe_s, in_ch, in_ch, G_s, NB, gw1 + (size_t)v * in_ch * HID);

  // ---- tangent chains, one direction at a time ------------------------------
  for (int k = 0; k < 3; ++k) {
    const float* gto_s = go_s + (k + 1) * NB;
    const T* d_k = d_s + k * NB * ch;
    // t_k = 1[z > 0] (dpe[k] . w1c[v, k]) in f32 over p_s; sum_n t_k gto_k.
    // The product's first barrier comes after every thread's last read of
    // p_s / G_s in the contractions above.
    zero_tile<TM>(acc);
    block_gemm<T, T, TM>(d_k, ch, w1c + ((size_t)v * 3 + k) * ch * HID, ch, Ws, acc);
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
    point_contraction<T, T>(d_k, ch, ch, G_s, NB, gw1c + ((size_t)v * 3 + k) * ch * HID);
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
         3 * (size_t)NB * in_ch * sizeof(T) + (size_t)(4 * NB + CS_COUNT * HID) * sizeof(float);
}

template <typename T, int TM>
int launch(const void* pe, const void* dpe, const void* cd, const float* g_primal,
           const float* g_tang, const void* w1, const void* w1c, const float* b1,
           const void* w2f1, const void* wdf1, const float* rbias,
           const float* fw2, const float* w2wo, float* gw1, float* gw1c, float* gb1,
           float* gw2f1, float* gwdf1, float* grbias, float* gfw2, float* gw2wo, float* gwdwo,
           int64_t n, int in_ch, int n_vars, int t_layout, cudaStream_t stream) {
  constexpr int NB = WARPS * TM;
  const size_t smem = shared_bytes<T, TM>(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_bwd_v4_kernel<T, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_bwd_v4_kernel<T, TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pe), static_cast<const T*>(dpe), static_cast<const T*>(cd), g_primal,
      g_tang, static_cast<const T*>(w1), static_cast<const T*>(w1c), b1,
      static_cast<const T*>(w2f1), static_cast<const T*>(wdf1),
      rbias, fw2, w2wo, gw1, gw1c, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch,
      n_vars, t_layout);
  return (int)cudaGetLastError();
}

// Points per block of the float body: 32 (its buffers are twice bf16's).
constexpr int TM_F32 = 4;

}  // namespace

extern "C" {

// Hidden width the kernel was built for; shared memory one block needs at this
// input width.
int dpn_decode_bwd_v4_hid() { return dpn::HID; }
// Points a block takes.
int dpn_decode_bwd_v4_block(int is_bf16) { return is_bf16 ? jvp::NB : WARPS * TM_F32; }
// Bytes a block adds into the outputs with atomic adds (bwd::atomic_bytes).
int64_t dpn_decode_bwd_v4_atomic_bytes(int is_bf16, int in_ch) { return bwd::atomic_bytes(is_bf16, in_ch); }
int dpn_decode_bwd_v4_shared_bytes(int is_bf16, int in_ch) {
  if (!is_bf16) return (int)shared_bytes<float, TM_F32>(in_ch);
  return bwd::bwd_valid(in_ch, true) ? (int)bwd::bwd_smem(in_ch, true).total : 1 << 30;
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  t_layout: 0 for g_primal
// [n, n_vars] and g_tang [3, n, n_vars]; 1 for [n_vars, n] and [3, n_vars, n].
// The nine outputs must be zero on entry; the kernel adds into them.  Returns
// cudaGetLastError() after the launch (0 on success).
int dpn_decode_bwd_v4(int is_bf16, const void* pe, const void* dpe, const void* cd,
                      const float* g_primal, const float* g_tang, const void* w1,
                      const void* w1c, const float* b1, const void* w2f1, const void* wdf1,
                      const float* rbias, const float* fw2, const float* w2wo,
                      float* gw1, float* gw1c, float* gb1, float* gw2f1, float* gwdf1,
                      float* grbias, float* gfw2, float* gw2wo, float* gwdwo, int64_t n,
                      int in_ch, int n_vars, int t_layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tc(pe, dpe, cd, g_primal, g_tang, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo, gw1, gw1c, gb1,
                     gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch, n_vars, t_layout, s);
  return launch<float, TM_F32>(pe, dpe, cd, g_primal, g_tang, w1, w1c, b1, w2f1, wdf1,
                               rbias, fw2, w2wo, gw1, gw1c, gb1, gw2f1, gwdf1, grbias, gfw2,
                               gw2wo, gwdwo, n, in_ch, n_vars, t_layout, s);
}

}  // extern "C"
