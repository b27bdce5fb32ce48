// Collapsed decode with the PDE residual assembly in the same kernel: six sums of
// squared residuals over all points and nothing else, for Hopper (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/residual_kernel.py that share
// their assembly: _residual_kernel_v4 (called through fused_residual_sums_v4;
// v6 = 0 here: layer 1 of the v4 decode, interleaved pe [n, in_ch] through w1 and
// the compact tangent input dpe [3, n, in_ch / 3] through w1c) and
// _residual_kernel_v6 (fused_residual_sums_v6; v6 = 1: layer 1 of the v6 decode,
// trig [3, n, in_ch / 3] through w1g and w1t).  Per point it computes the decode
// of decode_jvp_v4.cu / decode_jvp_v4s.cu for all six variables (primal and three
// tangents, the same rounding points: decode_common.cuh's primal_stages and
// tangent_stage), then the mean-norm inverse with its clip masks, the six
// residuals of residual_equations.cuh, their squares, and the sums of the squares
// over the points.  Neither the primal nor the tangents go to device memory.
//
// What bounds it: the decode's 4.92 MFLOP per point against about 800 (v6) or
// 1,200 (v4) bytes of point input and 24 bytes of output in all, so it is compute
// bound; the assembly is a few hundred float operations per point.  The products
// run on the CUDA cores, as in the decode kernels.  Where the card differs from
// the TPU:
//
// * A block needs all six variables of its points.  The jvp kernels give a block
//   one variable; here a block owns its NB points and walks the six variables,
//   keeps the 24 decode outputs of each point in shared memory, and assembles
//   when the last variable is done.  The point rows are loaded once for the six
//   variables.  The grid is n / NB blocks: the callers launch this kernel at
//   49,152 points and more, which is 768 blocks of 64 points.  The v4 form keeps
//   pe AND dpe resident (pe is needed again by the next variable), which in f32
//   exceeds a block's shared memory at 64 points, so f32 runs 32-point blocks.
// * The sum over blocks is the kernel's own.  On the TPU every grid step adds
//   into one resident block of fast memory; here each block writes its six
//   partial sums to a scratch array, takes a ticket from a counter, and the
//   block that draws the last ticket adds all partials in block order (one warp
//   per equation, lane-strided, then a shuffle tree).  Every order is fixed by
//   the launch's shape, so two runs on the same inputs give the same bits.
// * Rows past n are skipped, not multiplied by zero: a dead row's density may be
//   anything, and NaN * 0 is NaN.

#include "decode_common.cuh"
#include "residual_equations.cuh"

namespace {

using namespace dpn;

constexpr int N_VARS = 6;
constexpr int N_EQS = 6;
constexpr int N_OUT = 4 * N_VARS;  // primal and three tangents per variable

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
residual_sums_kernel(const T* __restrict__ pe, const T* __restrict__ dpe,
                     const T* __restrict__ cd, const float* __restrict__ ref_t,
                     const float* __restrict__ coriolis, const T* __restrict__ w1,
                     const T* __restrict__ w1k, const float* __restrict__ b1,
                     const T* __restrict__ w2f1, const T* __restrict__ wdf1,
                     const float* __restrict__ rbias, const float* __restrict__ fw2,
                     const float* __restrict__ w2wo, const float* __restrict__ wdwo,
                     const float* __restrict__ obias, const ResidualParams prm,
                     float* __restrict__ partials, unsigned int* __restrict__ tickets,
                     float* __restrict__ sums, int64_t n, int in_ch, int v6) {
  constexpr int NB = WARPS * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);   // [NB, HID] f32, stage 1 and 2
  T* t_s = reinterpret_cast<T*>(smem);           // [NB, HID] T, reuses p_s afterwards
  T* Ws = reinterpret_cast<T*>(p_s + NB * HID);  // [KT, HID]
  T* pe_s = Ws + KT * HID;                       // [NB, in_ch]
  T* cd_s = pe_s + NB * in_ch;                   // [NB, in_ch]
  T* d_s = cd_s + NB * in_ch;                    // [3, NB, ch], the v4 form only
  float* out_s = reinterpret_cast<float*>(d_s + (v6 ? 0 : NB * in_ch));  // [N_OUT, NB]
  float* sq_s = out_s + N_OUT * NB;              // [N_EQS, NB] squared residuals
  __shared__ bool last_block;

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3;

  if (v6) {
    load_rows_dm<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
  } else {
    load_rows<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
    const T zero = from_f32<T>(0.0f);
    const int per_dir = NB * ch;
    for (int i = tid; i < 3 * per_dir; i += THREADS) {
      const int k = i / per_dir, j = i - k * per_dir;
      const bool live = n0 + j / ch < n;
      d_s[i] = live ? dpe[((size_t)k * n + n0) * ch + j] : zero;
    }
  }

  // ---- the decode: all six variables of the block's points -> out_s ------------
  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0
  for (int v = 0; v < N_VARS; ++v) {
    float o[TM];
    const T* w2f1_v = w2f1 + (size_t)v * HID * HID;
    primal_stages<T, TM>(pe_s, in_ch, in_ch, w1 + (size_t)v * in_ch * HID, cd_s, in_ch,
                         b1 + v * HID, w2f1_v, wdf1 + (size_t)v * in_ch * HID, rbias + v * HID,
                         fw2 + v * HID, w2wo + v * HID, wdwo + v * in_ch, p_s, Ws, mask, maskr, o);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int row = ty * TM + r;
      if (tx == r)
        out_s[(4 * v) * NB + row] = n0 + row < n ? o[r] + obias[v] + ref_t[(int64_t)v * n + n0 + row]
                                                 : 0.0f;
    }
    for (int k = 0; k < 3; ++k) {
      // direction k's operand: lanes k * ch : (k + 1) * ch of the trig rows (v6), or
      // the compact rows dpe[k] (v4)
      const T* tin = v6 ? pe_s + k * ch : d_s + k * NB * ch;
      float to[TM];
      tangent_stage<T, TM>(tin, v6 ? in_ch : ch, ch, w1k + ((size_t)v * 3 + k) * ch * HID, w2f1_v,
                           fw2 + v * HID, w2wo + v * HID, t_s, Ws, mask, maskr, to);
#pragma unroll
      for (int r = 0; r < TM; ++r)
        if (tx == r) out_s[(4 * v + 1 + k) * NB + ty * TM + r] = to[r];
    }
  }
  __syncthreads();

  // ---- the assembly: one thread per point -----------------------------------------
  if (tid < NB) {
    float sq[N_EQS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (n0 + tid < n) {
      eq::Point pt;
#pragma unroll
      for (int v = 0; v < N_VARS; ++v) {
        const float to[3] = {out_s[(4 * v + 1) * NB + tid], out_s[(4 * v + 2) * NB + tid],
                             out_s[(4 * v + 3) * NB + tid]};
        eq::to_physical(prm, v, out_s[(4 * v) * NB + tid], to, pt);
      }
      float res[N_EQS];
      eq::residuals(prm, pt, coriolis[n0 + tid], res);
#pragma unroll
      for (int e = 0; e < N_EQS; ++e) sq[e] = eq::mul(res[e], res[e]);
    }
#pragma unroll
    for (int e = 0; e < N_EQS; ++e) sq_s[e * NB + tid] = sq[e];
  }
  __syncthreads();

  // ---- the block's six partial sums, in a fixed order -----------------------------------
  if (ty < N_EQS) {
    float s = 0.0f;
    for (int i = tx; i < NB; i += 32) s += sq_s[ty * NB + i];
    s = warp_sum(s);
    if (tx == 0) partials[(size_t)blockIdx.x * N_EQS + ty] = s;
  }
  __threadfence();  // the partials are visible device-wide before the ticket is drawn
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last_block) return;

  // ---- the last block to finish adds all blocks' partials, in block order ----------------
  __threadfence();
  if (ty < N_EQS) {
    float s = 0.0f;
    for (unsigned int b = tx; b < gridDim.x; b += 32) s += __ldcg(&partials[(size_t)b * N_EQS + ty]);
    s = warp_sum(s);
    if (tx == 0) sums[ty] = s;
  }
}

template <typename T, int TM> size_t shared_bytes(int in_ch, int v6) {
  constexpr int NB = WARPS * TM;
  return (size_t)NB * HID * sizeof(float) + (size_t)KT * HID * sizeof(T) +
         (size_t)(v6 ? 2 : 3) * NB * in_ch * sizeof(T) + (size_t)(N_OUT + N_EQS) * NB * sizeof(float);
}

template <typename T, int TM>
int launch(const void* pe, const void* dpe, const void* cd, const float* ref_t,
           const float* coriolis, const void* w1, const void* w1k, const float* b1,
           const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
           const float* w2wo, const float* wdwo, const float* obias, const ResidualParams& prm,
           float* partials, unsigned int* tickets, float* sums, int64_t n, int in_ch, int v6,
           cudaStream_t stream) {
  constexpr int NB = WARPS * TM;
  const size_t smem = shared_bytes<T, TM>(in_ch, v6);
  cudaError_t err = cudaFuncSetAttribute(residual_sums_kernel<T, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + NB - 1) / NB);
  residual_sums_kernel<T, TM><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(pe), static_cast<const T*>(dpe), static_cast<const T*>(cd), ref_t,
      coriolis, static_cast<const T*>(w1), static_cast<const T*>(w1k), b1,
      static_cast<const T*>(w2f1), static_cast<const T*>(wdf1), rbias, fw2, w2wo, wdwo, obias, prm,
      partials, tickets, sums, n, in_ch, v6);
  return (int)cudaGetLastError();
}

// Points per block: 64 in bf16; 32 in f32, whose v4 form would not fit at 64.
constexpr int TM_BF16 = 8, TM_F32 = 4;

}  // namespace

extern "C" {

// Hidden width the kernel was built for; points per block, which sizes the
// scratch array; shared memory one block needs at this input width.
int dpn_residual_sums_hid() { return dpn::HID; }
int dpn_residual_sums_block(int is_bf16) { return dpn::WARPS * (is_bf16 ? TM_BF16 : TM_F32); }
int dpn_residual_sums_shared_bytes(int is_bf16, int in_ch, int v6) {
  return (int)(is_bf16 ? shared_bytes<__nv_bfloat16, TM_BF16>(in_ch, v6)
                       : shared_bytes<float, TM_F32>(in_ch, v6));
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  v6: 0 for pe [n, in_ch], dpe
// [3, n, in_ch / 3], w1 [6, in_ch, HID] and w1k = w1c; 1 for pe = trig
// [3, n, in_ch / 3], dpe unused, w1 = w1g and w1k = w1t.  ref_t [6, n], coriolis
// [n].  partials holds 6 floats per block of dpn_residual_sums_block points,
// tickets is one zero, sums [6] is written in full.  Returns cudaGetLastError()
// after the launch (0 on success).
int dpn_residual_sums(int is_bf16, const void* pe, const void* dpe, const void* cd,
                      const float* ref_t, const float* coriolis, const void* w1, const void* w1k,
                      const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
                      const float* fw2, const float* w2wo, const float* wdwo, const float* obias,
                      float* partials, unsigned int* tickets, float* sums,
                      const dpn::ResidualParams* prm, int64_t n, int in_ch, int v6, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, TM_BF16>(pe, dpe, cd, ref_t, coriolis, w1, w1k, b1, w2f1, wdf1,
                                          rbias, fw2, w2wo, wdwo, obias, *prm, partials, tickets,
                                          sums, n, in_ch, v6, s);
  return launch<float, TM_F32>(pe, dpe, cd, ref_t, coriolis, w1, w1k, b1, w2f1, wdf1, rbias, fw2,
                               w2wo, wdwo, obias, *prm, partials, tickets, sums, n, in_ch, v6, s);
}

}  // extern "C"
