// Collapsed decode with the PDE residual assembly in the same launch: six sums of squared
// residuals over all points and nothing else, for Hopper (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/residual_kernel.py that share
// their assembly: _residual_kernel_v4 (called through fused_residual_sums_v4;
// v6 = 0 here: layer 1 of the v4 decode, interleaved pe [n, in_ch] through w1 and
// the compact tangent input dpe [3, n, in_ch / 3] through w1c) and
// _residual_kernel_v6 (fused_residual_sums_v6; v6 = 1: layer 1 of the v6 decode,
// trig [3, n, in_ch / 3] through w1g and w1t).  Per point it computes the decode of all six
// variables (primal and three tangents), then the mean-norm inverse with its clip masks, the six
// residuals of residual_equations.cuh, their squares, and the sums of the squares over the
// points.  The TPU kernel keeps a block's decode outputs in VMEM; only six sums leave it.
//
// What bounds it: the decode's 4.92 MFLOP per point against about 800 (v6) or 1,200 (v4) bytes
// of point input and 24 bytes of output in all, so it is compute bound; the assembly is a few
// hundred float operations per point.
//
// bf16 (residual_sums_tc, the flagship's type): the decode is the bf16 tensor-core forward body
// of decode_jvp_tc.cuh (forward_block: 64 points and ONE variable a block, mma.sync products,
// fix_ties with its floors, the relu switches near zero decided by the plain version's sums), the
// same function with the same bits as the split path's forward (decode_jvp_v4.cu's v4t for v4,
// decode_jvp_v4s.cu's v6 kernel for v6); where the card differs
// from the TPU:
//
// * A point's residuals need all six variables, but the body takes one variable a block: its
//   four row sets, cd, the weight ring and the partial sums fill 226,560 of a block's 232,448
//   bytes of shared memory, so six variables' outputs (24 x 64 floats) no longer fit beside
//   them.  The grid is [n / 64, 6] as for the forwards, and each block writes its 4 x 64 outputs
//   to an f32 scratch [24, n] (primal [6, n], tangents [3, 6, n], in the wrapper's partials
//   array: 6.3 MB at 65,536 points, mostly read back from L2).  A per-point-block ticket tells
//   the sixth block of a point block to finish that its points are complete: it reads their 24
//   outputs (through L2), assembles one point a thread, and writes the point block's six partial
//   sums.  The assembly does not depend on which variable's block runs it.
// * The sum over blocks: each assembling block takes a ticket from a global counter, and the one
//   that draws the last adds all partials in point-block order (one warp per equation,
//   lane-strided, then a shuffle tree).  Every order is fixed by the launch's shape, so two runs
//   on the same inputs give the same bits.
// * Rows past n are skipped, not multiplied by zero: the body stores no output for them and
//   the assembly gives them no term (a dead row's density may be anything, and NaN * 0 is NaN).
//
// float (residual_sums_f32, the parity configuration; no TF32): the products on the CUDA
// cores (FMA), the chain of decode_common.cuh's primal_stages and tangent_stage.  A block owns
// its NB = 32 points and walks the six variables, keeps the 24 decode outputs of each point in
// shared memory, and assembles when the last variable is done; the v4 form keeps pe AND dpe
// resident (pe is needed again by the next variable).  Its partials are summed as above.

#include "decode_common.cuh"
#include "decode_jvp_tc.cuh"
#include "residual_equations.cuh"

namespace {

using namespace dpn;

constexpr int N_VARS = 6;
constexpr int N_EQS = 6;
constexpr int N_OUT = 4 * N_VARS;  // primal and three tangents per variable

// The squared residuals of points n0 .. n0 + nb - 1 into sq_s [N_EQS, nb], one thread a point
// (threads nb and up idle); out(v, j) is variable v's primal (j = 0) or tangent j - 1 of the
// thread's point.  Points at or past n get no term.
template <class Out>
__device__ __forceinline__ void assemble(const ResidualParams& prm, Out out, const float* __restrict__ coriolis,
                                         int64_t n0, int64_t n, int nb, float* sq_s) {
  const int tid = threadIdx.x;
  if (tid >= nb) return;
  float sq[N_EQS] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (n0 + tid < n) {
    eq::Point pt;
#pragma unroll
    for (int v = 0; v < N_VARS; ++v) {
      const float to[3] = {out(v, 1), out(v, 2), out(v, 3)};
      eq::to_physical(prm, v, out(v, 0), to, pt);
    }
    float res[N_EQS];
    eq::residuals(prm, pt, coriolis[n0 + tid], res);
#pragma unroll
    for (int e = 0; e < N_EQS; ++e) sq[e] = eq::mul(res[e], res[e]);
  }
#pragma unroll
  for (int e = 0; e < N_EQS; ++e) sq_s[e * nb + tid] = sq[e];
}

// After a barrier that publishes sq_s: the six partial sums of its nb points (one warp an
// equation, lane-strided, then a shuffle tree) into partials[block]; then a ticket from *ticket,
// and the block that draws the last of n_blocks adds all blocks' partials in block order into
// sums.  Every order is fixed by the launch's shape.  Called by the whole block; last is a shared
// int.
__device__ __forceinline__ void sum_partials(const float* sq_s, int nb, float* __restrict__ partials,
                                             unsigned int* ticket, float* __restrict__ sums, unsigned int block,
                                             unsigned int n_blocks, int* last) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  if (ty < N_EQS) {
    float s = 0.0f;
    for (int i = tx; i < nb; i += 32) s += sq_s[ty * nb + i];
    s = warp_sum(s);
    if (tx == 0) partials[(size_t)block * N_EQS + ty] = s;
  }
  __threadfence();  // the partials are visible device-wide before the ticket is drawn
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(ticket, 1u) == n_blocks - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (ty < N_EQS) {
    float s = 0.0f;
    for (unsigned int b = tx; b < n_blocks; b += 32) s += __ldcg(&partials[(size_t)b * N_EQS + ty]);
    s = warp_sum(s);
    if (tx == 0) sums[ty] = s;
  }
}

// ---- bf16: the tensor-core forward body, one variable a block ------------------------------
//
// Grid [n / 64, 6].  scratch: the outputs, primal [6, n] and tangents [3, 6, n] (forward_block's
// var-major layout), then the point blocks' partials [n / 64, 6]; tickets: [0] for the sum over
// point blocks, [1 + b] for point block b's six variables.  Shared memory: the body's fwd_smem.
__global__ void __launch_bounds__(THREADS, 1)
residual_sums_tc(const jvp::bf16* __restrict__ pe, const jvp::bf16* __restrict__ dpe,
                 const jvp::bf16* __restrict__ cd, const float* __restrict__ ref_t,
                 const float* __restrict__ coriolis, const jvp::bf16* __restrict__ w1,
                 const jvp::bf16* __restrict__ w1k, const float* __restrict__ b1,
                 const jvp::bf16* __restrict__ w2f1, const jvp::bf16* __restrict__ wdf1,
                 const float* __restrict__ rbias, const float* __restrict__ fw2, const float* __restrict__ w2wo,
                 const float* __restrict__ wdwo, const float* __restrict__ obias, const ResidualParams prm,
                 float* __restrict__ scratch, unsigned int* __restrict__ tickets, float* __restrict__ sums,
                 int64_t n, int in_ch, int v6) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int v = blockIdx.y;
  float* primal = scratch;
  float* tang = scratch + N_VARS * n;
  // v4: pe rows and dpe tangent rows; v6: the direction-major trig rows serve both
  const jvp::RowSource src{v6 ? nullptr : pe, v6 ? pe : dpe, n, in_ch};
  jvp::forward_block(src, cd, ref_t, w1 + (size_t)v * in_ch * HID, w1k + (size_t)v * in_ch * HID, b1, w2f1,
                     wdf1, rbias, fw2, w2wo, wdwo, obias, primal, tang, N_VARS, true);

  // the sixth block of the point block to finish assembles its points (the body is done with
  // shared memory once every thread is past it)
  int* last = reinterpret_cast<int*>(smem);
  float* sq_s = reinterpret_cast<float*>(smem) + 4;  // [N_EQS, NB]
  __threadfence();  // this block's outputs are visible device-wide before its ticket is drawn
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(&tickets[1 + blockIdx.x], 1u) == N_VARS - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  const int64_t n0 = (int64_t)blockIdx.x * jvp::NB;
  const int64_t at = n0 + threadIdx.x;
  assemble(prm, [&](int var, int j) {  // the other blocks' outputs through L2
    return __ldcg(j == 0 ? &primal[(int64_t)var * n + at] : &tang[((int64_t)(j - 1) * N_VARS + var) * n + at]);
  }, coriolis, n0, n, jvp::NB, sq_s);
  __syncthreads();
  sum_partials(sq_s, jvp::NB, scratch + (size_t)N_OUT * n, tickets, sums, blockIdx.x, gridDim.x, last + 1);
}

// ---- float: the CUDA cores, six variables a block ---------------------------------------------

// Points per block: 32 (TM rows a thread), whose v4 form fits a block's shared memory.
constexpr int TM_F32 = 4;
constexpr int NB_F32 = WARPS * TM_F32;

__global__ void __launch_bounds__(THREADS, 1)
residual_sums_f32(const float* __restrict__ pe, const float* __restrict__ dpe,
                  const float* __restrict__ cd, const float* __restrict__ ref_t,
                  const float* __restrict__ coriolis, const float* __restrict__ w1,
                  const float* __restrict__ w1k, const float* __restrict__ b1,
                  const float* __restrict__ w2f1, const float* __restrict__ wdf1,
                  const float* __restrict__ rbias, const float* __restrict__ fw2,
                  const float* __restrict__ w2wo, const float* __restrict__ wdwo,
                  const float* __restrict__ obias, const ResidualParams prm,
                  float* __restrict__ partials, unsigned int* __restrict__ tickets,
                  float* __restrict__ sums, int64_t n, int in_ch, int v6) {
  using T = float;
  constexpr int TM = TM_F32, NB = NB_F32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);   // [NB, HID] f32, stage 1 and 2
  T* t_s = reinterpret_cast<T*>(smem);           // [NB, HID] T, reuses p_s afterwards
  T* Ws = reinterpret_cast<T*>(p_s + NB * HID);  // [KT, HID]
  T* pe_s = Ws + KT * HID;                       // [NB, in_ch]
  T* cd_s = pe_s + NB * in_ch;                   // [NB, in_ch]
  T* d_s = cd_s + NB * in_ch;                    // [3, NB, ch], the v4 form only
  float* out_s = reinterpret_cast<float*>(d_s + (v6 ? 0 : NB * in_ch));  // [N_OUT, NB]
  float* sq_s = out_s + N_OUT * NB;              // [N_EQS, NB] squared residuals
  __shared__ int last;

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

  // ---- the assembly: one thread per point, then the sums ---------------------------------
  assemble(prm, [&](int var, int j) { return out_s[(4 * var + j) * NB + tid]; }, coriolis, n0, n, NB, sq_s);
  __syncthreads();
  sum_partials(sq_s, NB, partials, tickets, sums, blockIdx.x, gridDim.x, &last);
}

size_t f32_shared_bytes(int in_ch, int v6) {
  return ((size_t)NB_F32 * HID + (size_t)KT * HID + (size_t)(v6 ? 2 : 3) * NB_F32 * in_ch +
          (size_t)(N_OUT + N_EQS) * NB_F32) * sizeof(float);
}

// Points per block: 64 in bf16 (the tensor-core body's), NB_F32 in float.
int64_t point_blocks(int is_bf16, int64_t n) {
  const int nb = is_bf16 ? jvp::NB : NB_F32;
  return (n + nb - 1) / nb;
}

size_t tc_shared_bytes(int in_ch, int v6) {
  return jvp::row_region_valid(in_ch, !v6) ? jvp::fwd_smem(in_ch, !v6).total : (size_t)1 << 30;
}

}  // namespace

extern "C" {

// Hidden width the kernel was built for; points per block; the floats of the scratch array
// (`partials`) and the tickets a launch over n points needs; shared memory one block needs at
// this input width.
int dpn_residual_sums_hid() { return dpn::HID; }
int dpn_residual_sums_block(int is_bf16) { return is_bf16 ? dpn::jvp::NB : NB_F32; }
int64_t dpn_residual_sums_scratch_floats(int is_bf16, int64_t n) {
  return (is_bf16 ? (int64_t)N_OUT * n : 0) + point_blocks(is_bf16, n) * N_EQS;
}
int64_t dpn_residual_sums_tickets(int is_bf16, int64_t n) { return 1 + (is_bf16 ? point_blocks(1, n) : 0); }
int dpn_residual_sums_shared_bytes(int is_bf16, int in_ch, int v6) {
  return (int)(is_bf16 ? tc_shared_bytes(in_ch, v6) : f32_shared_bytes(in_ch, v6));
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  v6: 0 for pe [n, in_ch], dpe
// [3, n, in_ch / 3], w1 [6, in_ch, HID] and w1k = w1c; 1 for pe = trig
// [3, n, in_ch / 3], dpe unused, w1 = w1g and w1k = w1t.  ref_t [6, n], coriolis
// [n].  partials holds dpn_residual_sums_scratch_floats floats, tickets
// dpn_residual_sums_tickets zeros; sums [6] is written in full.  Returns
// cudaGetLastError() after the launch (0 on success).
int dpn_residual_sums(int is_bf16, const void* pe, const void* dpe, const void* cd,
                      const float* ref_t, const float* coriolis, const void* w1, const void* w1k,
                      const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
                      const float* fw2, const float* w2wo, const float* wdwo, const float* obias,
                      float* partials, unsigned int* tickets, float* sums,
                      const dpn::ResidualParams* prm, int64_t n, int in_ch, int v6, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int on_tc = is_bf16 != 0;
  const size_t smem = dpn_residual_sums_shared_bytes(on_tc, in_ch, v6);
  const void* fn = on_tc ? (const void*)residual_sums_tc : (const void*)residual_sums_f32;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)point_blocks(on_tc, n);
  if (on_tc) {
    using dpn::jvp::bf16;
    residual_sums_tc<<<dim3(blocks, N_VARS), THREADS, smem, s>>>(
        static_cast<const bf16*>(pe), static_cast<const bf16*>(dpe), static_cast<const bf16*>(cd), ref_t, coriolis,
        static_cast<const bf16*>(w1), static_cast<const bf16*>(w1k), b1, static_cast<const bf16*>(w2f1),
        static_cast<const bf16*>(wdf1), rbias, fw2, w2wo, wdwo, obias, *prm, partials, tickets, sums, n, in_ch, v6);
  } else {
    residual_sums_f32<<<blocks, THREADS, smem, s>>>(
        static_cast<const float*>(pe), static_cast<const float*>(dpe), static_cast<const float*>(cd), ref_t,
        coriolis, static_cast<const float*>(w1), static_cast<const float*>(w1k), b1,
        static_cast<const float*>(w2f1), static_cast<const float*>(wdf1), rbias, fw2, w2wo, wdwo, obias, *prm,
        partials, tickets, sums, n, in_ch, v6);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
