// v4s and v6 collapsed decode, forward: primal and three space-time tangents
// from the trig operand, for Hopper (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/decode_kernel.py that share
// their algebra and their fused weights (FusedDecodeWeightsV6):
// _decode_kernel_v4s (called through fused_decode_jvp_v4s; v6 = 0 here) and
// _decode_kernel_v6 (fused_decode_jvp_v6; v6 = 1).  They differ in where the
// operand lies and where the results go:
//
//   v4s  pe [n, 3 * two_f] channel-major rows; ref and primal [n_vars, n],
//        tangents [3, n_vars, n];
//   v6   trig [3, n, two_f] direction-major; ref and primal [n, n_vars],
//        tangents [3, n, n_vars].
//
// Per point n, variable v and direction k (two_f = in_ch / 3; pe[n] below is the
// channel-major row, which for v6 is trig[0, n] | trig[1, n] | trig[2, n]):
//
//   z    = pe[n] . w1g[v] + b1[v]                            [HID]
//   p    = relu(z)                                           f32
//   t_k  = T(1[z > 0] * (pe[n, k*two_f:(k+1)*two_f] . w1t[v, k]))   stored in T
//   r    = T(p) . w2f1[v] + cd[n] . wdf1[v] + rbias[v]
//   o    = sum(relu(r) * fw2[v]) + 2 (sum(p * w2wo[v]) + sum(cd[n] * wdwo[v]))
//          + obias[v] + ref[v, n]
//   to_k = sum(1[r > 0] * (t_k . w2f1[v]) * fw2[v]) + 2 sum(t_k * w2wo[v])
//
// with the TPU kernels' rounding points (decode_kernel.py:2385-2392, :1963-1969,
// :548-579): matmul inputs in the compute type T, sums in f32, p kept in f32 for
// the w2wo sum, and the masked tangents rounded to T once, so that both
// t_k . w2f1 and the w2wo sum read the rounded values.  The TPU's v6 kernel sums
// z as three K = two_f products; here it is one K = 3 two_f sum in f32, the
// same terms in another order.
//
// What bounds it: 4.92 MFLOP per point (6 variables x 409,600 MACs) against about 900 bytes of
// point I/O, so it is compute bound.  A block owns NB = 64 points and ONE variable (grid =
// blocks x variables), so blocks are independent and a 4,096-point launch still fills the card;
// the ragged last block is masked (zero rows in, no stores out).
//
// bf16 (decode_jvp_v4s_tc, the flagship's type): the products on the tensor cores, in the body
// of the v4 forward (decode_jvp_tc.cuh; design, shared memory and rounding in decode_jvp_v4.cu's
// header), which computes the same function: only the tangent operand differs.  v4 reads it
// from a dpe input of its own; here direction k's tangent rows are lanes k two_f .. of the primal
// rows already in shared memory, so there is no dpe load and no dpe buffer, and the primal rows
// lie under t_2's row set (read until u_2 is done).  fix_ties reads the same lanes from global
// memory.  Shared memory at flagship width (in_ch 192): 226,560 bytes, as v4's (the row sets
// outgrow the primal and dpe rows that lie under them).
//
// float (decode_jvp_v4s_kernel, the parity configuration; no TF32): the products on the CUDA
// cores (FMA), decode_common.cuh's primal_stages and tangent_stage: the tangents are processed
// one direction at a time and w2f1 is streamed four times per block from L2.
//
// The v6 operand is gathered into the channel-major row as it is loaded (by cp.async in bf16),
// so the two forms share everything after the load; a v6 block stores one float per point at a
// stride of n_vars floats.  The v6 forward therefore gives the bits of the v4s forward.

#include "decode_common.cuh"
#include "decode_jvp_tc.cuh"

namespace {

using namespace dpn;

constexpr int TM = 8;            // accumulator rows per thread
constexpr int NB = WARPS * TM;   // points per block
static_assert(NB == jvp::NB, "both bodies take the same points a block");

// ---- bf16: tensor cores -----------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v4s_tc(const jvp::bf16* __restrict__ pe, const jvp::bf16* __restrict__ cd,
                  const float* __restrict__ ref, const jvp::bf16* __restrict__ w1g,
                  const jvp::bf16* __restrict__ w1t, const float* __restrict__ b1,
                  const jvp::bf16* __restrict__ w2f1, const jvp::bf16* __restrict__ wdf1,
                  const float* __restrict__ rbias, const float* __restrict__ fw2,
                  const float* __restrict__ w2wo, const float* __restrict__ wdwo,
                  const float* __restrict__ obias, float* __restrict__ primal,
                  float* __restrict__ tang, int64_t n, int in_ch, int n_vars, int v6) {
  const int v = blockIdx.y;
  const jvp::RowSource src{v6 ? nullptr : pe, v6 ? pe : nullptr, n, in_ch};
  jvp::forward_block(src, cd, ref, w1g + (size_t)v * in_ch * HID, w1t + (size_t)v * in_ch * HID, b1, w2f1,
                     wdf1, rbias, fw2, w2wo, wdwo, obias, primal, tang, n_vars, v6 == 0);
}

int launch_tc(const void* pe, const void* cd, const float* ref, const void* w1g, const void* w1t,
              const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
              const float* fw2, const float* w2wo, const float* wdwo, const float* obias,
              float* primal, float* tang, int64_t n, int in_ch, int n_vars, int v6,
              cudaStream_t stream) {
  if (!jvp::row_region_valid(in_ch, false)) return (int)cudaErrorInvalidValue;
  const size_t smem = jvp::fwd_smem(in_ch, false).total;
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v4s_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  using jvp::bf16;
  const dim3 grid((unsigned)((n + jvp::NB - 1) / jvp::NB), (unsigned)n_vars);
  decode_jvp_v4s_tc<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(pe), static_cast<const bf16*>(cd), ref, static_cast<const bf16*>(w1g),
      static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2f1), static_cast<const bf16*>(wdf1),
      rbias, fw2, w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars, v6);
  return (int)cudaGetLastError();
}

// ---- float: CUDA cores ---------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v4s_kernel(const T* __restrict__ pe, const T* __restrict__ cd,
                      const float* __restrict__ ref, const T* __restrict__ w1g,
                      const T* __restrict__ w1t, const float* __restrict__ b1,
                      const T* __restrict__ w2f1, const T* __restrict__ wdf1,
                      const float* __restrict__ rbias, const float* __restrict__ fw2,
                      const float* __restrict__ w2wo, const float* __restrict__ wdwo,
                      const float* __restrict__ obias, float* __restrict__ primal,
                      float* __restrict__ tang, int64_t n, int in_ch, int n_vars, int v6) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);   // [NB, HID] f32, stage 1 and 2
  T* t_s = reinterpret_cast<T*>(smem);           // [NB, HID] T, reuses p_s afterwards
  T* Ws = reinterpret_cast<T*>(p_s + NB * HID);  // [KT, HID]
  T* pe_s = Ws + KT * HID;                       // [NB, in_ch]
  T* cd_s = pe_s + NB * in_ch;                   // [NB, in_ch]

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int two_f = in_ch / 3;
  const bool var_major = v6 == 0;

  if (v6)
    load_rows_dm<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
  else
    load_rows<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);

  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0
  float o[TM];
  const T* w2f1_v = w2f1 + (size_t)v * HID * HID;
  primal_stages<T, TM>(pe_s, in_ch, in_ch, w1g + (size_t)v * in_ch * HID, cd_s, in_ch,
                       b1 + v * HID, w2f1_v, wdf1 + (size_t)v * in_ch * HID, rbias + v * HID,
                       fw2 + v * HID, w2wo + v * HID, wdwo + v * in_ch, p_s, Ws, mask, maskr, o);
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t point = n0 + ty * TM + r;
    if (tx == r && point < n) {
      const int64_t at = primal_at(var_major, point, v, n, n_vars);
      primal[at] = o[r] + obias[v] + ref[at];
    }
  }

  // tangents, one direction at a time: lanes k*two_f:(k+1)*two_f of the same rows
  for (int k = 0; k < 3; ++k) {
    float to[TM];
    tangent_stage<T, TM>(pe_s + k * two_f, in_ch, two_f, w1t + ((size_t)v * 3 + k) * two_f * HID,
                         w2f1_v, fw2 + v * HID, w2wo + v * HID, t_s, Ws, mask, maskr, to);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t point = n0 + ty * TM + r;
      if (tx == r && point < n) tang[tangent_at(var_major, k, point, v, n, n_vars)] = to[r];
    }
  }
}

template <typename T> size_t shared_bytes(int in_ch) {
  return (size_t)NB * HID * sizeof(float) + (size_t)KT * HID * sizeof(T) +
         2 * (size_t)NB * in_ch * sizeof(T);
}

template <typename T>
int launch(const void* pe, const void* cd, const float* ref, const void* w1g, const void* w1t,
           const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
           const float* fw2, const float* w2wo, const float* wdwo, const float* obias,
           float* primal, float* tang, int64_t n, int in_ch, int n_vars, int v6,
           cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v4s_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_jvp_v4s_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pe), static_cast<const T*>(cd), ref, static_cast<const T*>(w1g),
      static_cast<const T*>(w1t), b1, static_cast<const T*>(w2f1), static_cast<const T*>(wdf1),
      rbias, fw2, w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars, v6);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Hidden width the kernel was built for; shared memory one block needs at this
// input width.
int dpn_decode_jvp_v4s_hid() { return dpn::HID; }
int dpn_decode_jvp_v4s_block() { return NB; }  // points a block takes, both bodies
int dpn_decode_jvp_v4s_shared_bytes(int is_bf16, int in_ch) {
  if (!is_bf16) return (int)shared_bytes<float>(in_ch);
  return jvp::row_region_valid(in_ch, false) ? (int)jvp::fwd_smem(in_ch, false).total : 1 << 30;
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  v6: 0 for pe [n, in_ch], ref
// and primal [n_vars, n] and tang [3, n_vars, n]; 1 for pe = trig [3, n, in_ch / 3],
// ref and primal [n, n_vars] and tang [3, n, n_vars].  Both outputs are written in
// full.  Returns cudaGetLastError() after the launch (0 on success).
int dpn_decode_jvp_v4s(int is_bf16, const void* pe, const void* cd, const float* ref,
                       const void* w1g, const void* w1t, const float* b1, const void* w2f1,
                       const void* wdf1, const float* rbias, const float* fw2,
                       const float* w2wo, const float* wdwo, const float* obias, float* primal,
                       float* tang, int64_t n, int in_ch, int n_vars, int v6, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tc(pe, cd, ref, w1g, w1t, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, primal, tang,
                     n, in_ch, n_vars, v6, s);
  return launch<float>(pe, cd, ref, w1g, w1t, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias,
                       primal, tang, n, in_ch, n_vars, v6, s);
}

}  // extern "C"
