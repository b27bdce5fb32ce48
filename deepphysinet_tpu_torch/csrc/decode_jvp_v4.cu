// v4 collapsed decode, forward: primal and three space-time tangents from the
// interleaved PE and the compact tangent input, in either output layout, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/decode_kernel.py that share
// one body: _decode_kernel_v4 with t_layout=False (called through
// fused_decode_jvp_v4, [N, 6] / [3, N, 6] outputs) and with t_layout=True
// (fused_decode_jvp_v4t, [6, N] / [3, 6, N]).  It also stands for
// _decode_kernel_v4t_pipe, the same arithmetic scheduled in another order for the
// TPU's in-order units.  Per point n, variable v and direction k
// (FusedDecodeWeights; ch = in_ch / 3):
//
//   z    = pe[n] . w1[v] + b1[v]                              [HID]
//   p    = relu(z)                                            f32
//   t_k  = T(1[z > 0] * (dpe[k, n] . w1c[v, k]))              stored in T
//   r    = T(p) . w2f1[v] + cd[n] . wdf1[v] + rbias[v]
//   o    = sum(relu(r) * fw2[v]) + 2 (sum(p * w2wo[v]) + sum(cd[n] * wdwo[v]))
//          + obias[v] + ref[n, v]
//   to_k = sum(1[r > 0] * (t_k . w2f1[v]) * fw2[v]) + 2 sum(t_k * w2wo[v])
//
// with the TPU kernel's rounding points (decode_kernel.py:627-634, :548-579):
// matmul inputs in the compute type T, sums in f32, p kept in f32 for the
// w2wo sum, and the masked tangents rounded to T once, so that both
// t_k . w2f1 and the w2wo sum read the rounded values.
//
// What bounds it: 4.92 MFLOP per point (6 variables x 409,600 MACs) against
// about 1,200 bytes of point I/O, so it is compute bound; this first version
// runs the products on the CUDA cores (FMA), not the tensor cores.  Design, as
// for the v4s forward: a block owns NB = 64 points and ONE variable (grid =
// blocks x variables), so blocks are independent and a 4,096-point launch
// still fills the card.  The chain of one variable is decode_common.cuh's
// primal_stages and tangent_stage.  The compact tangent
// rows dpe [3, NB, ch] are as large as the block's pe rows, which the tangents
// do not read, so they are loaded over pe once r is done: the f32 build stays
// inside a block's shared memory without a smaller block.  The ragged last
// block is masked here (zero rows in, no stores out).  The layout flag changes
// only the addresses of the ref load and the output stores, so the two layouts
// give the same bits.

#include "decode_common.cuh"

namespace {

using namespace dpn;

constexpr int TM = 8;            // accumulator rows per thread
constexpr int NB = WARPS * TM;   // points per block

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v4_kernel(const T* __restrict__ pe, const T* __restrict__ dpe,
                     const T* __restrict__ cd, const float* __restrict__ ref,
                     const T* __restrict__ w1, const T* __restrict__ w1c,
                     const float* __restrict__ b1, const T* __restrict__ w2f1,
                     const T* __restrict__ wdf1, const float* __restrict__ rbias,
                     const float* __restrict__ fw2, const float* __restrict__ w2wo,
                     const float* __restrict__ wdwo, const float* __restrict__ obias,
                     float* __restrict__ primal, float* __restrict__ tang, int64_t n, int in_ch,
                     int n_vars, int t_layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);   // [NB, HID] f32, stage 1 and 2
  T* t_s = reinterpret_cast<T*>(smem);           // [NB, HID] T, reuses p_s afterwards
  T* Ws = reinterpret_cast<T*>(p_s + NB * HID);  // [KT, HID]
  T* pe_s = Ws + KT * HID;                       // [NB, in_ch]; then dpe rows [3, NB, ch]
  T* cd_s = pe_s + NB * in_ch;                   // [NB, in_ch]

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3;
  const bool tl = t_layout != 0;

  load_rows<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);

  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0
  float o[TM];
  const T* w2f1_v = w2f1 + (size_t)v * HID * HID;
  primal_stages<T, TM>(pe_s, in_ch, in_ch, w1 + (size_t)v * in_ch * HID, cd_s, in_ch, b1 + v * HID,
                       w2f1_v, wdf1 + (size_t)v * in_ch * HID, rbias + v * HID, fw2 + v * HID,
                       w2wo + v * HID, wdwo + v * in_ch, p_s, Ws, mask, maskr, o);
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t point = n0 + ty * TM + r;
    if (tx == r && point < n) {
      const int64_t at = primal_at(tl, point, v, n, n_vars);
      primal[at] = o[r] + obias[v] + ref[at];
    }
  }

  // The block's compact tangent rows [3, NB, ch] over pe_s: every thread's last
  // read of pe_s (stage 1) lies before the barriers of stage 2's products, and
  // the first barrier of the next product publishes these writes.
  T* d_s = pe_s;
  {
    const T zero = from_f32<T>(0.0f);
    const int per_dir = NB * ch;
    for (int i = tid; i < 3 * per_dir; i += THREADS) {
      const int k = i / per_dir, j = i - k * per_dir;
      const bool live = n0 + j / ch < n;
      d_s[i] = live ? dpe[((size_t)k * n + n0) * ch + j] : zero;
    }
  }

  // tangents, one direction at a time
  for (int k = 0; k < 3; ++k) {
    float to[TM];
    tangent_stage<T, TM>(d_s + k * NB * ch, ch, ch, w1c + ((size_t)v * 3 + k) * ch * HID, w2f1_v,
                         fw2 + v * HID, w2wo + v * HID, t_s, Ws, mask, maskr, to);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t point = n0 + ty * TM + r;
      if (tx == r && point < n) tang[tangent_at(tl, k, point, v, n, n_vars)] = to[r];
    }
  }
}

template <typename T> size_t shared_bytes(int in_ch) {
  return (size_t)NB * HID * sizeof(float) + (size_t)KT * HID * sizeof(T) +
         2 * (size_t)NB * in_ch * sizeof(T);
}

template <typename T>
int launch(const void* pe, const void* dpe, const void* cd, const float* ref, const void* w1,
           const void* w1c, const float* b1, const void* w2f1, const void* wdf1,
           const float* rbias, const float* fw2, const float* w2wo, const float* wdwo,
           const float* obias, float* primal, float* tang, int64_t n, int in_ch, int n_vars,
           int t_layout, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v4_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_jvp_v4_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pe), static_cast<const T*>(dpe), static_cast<const T*>(cd), ref,
      static_cast<const T*>(w1), static_cast<const T*>(w1c), b1, static_cast<const T*>(w2f1),
      static_cast<const T*>(wdf1), rbias, fw2, w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars,
      t_layout);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Hidden width the kernel was built for; shared memory one block needs at this
// input width.
int dpn_decode_jvp_v4_hid() { return dpn::HID; }
int dpn_decode_jvp_v4_shared_bytes(int is_bf16, int in_ch) {
  return (int)(is_bf16 ? shared_bytes<__nv_bfloat16>(in_ch) : shared_bytes<float>(in_ch));
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  t_layout: 0 for ref and
// primal [n, n_vars] and tang [3, n, n_vars]; 1 for [n_vars, n] and
// [3, n_vars, n].  Both outputs are written in full.  Returns
// cudaGetLastError() after the launch (0 on success).
int dpn_decode_jvp_v4(int is_bf16, const void* pe, const void* dpe, const void* cd,
                      const float* ref, const void* w1, const void* w1c, const float* b1,
                      const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
                      const float* w2wo, const float* wdwo, const float* obias, float* primal,
                      float* tang, int64_t n, int in_ch, int n_vars, int t_layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(pe, dpe, cd, ref, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo,
                                 wdwo, obias, primal, tang, n, in_ch, n_vars, t_layout, s);
  return launch<float>(pe, dpe, cd, ref, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias,
                       primal, tang, n, in_ch, n_vars, t_layout, s);
}

}  // extern "C"
