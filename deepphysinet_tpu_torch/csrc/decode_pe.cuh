// The point front end of the jvp decode kernels (decode_jvp_v2.cu, decode_jvp_v4.cu): the
// block's rows of the primal operand pe, of the conditioning operand cd and of the three
// tangent operands, either loaded as prepared by the wrapper or computed in the kernel from
// raw coordinates and conditioning values (the in-kernel PE of the TPU kernels
// _decode_kernel_v3 and _decode_kernel_v4pe, deepphysinet_tpu/ops/decode_kernel.py:307-360,
// :1249-1284).
//
// The in-kernel PE is channel-major.  With cn = coords * scales (one f32 product, as XLA
// forms it in the TPU wrapper), F coordinate and F2 = F / 2 conditioning frequencies:
//   pe[n, c*2F + j]      = sin(cn[n, c] * fb[j]) for j < F, cos(cn[n, c] * fb[j - F]) after;
//   tangent k [n, j]     = (cos(a) * fb[j]) * scales[k] for j < F,
//                          ((-sin(a)) * fb[j - F]) * scales[k] after, a = cn[n, k] * fb[.];
//   cd[n, c*2F2 + j]     = sin / cos of cdata[n, c] * fb2[.] likewise, c < 6.
// Each product is rounded to f32 once, in the TPU kernel's order; sinf and cosf are the
// precise ones (no fast math); the values are then rounded to T, the operand's type.

#pragma once

#include "decode_common.cuh"

namespace dpn {

// The per-point inputs of one launch.  Prepared (PE = false): pe [n, in_ch], dpe
// [3, n, in_ch / 3] and cd [n, in_ch] of T, ref [n, n_vars] f32.  In-kernel (PE = true):
// coords [n, 3] and cdata [n, 6] f32 (cdata is also the reference value), scales [3],
// fb [in_ch / 6], fb2 [in_ch / 12] f32.
struct PointInputs {
  const void* pe;
  const void* dpe;
  const void* cd;
  const float* ref;
  const float* coords;
  const float* cdata;
  const float* scales;
  const float* fb;
  const float* fb2;
};

// out[row, c * 2f + j] for rows [0, nb) and channels [0, n_ch): sin / cos of
// (x[n0 + row, c] (* scale[c])) * fb[j mod f]; rows past n are zero.
template <typename T>
__device__ __forceinline__ void trig_rows(const float* __restrict__ x, int n_ch,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ fb, int f, T* out, int64_t n0,
                                          int64_t n, int nb) {
  const int width = n_ch * 2 * f;
  for (int i = threadIdx.x; i < nb * width; i += THREADS) {
    const int row = i / width, col = i - row * width;
    const int c = col / (2 * f), j = col - c * 2 * f;
    float v = 0.0f;
    if (n0 + row < n) {
      float xc = x[(n0 + row) * n_ch + c];
      if (scale != nullptr) xc = __fmul_rn(xc, scale[c]);
      const float a = __fmul_rn(xc, fb[j < f ? j : j - f]);
      v = j < f ? sinf(a) : cosf(a);
    }
    out[i] = from_f32<T>(v);
  }
}

// The block's primal rows pe_s [nb, in_ch] and cd_s [nb, in_ch].
template <typename T, bool PE>
__device__ __forceinline__ void front_rows(const PointInputs& in, T* pe_s, T* cd_s, int64_t n0,
                                           int64_t n, int nb, int in_ch) {
  if constexpr (PE) {
    trig_rows<T>(in.coords, 3, in.scales, in.fb, in_ch / 6, pe_s, n0, n, nb);
    trig_rows<T>(in.cdata, 6, nullptr, in.fb2, in_ch / 12, cd_s, n0, n, nb);
  } else {
    load_rows<T>(static_cast<const T*>(in.pe), static_cast<const T*>(in.cd), pe_s, cd_s, n0, n,
                 nb, in_ch);
  }
}

// The block's tangent rows d_s [3, nb, ch] with ch = in_ch / 3; rows past n are zero.
template <typename T, bool PE>
__device__ __forceinline__ void front_tangent_rows(const PointInputs& in, T* d_s, int64_t n0,
                                                   int64_t n, int nb, int in_ch) {
  const int ch = in_ch / 3, per_dir = nb * ch;
  for (int i = threadIdx.x; i < 3 * per_dir; i += THREADS) {
    const int k = i / per_dir, j = i - k * per_dir;
    const int row = j / ch, col = j - row * ch;
    const bool live = n0 + row < n;
    if constexpr (PE) {
      const int f = ch / 2;
      float v = 0.0f;
      if (live) {
        const float b = in.fb[col < f ? col : col - f];
        const float a = __fmul_rn(__fmul_rn(in.coords[(n0 + row) * 3 + k], in.scales[k]), b);
        const float d = col < f ? cosf(a) : -sinf(a);
        v = __fmul_rn(__fmul_rn(d, b), in.scales[k]);
      }
      d_s[i] = from_f32<T>(v);
    } else {
      d_s[i] = live ? static_cast<const T*>(in.dpe)[((size_t)k * n + n0) * ch + j]
                    : from_f32<T>(0.0f);
    }
  }
}

}  // namespace dpn
