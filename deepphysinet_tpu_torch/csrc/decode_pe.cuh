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
// Each product is rounded to f32 once, in the TPU kernel's order; sin and cos are the precise
// ones (no fast math); the values are then rounded to T, the operand's type.
//
// Two front ends compute these rows:
// * front_rows / front_tangent_rows (the float CUDA-core bodies and the prepared inputs of both
//   types): one sinf or cosf a value, rows of [nb, in_ch] and [3, nb, ch] unpadded;
// * PeSource (the bf16 tensor-core bodies, decode_jvp_tc.cuh's forward_block and fix_ties,
//   decode_jvp_v2.cu's v3): one sincosf an angle, whose sine and cosine give the pe pair and
//   the tangent pair of the angle (192 a point at in_ch 192, where the first front end takes
//   576), as bf16 rows at the tensor-core bodies' strides; and, for the recompute of values near
//   a rounding tie, a chunk of one point's row again from its coordinates, by the same
//   expressions, so the bits agree (chip_smoke.py holds both front ends' rows and the
//   recompute's to each other, bit for bit, through dpn_decode_pe_rows).

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

// The in-kernel PE as the layer-1 row source of the bf16 tensor-core bodies (v4pe's forward,
// v3's layer 1): coords [n, 3] and cdata [n, 6] f32, scales [3], fb [F], fb2 [F2].  It takes
// in_ch = 192 (F = 32, ch = 64: a point's chunk of 64 values of fix_ties is one coordinate
// channel, the sines of 32 angles and then their cosines; valid).
struct PeSource {
  static constexpr bool IN_KERNEL = true;
  const float* coords;
  const float* cdata;
  const float* scales;
  const float* fb;
  const float* fb2;
  int64_t n;
  int in_ch;

  static constexpr int F = 32;  // coordinate frequencies
  __host__ __device__ static bool valid(int in_ch) { return in_ch == 6 * F; }
  __device__ __forceinline__ bool tangents_in_primal() const { return false; }

  // sin and cos of coordinate c of the point at frequency f: (x * s_c) * fb[f], each product
  // rounded once
  __device__ __forceinline__ void coord_trig(int64_t point, int c, int f, float& s, float& co) const {
    sincosf(__fmul_rn(__fmul_rn(coords[point * 3 + c], scales[c]), fb[f]), &s, &co);
  }
  // direction c's tangent pair of frequency f from the angle's sine and cosine
  __device__ __forceinline__ float2 tangent_pair(int c, int f, float s, float co) const {
    return make_float2(__fmul_rn(__fmul_rn(co, fb[f]), scales[c]), __fmul_rn(__fmul_rn(-s, fb[f]), scales[c]));
  }

  // The block's rows n0 .. n0 + nb - 1: pe into pe_s (row stride ldp), direction k's tangent
  // rows into dpe_s + k nb ldd (row stride ldd), cd into cd_s (row stride ldp), bf16; rows at or
  // past n are zeros.  Each thread takes two neighbouring frequencies of a channel and stores
  // bf16 pairs.  Plain stores: the caller's next barrier publishes them.
  __device__ __forceinline__ void front(__nv_bfloat16* pe_s, int ldp, __nv_bfloat16* dpe_s, int ldd,
                                        __nv_bfloat16* cd_s, int64_t n0, int nb) const {
    constexpr int F2 = F / 2;
    for (int i = threadIdx.x; i < nb * 3 * (F / 2); i += blockDim.x) {
      const int row = i / (3 * (F / 2)), q = i - row * (3 * (F / 2)), c = q / (F / 2), f = 2 * (q % (F / 2));
      float s[2] = {0.0f, 0.0f}, co[2] = {0.0f, 0.0f};
      float2 t[2] = {make_float2(0.0f, 0.0f), make_float2(0.0f, 0.0f)};
      if (n0 + row < n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          coord_trig(n0 + row, c, f + e, s[e], co[e]);
          t[e] = tangent_pair(c, f + e, s[e], co[e]);
        }
      }
      __nv_bfloat16* p = pe_s + row * ldp + c * 2 * F + f;
      __nv_bfloat16* d = dpe_s + (c * nb + row) * ldd + f;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(s[0], s[1]);
      *reinterpret_cast<__nv_bfloat162*>(p + F) = __floats2bfloat162_rn(co[0], co[1]);
      *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(t[0].x, t[1].x);
      *reinterpret_cast<__nv_bfloat162*>(d + F) = __floats2bfloat162_rn(t[0].y, t[1].y);
    }
    for (int i = threadIdx.x; i < nb * 6 * (F2 / 2); i += blockDim.x) {
      const int row = i / (6 * (F2 / 2)), q = i - row * (6 * (F2 / 2)), c = q / (F2 / 2), f = 2 * (q % (F2 / 2));
      float s[2] = {0.0f, 0.0f}, co[2] = {0.0f, 0.0f};
      if (n0 + row < n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) sincosf(__fmul_rn(cdata[(n0 + row) * 6 + c], fb2[f + e]), &s[e], &co[e]);
      }
      __nv_bfloat16* p = cd_s + row * ldp + c * 2 * F2 + f;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(s[0], s[1]);
      *reinterpret_cast<__nv_bfloat162*>(p + F2) = __floats2bfloat162_rn(co[0], co[1]);
    }
  }

  // Values j and j + F of fix_ties's chunk of a point's row, by front's expressions from one
  // sincosf: coordinate channel c of the primal row (tangent false; the chunk at k0 = 64 c) or
  // direction c's tangent row (tangent true), into chunk[j] and chunk[j + F].  j < F, point < n.
  __device__ __forceinline__ void chunk_pair(int c, bool tangent, int64_t point, int j, __nv_bfloat16* chunk) const {
    float s, co;
    coord_trig(point, c, j, s, co);
    const float2 t = tangent_pair(c, j, s, co);
    chunk[j] = __float2bfloat16_rn(tangent ? t.x : s);
    chunk[j + F] = __float2bfloat16_rn(tangent ? t.y : co);
  }
};

}  // namespace dpn
