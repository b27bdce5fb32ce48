// The bf16 tensor-core pieces of the exact-softmax attention body: a warp's scores of one 64-key
// slice of a 256-key block, their row maxima, their exponentials and the product of the
// probabilities with V (mma.sync m16n8k16, mma_bf16.cuh).  attention.cu's kernels (the single-tile
// and the flash kernel) and encoder.cu's attention stage are built on them; attention.cu's header
// sets out the design and the rounding.

#pragma once

#include <math.h>

#include "mma_bf16.cuh"

namespace dpn {
namespace attn {

constexpr int BK = 256;  // keys per block: the TPU flash kernel's block_k
constexpr float LOG2E = 1.4426950408889634f;
constexpr int KW = 4;           // warps that share a row group's keys
constexpr int SLICE = BK / KW;  // keys of each key block a warp takes
constexpr int NT8 = SLICE / 8;  // n8 score tiles of a slice

// s[mt][j] = q . k (unscaled) for the warp's m16 row tiles mt and keys 8 j .. 8 j + 7 of
// its slice kt (row stride E + 8); -inf for keys at or past n (key tiles past them are
// not computed).  Each K fragment serves all MT row tiles.
template <int E, int MT>
__device__ __forceinline__ void score_slice(float (&s)[MT][NT8][4], const uint32_t (&qa)[MT][E / 16][4],
                                            const __nv_bfloat16* kt, int n, int lane) {
  constexpr int LD = E + 8;
  // this lane's ldmatrix row: keys 0-7 for matrices 0, 1 and 8-15 for 2, 3; columns
  // 0-7 for matrices 0, 2 and 8-15 for 1, 3
  const __nv_bfloat16* krow = kt + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j2 = 0; j2 < NT8 / 2; ++j2) {
    float c[MT][2][4] = {};
    if (j2 * 16 < n) {
#pragma unroll
      for (int ks = 0; ks < E / 16; ++ks) {
        uint32_t kb[4];
        dpn::mma::ldmatrix_x4(kb, dpn::mma::smem_addr(krow + j2 * 16 * LD + ks * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dpn::mma::mma_16816(c[mt][0], qa[mt][ks], kb[0], kb[1]);
          dpn::mma::mma_16816(c[mt][1], qa[mt][ks], kb[2], kb[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[mt][2 * j2][i] = c[mt][0][i];
        s[mt][2 * j2 + 1][i] = c[mt][1][i];
      }
  }
  if (n < SLICE) {  // a partial slice: the last key block's
    const int t2 = 2 * (lane & 3);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (j * 8 + t2 + (i & 1) >= n) s[mt][j][i] = -INFINITY;
  }
}

// The max over the slice of each of the lane's rows (row tile mt, rows g and g + 8), in
// four independent partial maxima, then over the four lanes of the row.
template <int MT>
__device__ __forceinline__ void slice_max(const float (&s)[MT][NT8][4], float (&mx)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]);
#pragma unroll
      for (int j = 4; j < NT8; ++j) a[j & 3] = fmaxf(a[j & 3], fmaxf(s[mt][j][2 * r], s[mt][j][2 * r + 1]));
      mx[mt][r] = dpn::mma::quad_max(fmaxf(fmaxf(a[0], a[1]), fmaxf(a[2], a[3])));
    }
}

// s <- 2^(s sl2 + nm[row]) (times rl[row] with SCALED) for keys before n, 0 past them;
// sum[row] += the lane's new values, in two interleaved partial sums.  FULL: n covers
// the slice, and no key is tested.
template <int MT, bool FULL, bool SCALED>
__device__ __forceinline__ void exp_slice(float (&s)[MT][NT8][4], float sl2, const float (&nm)[MT][2],
                                          const float (&rl)[MT][2], int n, float (&sum)[MT][2]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float part[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = 0.f;
        if (FULL || j * 8 < n) {
          p = dpn::mma::ex2(fmaf(s[mt][j][i], sl2, nm[mt][i >> 1]));
          if (SCALED) p *= rl[mt][i >> 1];
        }
        part[i >> 1][j & 1] += p;
        s[mt][j][i] = p;
      }
    sum[mt][0] += part[0][0] + part[0][1];
    sum[mt][1] += part[1][0] + part[1][1];
  }
}

// acc[mt] += T(p[mt]) . V over the warp's key slice: p in score registers (0 past n), the
// slice's V tile vt key-major in shared memory (rows past n up to a multiple of 16 are
// zeros).  Each V fragment serves all MT row tiles.
template <int E, int MT>
__device__ __forceinline__ void pv_slice(float (&acc)[MT][E / 8][4], const float (&p)[MT][NT8][4],
                                         const __nv_bfloat16* vt, int n, int lane) {
  constexpr int LD = E + 8;
  // keys 0-7 for matrices 0, 2 and 8-15 for 1, 3; columns 0-7 for 0, 1 and 8-15 for 2, 3
  const __nv_bfloat16* vrow = vt + ((lane & 7) + (((lane >> 3) & 1) << 3)) * LD + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < NT8 / 2; ++kk) {
    if (kk * 16 < n) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = dpn::mma::pack_bf16x2(p[mt][2 * kk][0], p[mt][2 * kk][1]);
        a[mt][1] = dpn::mma::pack_bf16x2(p[mt][2 * kk][2], p[mt][2 * kk][3]);
        a[mt][2] = dpn::mma::pack_bf16x2(p[mt][2 * kk + 1][0], p[mt][2 * kk + 1][1]);
        a[mt][3] = dpn::mma::pack_bf16x2(p[mt][2 * kk + 1][2], p[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int n2 = 0; n2 < E / 16; ++n2) {
        uint32_t vb[4];
        dpn::mma::ldmatrix_x4_trans(vb, dpn::mma::smem_addr(vrow + kk * 16 * LD + n2 * 16));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          dpn::mma::mma_16816(acc[mt][2 * n2], a[mt], vb[0], vb[1]);
          dpn::mma::mma_16816(acc[mt][2 * n2 + 1], a[mt], vb[2], vb[3]);
        }
      }
    }
  }
}

}  // namespace attn
}  // namespace dpn
