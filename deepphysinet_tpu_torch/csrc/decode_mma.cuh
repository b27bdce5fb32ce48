// Shared device code of the decode kernels whose bf16 products run on the tensor cores
// (decode_jvp_v4.cu's v4 body, decode_primal.cu): a warp's tile of a row-times-weight
// product by mma.sync m16n8k16 (mma_bf16.cuh), the cp.async copies of the block's point rows
// and of weight tiles into shared memory, and the ring of weight tiles that keeps the next
// tiles' copies in flight while a tile is multiplied.
//
// Layout.  Every bf16 array in shared memory is row-major with a row stride of cols + 8
// elements (ld_of): for cols a multiple of 64 the stride is 16 bytes past a multiple of 128,
// so the eight 16-byte rows of any 8 x 8 matrix that ldmatrix reads lie in distinct banks.
// A operands (point rows: pe, cd, dpe, T(p), t_k) are read with ldmatrix_x4, weight tiles
// [K, cols] (row-major, as the weights lie in global memory) with ldmatrix_x4_trans.  A
// warp's tile is MT m16 row tiles (row tile mt at a byte offset of mt * a_mt from the first)
// by NT n8 column tiles; accumulator acc[mt][nt][i] holds row 16 mt + g + 8 (i >> 1) and
// column 8 nt + 2 t + (i & 1), with g = lane >> 2 and t = lane & 3 (mma_bf16.cuh).
//
// Rounding: both operands are bf16 (exact products), sums in f32: the TPU kernels'
// dot(..., preferred_element_type=f32) on bf16 inputs.

#pragma once

#include "decode_common.cuh"
#include "mma_bf16.cuh"

namespace dpn {
namespace tc {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int ld_of(int cols) { return cols + 8; }

template <typename T> __host__ __device__ constexpr T max_of(T a, T b) { return a > b ? a : b; }

// This lane's ldmatrix row address in an A tile (rows 0-15, columns 0-15 from `tile`) and
// in a weight tile read transposed (k rows 0-15, columns 0-15 from `tile`).
__device__ __forceinline__ uint32_t a_lane(const bf16* tile, int ld, int lane) {
  return mma::smem_addr(tile + (lane & 15) * ld + ((lane >> 4) << 3));
}
__device__ __forceinline__ uint32_t b_lane(const bf16* tile, int ld, int lane) {
  return mma::smem_addr(tile + ((lane & 7) + (((lane >> 3) & 1) << 3)) * ld + ((lane >> 4) << 3));
}

// acc[0:MT] += A[., 0:16 KS] . W[0:16 KS, 0:8 NT]: a and b are this lane's addresses
// (a_lane, b_lane) at k = 0; a_mt is the byte offset between row tiles, b_k16 the bytes of
// 16 weight rows.  Each A fragment feeds NT products and each weight fragment MT.  The
// first RN row tiles take each k16 product into zeros and add it to acc with an f32 add
// (round to nearest); the others accumulate inside the tensor core.
template <int MT, int NT, int KS, int RN = 0>
__device__ __forceinline__ void warp_mma(float (*acc)[NT][4], uint32_t a, uint32_t a_mt, uint32_t b,
                                         uint32_t b_k16) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma::ldmatrix_x4(af[mt], a + mt * a_mt + ks * 32);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t bf[4];
      mma::ldmatrix_x4_trans(bf, b + ks * b_k16 + j * 32);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < RN) {
          float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma::mma_16816(d0, af[mt], bf[0], bf[1]);
          mma::mma_16816(d1, af[mt], bf[2], bf[3]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][2 * j][i] += d0[i];
            acc[mt][2 * j + 1][i] += d1[i];
          }
        } else {
          mma::mma_16816(acc[mt][2 * j], af[mt], bf[0], bf[1]);
          mma::mma_16816(acc[mt][2 * j + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
}

template <int MT, int NT> __device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
}

// rows x COLS bf16 from global memory (row stride ld_src elements, 16-byte aligned rows) to
// shared memory (row stride ld), by cp.async.
template <int COLS>
__device__ __forceinline__ void tile_async(bf16* dst, int ld, const bf16* __restrict__ src,
                                           int ld_src, int rows) {
  constexpr int VEC = COLS / 8;
  for (int i = threadIdx.x; i < rows * VEC; i += blockDim.x) {
    const int r = i / VEC, c = (i - r * VEC) * 8;
    mma::cp_async16(mma::smem_addr(dst + r * ld + c), src + (size_t)r * ld_src + c, true);
  }
}

// Rows n0 .. n0 + nb - 1 of a [n, cols] array into shared memory (row stride ld), by
// cp.async; rows at or past n are zeros (a NaN pattern left there would survive a product
// with a zero weight).
__device__ __forceinline__ void rows_async(bf16* dst, int ld, const bf16* __restrict__ src,
                                           int64_t n0, int64_t n, int nb, int cols) {
  const int vec = cols / 8;
  for (int i = threadIdx.x; i < nb * vec; i += blockDim.x) {
    const int r = i / vec, c = (i - r * vec) * 8;
    const bool live = n0 + r < n;
    mma::cp_async16(mma::smem_addr(dst + r * ld + c), live ? src + (n0 + r) * cols + c : src, live);
  }
}

// The sums over the four lanes of a row of the lane's partial per-row sums s[mt][h] (row
// 16 mt + g + 8 h), written by the row's first lane to out[row].
template <int MT>
__device__ __forceinline__ void store_row_sums(float (&s)[MT][2], float* out, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = mma::quad_sum(s[mt][h]);
      if ((lane & 3) == 0) out[16 * mt + (lane >> 2) + 8 * h] = v;
    }
}

// sum_k T(cd[row, k]) * wdwo[k] for rows [0, nb) of cd_s (row stride ld), nb / WARPS rows a
// warp, lanes striding over k; written to out[row].
__device__ __forceinline__ void cd_sums(const bf16* cd_s, int ld, int in_ch,
                                        const float* __restrict__ wdwo, int nb, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, per_warp = nb / WARPS;
  for (int r = 0; r < per_warp; ++r) {
    const int row = warp * per_warp + r;
    float s = 0.0f;
    for (int k = lane; k < in_ch; k += 32) s = fmaf(to_f32(cd_s[row * ld + k]), wdwo[k], s);
    s = warp_sum(s);
    if (lane == 0) out[row] = s;
  }
}

// A ring of NS weight tiles in shared memory (slots of slot_bytes from base), filled by
// cp.async: tile i lands in slot i % NS, and tiles i + 1 .. i + NS - 2 are in flight while
// tile i is multiplied.  issue(i, slot) starts the copies of tile i (called for i < total
// only).  Each fill commits one group, so that cp.async.wait_group NS - 2 in next() finds
// the tile complete; copies the caller issued before start() join the first group.
template <int NS, typename Issue>
struct TileRing {
  unsigned char* base;
  int slot_bytes, total, tile;
  Issue issue;

  __device__ __forceinline__ void fill(int i) {
    if (i < total) issue(i, base + (i % NS) * slot_bytes);
    mma::cp_async_commit();
  }
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int i = 0; i < NS - 1; ++i) fill(i);
  }
  // The next tile, complete and visible to the whole block.  The barrier also tells that
  // every warp is done with the tile before it, whose slot the fill below reuses, and
  // publishes the caller's shared-memory writes made before the call.
  __device__ __forceinline__ const bf16* next() {
    mma::cp_async_wait<NS - 2>();
    __syncthreads();
    fill(tile + NS - 1);
    return reinterpret_cast<const bf16*>(base + (tile++ % NS) * slot_bytes);
  }
};

template <int NS, typename Issue>
__device__ __forceinline__ TileRing<NS, Issue> make_ring(unsigned char* base, int slot_bytes,
                                                         int total, Issue issue) {
  return TileRing<NS, Issue>{base, slot_bytes, total, 0, issue};
}

}  // namespace tc
}  // namespace dpn
