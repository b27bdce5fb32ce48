// Primal-only collapsed decode, var-major output, for Hopper (sm_90a).
//
// Replaces the TPU kernel deepphysinet_tpu/ops/decode_kernel.py::
// _decode_kernel_v4_primal (called through decode_primal_v4t).  Per point n
// and output variable v (FusedDecodeWeights, collapsed v4 algebra):
//
//   p   = relu(pe[n] . w1[v] + b1[v])                       [HID], f32
//   r   = T(p) . w2f1[v] + cd[n] . wdf1[v] + rbias[v]       [HID], f32
//   out = sum(relu(r) * fw2[v]) + 2 (sum(p * w2wo[v]) + sum(cd[n] * wdwo[v]))
//         + obias[v] + ref_t[v, n]
//
// with the TPU kernel's rounding points: matmul inputs in the compute type T
// (bf16 for the flagship, float for parity runs), products accumulated in
// f32, p kept in f32 for the w2wo sum and rounded to T only as the w2f1
// product's input (decode_kernel.py:986-996).
//
// What bounds it: 1.97 MFLOP per point (6 variables x 163,840 MACs) against
// about 800 bytes of point I/O, so it is compute bound.  Each block computes all
// six variables for its points, so blocks are independent and no cross-block
// reduction exists; the ragged last block is masked here (zero rows in, no stores out)
// instead of padding N on the host.  relu(r) is folded into the output sums in
// registers, so r is never stored.
//
// bf16 (decode_primal_tc): the products on the tensor cores (mma.sync m16n8k16), built
// from decode_mma.cuh as the v4 kernel's stages are, without the tangent rows.  A block
// owns NB = 128 points: the weights of the six variables (1.9 MB in bf16, resident in
// L2) are read once per block, 15 KB a point at flagship width, where 64-point blocks
// read 30 KB.  Per variable, z and then r go in two passes of 128 columns (the
// accumulators of 128 points over all 256 columns would need 128 registers a thread);
// warp w holds points 64 (w & 1) .. + 63 and columns 32 (w >> 1) .. + 31 of a pass.
// The z epilogue writes T(p) as bf16 rows [NB, HID] (the TPU kernel's rounding) and sums
// p * w2wo from the f32 values; cd . wdf1 goes into r's accumulator; per-point sums by
// quad shuffles, then across the four column groups through shared memory in a fixed
// order.  The weights come by cp.async in [64, 128] tiles through a ring of three slots,
// the next tiles' copies in flight while one is multiplied.  Shared memory at flagship
// width (in_ch 192): pe and cd rows (2 x 51,200 bytes), T(p) (67,584), the ring
// (3 x 17,408), partial sums (4,608): 226,816 bytes (PrimalSmem).  The tensor cores sum
// z in another order than the plain version (cuBLAS: one FMA a term), so some T(p)
// elements round one bf16 step the other way (1,669 of the 57 M of one flagship frame
// with exact sums in place of cuBLAS's); the output is continuous in
// T(p), and one such step moves it by about 1e-4 of its scale (on an NVIDIA H100 80GB
// HBM3 at 700 W: 6.5e-3 at most against a largest output of 37 over one flagship frame,
// where chip_smoke.py's bound is 3.8e-2).  The v4 kernel, whose tangents are not
// continuous in T(p), recomputes z near a rounding tie; this kernel does not need to.
//
// float (decode_primal_kernel, the parity configuration; no TF32): the products on the
// CUDA cores with decode_common.cuh's block_gemm.  A block owns 64 points; each of
// the 256 threads holds an 8 x 8 accumulator tile (rows ty*8.., columns tx + 32c); p
// [64, HID] stays in shared memory in f32 between the two stages, and the weights are
// streamed through shared memory in KT-row tiles.

#include "decode_common.cuh"
#include "decode_mma.cuh"

namespace {

using namespace dpn;
using tc::bf16;
using tc::ld_of;

// ---- bf16: tensor cores -------------------------------------------------------------

constexpr int NB = 128;          // points per block
constexpr int NS = 3;            // weight tiles in the ring
constexpr int TILE_ROWS = 64;    // weight rows of a tile [64, PASS]
constexpr int PASS = 128;        // hidden columns of a pass
constexpr int LDP_S = ld_of(HID);

// Byte offsets of the bf16 kernel's shared memory at input width in_ch: pe and cd rows
// [NB, in_ch], T(p) [NB, HID], the ring, the per-point partial sums ([4 column groups][2]
// [NB]: p . w2wo, relu(r) . fw2) and cd . wdwo ([NB]).
struct PrimalSmem {
  int ldp;
  size_t cd, p, ring, slot, red, redc, total;
};

__host__ __device__ inline PrimalSmem primal_smem(int in_ch) {
  PrimalSmem s;
  s.ldp = ld_of(in_ch);
  const size_t rows = (size_t)NB * s.ldp * sizeof(bf16);
  s.cd = rows;
  s.p = 2 * rows;
  s.ring = s.p + (size_t)NB * LDP_S * sizeof(bf16);
  s.slot = (size_t)TILE_ROWS * ld_of(PASS) * sizeof(bf16);
  s.red = s.ring + NS * s.slot;
  s.redc = s.red + (size_t)4 * 2 * NB * sizeof(float);
  s.total = s.redc + (size_t)NB * sizeof(float);
  return s;
}

__global__ void __launch_bounds__(THREADS, 1)
decode_primal_tc(const bf16* __restrict__ pe, const bf16* __restrict__ cd,
                 const float* __restrict__ ref_t, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2f1,
                 const bf16* __restrict__ wdf1, const float* __restrict__ rbias,
                 const float* __restrict__ fw2, const float* __restrict__ w2wo,
                 const float* __restrict__ wdwo, const float* __restrict__ obias,
                 float* __restrict__ out, int64_t n, int in_ch, int n_vars) {
  extern __shared__ __align__(16) unsigned char smem[];
  const PrimalSmem L = primal_smem(in_ch);
  bf16* pe_s = reinterpret_cast<bf16*>(smem);
  bf16* cd_s = reinterpret_cast<bf16*>(smem + L.cd);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L.p);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* redc = reinterpret_cast<float*>(smem + L.redc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, t2 = 2 * (lane & 3);
  const int ph = warp & 1, cq = warp >> 1;  // points 64 ph .., columns 32 cq .. of a pass
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ldp = L.ldp;

  // the block's rows, in the ring's first group
  tc::rows_async(pe_s, ldp, pe, n0, n, NB, in_ch);
  tc::rows_async(cd_s, ldp, cd, n0, n, NB, in_ch);

  // per variable, in the order they are multiplied: w1 for each of the two passes, then
  // per pass w2f1 and wdf1; every tile [64, 128]
  const int nk = in_ch / TILE_ROWS, nh = HID / TILE_ROWS;
  const int per_var = 2 * nk + 2 * (nh + nk);
  auto issue = [=](int i, unsigned char* slot) {
    const int v = i / per_var;
    int r = i - v * per_var;
    const bf16* src;
    if (r < 2 * nk) {
      const int c = r / nk, j = r - c * nk;
      src = w1 + ((size_t)v * in_ch + j * TILE_ROWS) * HID + c * PASS;
    } else {
      r -= 2 * nk;
      const int c = r / (nh + nk), j = r - c * (nh + nk);
      src = j < nh ? w2f1 + ((size_t)v * HID + j * TILE_ROWS) * HID + c * PASS
                   : wdf1 + ((size_t)v * in_ch + (j - nh) * TILE_ROWS) * HID + c * PASS;
    }
    tc::tile_async<PASS>(reinterpret_cast<bf16*>(slot), ld_of(PASS), src, HID, TILE_ROWS);
  };
  auto ring = tc::make_ring<NS>(smem + L.ring, (int)L.slot, n_vars * per_var, issue);
  ring.start();

  constexpr uint32_t K16 = 16 * ld_of(PASS) * sizeof(bf16);
  const uint32_t a_mt_p = 16 * ldp * sizeof(bf16), a_mt_s = 16 * LDP_S * sizeof(bf16);
  float acc[4][4][4];
#pragma unroll 1
  for (int v = 0; v < n_vars; ++v) {
    float s_p[4][2] = {}, s_r[4][2] = {};
    // z = pe . w1 + b1, p = relu(z): T(p) to p_s, sum(p * w2wo) from the f32 values
#pragma unroll 1
    for (int c = 0; c < HID / PASS; ++c) {
      tc::zero_acc(acc);
      for (int j = 0; j < nk; ++j) {
        const uint32_t b = tc::b_lane(ring.next() + 32 * cq, ld_of(PASS), lane);
        tc::warp_mma<4, 4, 4>(acc, tc::a_lane(pe_s + 64 * ph * ldp + j * TILE_ROWS, ldp, lane), a_mt_p,
                              b, K16);
      }
      if (c == 0) tc::cd_sums(cd_s, ldp, in_ch, wdwo + v * in_ch, NB, redc);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c * PASS + 32 * cq + 8 * nt + t2;
        const float bias0 = b1[v * HID + col], bias1 = b1[v * HID + col + 1];
        const float wo0 = w2wo[v * HID + col], wo1 = w2wo[v * HID + col + 1];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p0 = fmaxf(acc[mt][nt][2 * h] + bias0, 0.0f);
            const float p1 = fmaxf(acc[mt][nt][2 * h + 1] + bias1, 0.0f);
            s_p[mt][h] = fmaf(p1, wo1, fmaf(p0, wo0, s_p[mt][h]));
            const int row = 64 * ph + 16 * mt + (lane >> 2) + 8 * h;
            *reinterpret_cast<uint32_t*>(p_s + row * LDP_S + col) = mma::pack_bf16x2(p0, p1);
          }
      }
    }
    // r = T(p) . w2f1 + cd . wdf1 + rbias; sum(relu(r) * fw2)
#pragma unroll 1
    for (int c = 0; c < HID / PASS; ++c) {
      tc::zero_acc(acc);
      for (int j = 0; j < nh; ++j) {
        const uint32_t b = tc::b_lane(ring.next() + 32 * cq, ld_of(PASS), lane);
        tc::warp_mma<4, 4, 4>(acc, tc::a_lane(p_s + 64 * ph * LDP_S + j * TILE_ROWS, LDP_S, lane), a_mt_s,
                              b, K16);
      }
      for (int j = 0; j < nk; ++j) {
        const uint32_t b = tc::b_lane(ring.next() + 32 * cq, ld_of(PASS), lane);
        tc::warp_mma<4, 4, 4>(acc, tc::a_lane(cd_s + 64 * ph * ldp + j * TILE_ROWS, ldp, lane), a_mt_p,
                              b, K16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = c * PASS + 32 * cq + 8 * nt + t2;
        const float rb0 = rbias[v * HID + col], rb1 = rbias[v * HID + col + 1];
        const float f0 = fw2[v * HID + col], f1 = fw2[v * HID + col + 1];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            s_r[mt][h] = fmaf(fmaxf(acc[mt][nt][2 * h] + rb0, 0.0f), f0, s_r[mt][h]);
            s_r[mt][h] = fmaf(fmaxf(acc[mt][nt][2 * h + 1] + rb1, 0.0f), f1, s_r[mt][h]);
          }
      }
    }
    tc::store_row_sums(s_p, red + (cq * 2) * NB + 64 * ph, lane);
    tc::store_row_sums(s_r, red + (cq * 2 + 1) * NB + 64 * ph, lane);
    __syncthreads();
    const int row = threadIdx.x;
    if (row < NB && n0 + row < n) {
      float sp = 0.0f, sr = 0.0f;
      for (int q = 0; q < 4; ++q) {
        sp += red[(q * 2) * NB + row];
        sr += red[(q * 2 + 1) * NB + row];
      }
      const int64_t o = (int64_t)v * n + n0 + row;
      out[o] = sr + 2.0f * (sp + redc[row]) + obias[v] + ref_t[o];
    }
  }
}

int launch_tc(const void* pe, const void* cd, const float* ref_t, const void* w1, const float* b1,
              const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
              const float* w2wo, const float* wdwo, const float* obias, float* out, int64_t n,
              int in_ch, int n_vars, cudaStream_t stream) {
  const size_t smem = primal_smem(in_ch).total;
  cudaError_t err = cudaFuncSetAttribute(decode_primal_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + NB - 1) / NB);
  decode_primal_tc<<<blocks, THREADS, smem, stream>>>(
      static_cast<const bf16*>(pe), static_cast<const bf16*>(cd), ref_t, static_cast<const bf16*>(w1), b1,
      static_cast<const bf16*>(w2f1), static_cast<const bf16*>(wdf1), rbias, fw2, w2wo, wdwo, obias, out, n,
      in_ch, n_vars);
  return (int)cudaGetLastError();
}

// ---- float: CUDA cores -------------------------------------------------------------------

constexpr int NB_F32 = 64;   // points per block
constexpr int TM = 8;        // accumulator rows per thread

static_assert(WARPS * TM == NB_F32, "one warp per TM rows");

size_t shared_bytes_f32(int in_ch) {
  return (size_t)NB_F32 * HID * sizeof(float) + (size_t)KT * HID * sizeof(float) +
         2 * (size_t)NB_F32 * in_ch * sizeof(float);
}

__global__ void __launch_bounds__(THREADS, 1)
decode_primal_kernel(const float* __restrict__ pe, const float* __restrict__ cd,
                     const float* __restrict__ ref_t, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ w2f1,
                     const float* __restrict__ wdf1, const float* __restrict__ rbias,
                     const float* __restrict__ fw2, const float* __restrict__ w2wo,
                     const float* __restrict__ wdwo, const float* __restrict__ obias,
                     float* __restrict__ out, int64_t n, int in_ch, int n_vars) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);  // [NB_F32, HID]
  float* Ws = p_s + NB_F32 * HID;               // [KT, HID]
  float* pe_s = Ws + KT * HID;                  // [NB_F32, in_ch]
  float* cd_s = pe_s + NB_F32 * in_ch;          // [NB_F32, in_ch]

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int64_t n0 = (int64_t)blockIdx.x * NB_F32;
  load_rows<float>(pe, cd, pe_s, cd_s, n0, n, NB_F32, in_ch);  // rows past n: zeros, never stored

  for (int v = 0; v < n_vars; ++v) {
    float acc[TM][TN];
    // stage 1: p = relu(pe . w1 + b1), kept in shared memory in f32
    zero_tile<TM>(acc);
    block_gemm<float, float, TM>(pe_s, in_ch, w1 + (size_t)v * in_ch * HID, in_ch, Ws, acc);
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const float bias = b1[v * HID + tx + 32 * c];
#pragma unroll
      for (int r = 0; r < TM; ++r)
        p_s[(ty * TM + r) * HID + tx + 32 * c] = fmaxf(acc[r][c] + bias, 0.0f);
    }

    // stage 2: r = p . w2f1 + cd . wdf1 (+ rbias below)
    zero_tile<TM>(acc);
    block_gemm<float, float, TM>(p_s, HID, w2f1 + (size_t)v * HID * HID, HID, Ws, acc);
    block_gemm<float, float, TM>(cd_s, in_ch, wdf1 + (size_t)v * in_ch * HID, in_ch, Ws, acc);

    // epilogue: the three lane reductions; every value read below was
    // written by this thread (p_s) or was published by the gemms' barriers
    float s_r[TM], s_p[TM], s_c[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) s_r[r] = s_p[r] = s_c[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = tx + 32 * c;
      const float rb = rbias[v * HID + col], f = fw2[v * HID + col], wo = w2wo[v * HID + col];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        s_r[r] = fmaf(fmaxf(acc[r][c] + rb, 0.0f), f, s_r[r]);
        s_p[r] = fmaf(p_s[(ty * TM + r) * HID + col], wo, s_p[r]);
      }
    }
    for (int k = tx; k < in_ch; k += 32) {
      const float wd = wdwo[v * in_ch + k];
#pragma unroll
      for (int r = 0; r < TM; ++r) s_c[r] = fmaf(cd_s[(ty * TM + r) * in_ch + k], wd, s_c[r]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      s_r[r] = warp_sum(s_r[r]);
      s_p[r] = warp_sum(s_p[r]);
      s_c[r] = warp_sum(s_c[r]);
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t point = n0 + ty * TM + r;
      if (tx == r && point < n) {
        const int64_t o = (int64_t)v * n + point;
        out[o] = s_r[r] + 2.0f * (s_p[r] + s_c[r]) + obias[v] + ref_t[o];
      }
    }
  }
}

int launch_f32(const void* pe, const void* cd, const float* ref_t, const void* w1, const float* b1,
               const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
               const float* w2wo, const float* wdwo, const float* obias, float* out, int64_t n,
               int in_ch, int n_vars, cudaStream_t stream) {
  const size_t smem = shared_bytes_f32(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_primal_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n + NB_F32 - 1) / NB_F32);
  decode_primal_kernel<<<blocks, THREADS, smem, stream>>>(
      static_cast<const float*>(pe), static_cast<const float*>(cd), ref_t, static_cast<const float*>(w1),
      b1, static_cast<const float*>(w2f1), static_cast<const float*>(wdf1), rbias, fw2, w2wo, wdwo,
      obias, out, n, in_ch, n_vars);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Hidden width the kernel was built for; the input width must be a multiple of
// dpn_decode_primal_k_tile(); points a block takes; shared memory one block needs at
// that input width.
int dpn_decode_primal_hid() { return HID; }
int dpn_decode_primal_k_tile() { return TILE_ROWS; }
int dpn_decode_primal_block(int is_bf16) { return is_bf16 ? NB : NB_F32; }
int dpn_decode_primal_shared_bytes(int is_bf16, int in_ch) {
  return (int)(is_bf16 ? primal_smem(in_ch).total : shared_bytes_f32(in_ch));
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  Returns cudaGetLastError()
// after the launch (0 on success).
int dpn_decode_primal_v4t(int is_bf16, const void* pe, const void* cd, const float* ref_t,
                          const void* w1, const float* b1, const void* w2f1, const void* wdf1,
                          const float* rbias, const float* fw2, const float* w2wo,
                          const float* wdwo, const float* obias, float* out, int64_t n,
                          int in_ch, int n_vars, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tc(pe, cd, ref_t, w1, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, out, n,
                     in_ch, n_vars, s);
  return launch_f32(pe, cd, ref_t, w1, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, out, n,
                    in_ch, n_vars, s);
}

}  // extern "C"
