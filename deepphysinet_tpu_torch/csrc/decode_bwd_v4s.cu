// v4s and v6 collapsed decode, backward: cotangents of the nine fused weights,
// summed over all points, for Hopper (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/decode_kernel.py that share
// their algebra and their fused weights: _decode_bwd_kernel_v4s (called through
// decode_bwd_kernel_v4s; v6 = 0 here: pe [n, 3 * two_f] channel-major rows,
// cotangents [n_vars, n] and [3, n_vars, n]) and _decode_bwd_kernel_v6
// (decode_bwd_kernel_v6; v6 = 1: trig [3, n, two_f] direction-major, cotangents
// [n, n_vars] and [3, n, n_vars]).  The v6 operand is gathered into the
// channel-major row as it is loaded, and gw1g [n_vars, 3, two_f, HID] has the
// memory of [n_vars, 3 * two_f, HID], so the two forms share everything after the
// loads: g_w1g[v, k] = trig_k^T g_z is rows k * two_f : (k + 1) * two_f of pe^T g_z.
// Per block of points and variable v the kernel recomputes the forward chain (no
// activations are saved by the forward) and forms, with go = g_primal[v],
// gto_k = g_tang[k, v] as per-point columns, a = fw2[v], b = w2wo[v], W = w2f1[v]:
//
//   z, p, t_k, r, pr, tr_k        as the forward; t_k stays f32 here and is
//                                 rounded only as a product's input (:2560-2568,
//                                 :2162-2164), where the forward kernels round it
//   g_rp  = 1[r > 0] go a         g_rt_k = 1[r > 0] gto_k a
//   gfw2  += sum_n pr go + sum_k sum_n tr_k gto_k
//   gw2wo += 2 (sum_n p go + sum_k sum_n t_k gto_k)
//   gwdwo += 2 sum_n cd go        grbias += sum_n g_rp
//   gw2f1 += p^T g_rp + sum_k t_k^T g_rt_k       gwdf1 += cd^T g_rp
//   g_z   = 1[z > 0] (g_rp W^T + 2 go b)   g_tz_k = 1[z > 0] (g_rt_k W^T + 2 gto_k b)
//   gw1g  += pe^T g_z             gb1 += sum_n g_z
//   gw1t[k] += pe[:, block k]^T g_tz_k
//
// Every operand of every product is rounded to the compute type T first, also
// g_rp, g_rt, g_z and g_tz; sums are f32.  g_obias = sum_n go is left to the
// caller, as on the TPU.
//
// What bounds it: 12.98 MFLOP per point (6 variables x 1,081,344 MACs) against about 900 bytes
// of point input, so it is compute bound.  Where the card differs from the TPU: there the grid is
// a sequential loop that adds into accumulators resident in fast memory; here blocks run
// concurrently, and one variable's accumulators (gw2f1 256 x 256, gwdf1 and gw1g 192 x 256, gw1t
// 3 x 64 x 256: 852 KB of f32) fit neither a block's registers (at most about 128 KB) nor its
// shared memory (227 KB) next to the block's working set.  A block owns NB = 64 points and ONE
// variable (grid = blocks x variables; a 4,096-point launch has 384 blocks); each product that
// contracts the point axis is summed over the block's points in registers and then added into
// the zero-initialised output in global memory with float4 atomic adds, which resolve in L2: 864
// KB a block with the column sums, 1.66 GB at 20,480 points (3.15 GB in the CUDA-core body
// before, which added gw2f1 once for each row-set pair).  The order in which blocks add is not fixed, so the
// result is not bit-reproducible from run to run; it is compared with the plain version by
// tolerance.  Points past n enter with zero rows and zero cotangents, and every output is linear
// in the cotangents, so they add nothing.
//
// bf16 (decode_bwd_v4s_tc, the flagship's type): every product on the tensor cores (mma.sync
// m16n8k16), in the order of the TPU kernel's body (decode_kernel.py:2552-2598).  Eight warps.
// * Recompute: stages 1 and 2 of the forward (decode_jvp_tc.cuh, with fix_ties), so z's and r's
//   relu masks and T(p), T(t_k) have the forward kernel's bits.  Stage 1's epilogue also sums
//   p go and t_k gto_k per column for gw2wo, t_k in f32 from the accumulator before its rounding
//   (t_k stays f32 in the backward and is rounded only as a product's input); stage 2's sums
//   relu(r) go + 1[r > 0] tr_k gto_k (gfw2) and 1[r > 0] go a (grbias) per column and stores r's
//   mask as bits ([64, 8] words).  Per-column sums reduce over a warp's rows by shuffles and go
//   out with one atomic add a column and warp.
// * The row cotangents g_rp = T(1[r > 0] go a) and g_rt_k = T(1[r > 0] gto_k a) are never
//   stored: each is formed in registers, as the mma fragment that reads it, from r's mask bits,
//   the point's cotangent and a = fw2[v].  (Stored, the four [64, 256] row sets would need the
//   135 KB that T(p) and T(t_k) hold.)
// * gw2f1 = sum over the four row-set pairs of A_s^T g_r,s, one product with K = 4 x 64 points,
//   and gwdf1 = cd^T g_rp: warp w owns output columns 32 w .. 32 w + 31 and walks 64-row tiles;
//   A^T comes from the row sets (and cd) by ldmatrix.trans, g_r from the mask bits.
// * g_p = g_rp W^T + 2 go b and g_t,k = g_rt,k W^T + 2 gto_k b for the four row sets in one pass
//   over w2f1 (256 x 256, in eight [64, 128] tiles through the block ring of three): W^T is the B
//   operand read by a plain ldmatrix from the row-major w2f1 (no transposed copy), the A operand
//   g_r formed in registers; warp w owns points 32 (w & 1) .. + 31 of row set w >> 1 and the
//   pass's 64 columns.  The epilogue masks with z's bits, sums g_z per column for gb1 and writes
//   T(g_z) and T(g_tz,k) over the row sets, whose last reader (gw2f1) is done.
// * gw1g = pe^T g_z and gw1t[k] = pe[:, k two_f ..]^T g_tz,k, with the block's primal rows loaded
//   again by cp.async over cd (dead after gwdf1) while g W^T runs.
// * Shared memory at flagship width (in_ch 192): the row sets (135,168 bytes; the primal rows
//   under t_2's, as in the v4s forward), cd (25,600), the ring (55,296), z's and r's mask bits
//   (2 x 2,048), the block's cotangents (1,024), fix_ties's list (2,048): 223,232 bytes.
// * Why 64 points a flush: a partial of 852 KB can leave the SM less often only if more points
//   are contracted into it first, and its accumulators do not fit one SM.  The options weighed:
//   a cluster of 8 blocks holding one variable's partial in distributed shared memory needs 106
//   KB a block on top of this body's 223 KB; a second pass that contracts over all points
//   (K = N) would write and read back g_z, T(p) and T(t_k), 4 KB a point and variable (0.5 GB
//   each way at 20,480 points).  Both are left for later.  chip_smoke.py's [backward traffic]
//   lines give the atomic bytes a launch and what the adds cost (a variant built without them).
// Registers and spills: chip_smoke.py's [build] lines.  The body takes its operands through
// jvp::RowSource, so decode_bwd_v4.cu (the same algebra with a dpe input) can take it with
// dm = dpe.
//
// float (decode_bwd_v4s_kernel, the parity configuration; no TF32): the products on the CUDA
// cores (decode_common.cuh's block_gemm and point_contraction), one direction at a time; W^T is
// gathered from w2f1 tile by tile (block_gemm<..., WT = true>).

#include "decode_common.cuh"
#include "decode_jvp_tc.cuh"

namespace {

using namespace dpn;

// ---- bf16: tensor cores -------------------------------------------------------------------

using jvp::bf16;
using jvp::LDA;
using jvp::NB;
using tc::ld_of;

constexpr int WT_ROWS = 64;   // w2f1 rows of a g W^T tile: the pass's output columns
constexpr int WT_COLS = 128;  // w2f1 columns of a tile: half the contraction
constexpr int WT_LD = ld_of(WT_COLS);
constexpr int WORDS = HID / 32;  // mask words a point

static_assert(WT_ROWS * WT_LD * (int)sizeof(__nv_bfloat16) <= jvp::SLOT_BYTES, "a w2f1 tile fits a ring slot");

// Byte offsets of the backward's shared memory at input width in_ch (see the header).
struct BwdSmem {
  jvp::RowRegion rows;
  size_t cd, ring, mask, maskr, gos, list, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int in_ch) {
  BwdSmem s;
  s.rows = jvp::row_region(in_ch, false);
  s.cd = s.rows.rows;
  s.ring = s.cd + (size_t)NB * s.rows.ldp * sizeof(bf16);
  s.mask = s.ring + (size_t)jvp::NS * jvp::SLOT_BYTES;
  s.maskr = s.mask + (size_t)NB * WORDS * sizeof(uint32_t);
  s.gos = s.maskr + (size_t)NB * WORDS * sizeof(uint32_t);
  s.list = s.gos + (size_t)4 * NB * sizeof(float);
  s.total = s.list + (size_t)(jvp::TIE_CAP + 1) * sizeof(int);
  return s;
}

// The sum over the eight lanes that share t = lane & 3: a column's sum over a warp tile's rows.
__device__ __forceinline__ float column_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// The OR over the four lanes of a quad: a row's 32 mask bits of a warp tile.
__device__ __forceinline__ uint32_t quad_or(uint32_t x) {
  x |= __shfl_xor_sync(0xffffffffu, x, 1);
  return x | __shfl_xor_sync(0xffffffffu, x, 2);
}

// g_r at one element before its rounding: 1[r > 0] (bit `bit` of the row's mask word) go a.
__device__ __forceinline__ float g_r(uint32_t word, int bit, float go, float a) {
  return (word >> bit) & 1u ? go * a : 0.0f;
}

// acc += A^T[i0 .. i0 + 63, points] . B[points, j0 .. j0 + 31] over `steps` k16 steps of points:
// at is this lane's quad_lane address of A's rows [point][i] at (first point, i0), read
// transposed; at_k16 the bytes of 16 rows of A; bfrag(ks, bf) gives step ks's B fragments of the
// four n8 tiles.
template <class BFrag>
__device__ __forceinline__ void contract(float (&acc)[4][4][4], uint32_t at, uint32_t at_k16, int steps,
                                         BFrag bfrag) {
  for (int ks = 0; ks < steps; ++ks) {
    uint32_t af[4][4], bf[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) mma::ldmatrix_x4_trans(af[mt], at + ks * at_k16 + mt * 32);
    bfrag(ks, bf);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma::mma_16816(acc[mt][nt], af[mt], bf[nt][0], bf[nt][1]);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
decode_bwd_v4s_tc(const bf16* __restrict__ pe, const bf16* __restrict__ cd,
                  const float* __restrict__ g_primal, const float* __restrict__ g_tang,
                  const bf16* __restrict__ w1g, const bf16* __restrict__ w1t,
                  const float* __restrict__ b1, const bf16* __restrict__ w2f1,
                  const bf16* __restrict__ wdf1, const float* __restrict__ rbias,
                  const float* __restrict__ fw2, const float* __restrict__ w2wo,
                  float* __restrict__ gw1g, float* __restrict__ gw1t, float* __restrict__ gb1,
                  float* __restrict__ gw2f1, float* __restrict__ gwdf1,
                  float* __restrict__ grbias, float* __restrict__ gfw2,
                  float* __restrict__ gw2wo, float* __restrict__ gwdwo,
                  int64_t n, int in_ch, int n_vars, int v6) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdSmem L = bwd_smem(in_ch);
  bf16* sets = reinterpret_cast<bf16*>(smem);  // [4 x NB, LDA]: T(p), T(t_k); then T(g_z), T(g_tz,k)
  bf16* pe_s = reinterpret_cast<bf16*>(smem + L.rows.pe);
  bf16* cd_s = reinterpret_cast<bf16*>(smem + L.cd);  // cd; then the primal rows again
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + L.mask);    // [NB, WORDS]: z > 0
  uint32_t* maskr_s = reinterpret_cast<uint32_t*>(smem + L.maskr);  // [NB, WORDS]: r > 0
  float* gos = reinterpret_cast<float*>(smem + L.gos);              // [4, NB]: go, gto_0..2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3, ldp = L.rows.ldp;
  const bool var_major = v6 == 0;
  const jvp::RowSource src{v6 ? nullptr : pe, v6 ? pe : nullptr, n, in_ch};
  const bf16* w1v = w1g + (size_t)v * in_ch * HID;
  const bf16* w1cv = w1t + (size_t)v * in_ch * HID;
  const bf16* W = w2f1 + (size_t)v * HID * HID;
  b1 += v * HID; rbias += v * HID; fw2 += v * HID; w2wo += v * HID;
  gb1 += v * HID; grbias += v * HID; gfw2 += v * HID; gw2wo += v * HID;

  // the block's rows (the first cp.async group) and cotangents (published by stage 1's barrier)
  jvp::primal_rows_async(src, pe_s, ldp, n0);
  tc::rows_async(cd_s, ldp, cd, n0, n, NB, in_ch);
  mma::cp_async_commit();
  for (int i = tid; i < 4 * NB; i += THREADS) {
    const int which = i / NB;  // 0: primal, 1..3: tangent direction which - 1
    const int64_t point = n0 + i % NB;
    float gv = 0.0f;
    if (point < n)
      gv = which == 0 ? g_primal[primal_at(var_major, point, v, n, n_vars)]
                      : g_tang[tangent_at(var_major, which - 1, point, v, n, n_vars)];
    gos[i] = gv;
  }

  // ---- recompute stage 1: z's mask, T(p), T(t_k); sum_n p go + sum_k sum_n t_k gto_k ----
  uint32_t mask[4], tie_z[4];
  uint64_t tie_u[4];
  {
    float s_w[4][2] = {};  // the lane's columns 32 warp + 8 nt + t2 + e
    const auto on_z = [&](int mt, int nt, int h, int, float p0, float p1) {
      const float go = gos[16 * mt + g + 8 * h];
      s_w[nt][0] = fmaf(p0, go, s_w[nt][0]);
      s_w[nt][1] = fmaf(p1, go, s_w[nt][1]);
    };
    const auto on_u = [&](int k, int mt, int nt, int h, int, float u0, float u1) {
      const float gto = gos[(k + 1) * NB + 16 * mt + g + 8 * h];
      s_w[nt][0] = fmaf(u0, gto, s_w[nt][0]);
      s_w[nt][1] = fmaf(u1, gto, s_w[nt][1]);
    };
    jvp::stage1(pe_s, ldp, pe_s, ldp, ch, w1v, w1cv, b1, in_ch, smem + L.ring, sets, mask, tie_z, tie_u, on_z,
                on_u);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = column_sum(s_w[nt][e]);
        if (g == 0) atomicAdd(&gw2wo[32 * warp + 8 * nt + t2 + e], 2.0f * s);
      }
  }
  // z's mask as bits: word `warp` of each row is this warp's 32 columns
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t word = 0u;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) word |= ((mask[mt] >> (4 * nt + 2 * h + e)) & 1u) << (8 * nt + t2 + e);
      word = quad_or(word);
      if ((lane & 3) == 0) mask_s[(16 * mt + g + 8 * h) * WORDS + warp] = word;
    }

  auto ring = jvp::stage2_ring(smem + L.ring, W, wdf1 + (size_t)v * in_ch * HID, in_ch);
  ring.start();
  jvp::fix_ties(tie_z, tie_u, src, w1v, w1cv, b1, n0, sets, reinterpret_cast<int*>(smem + L.list),
                reinterpret_cast<float*>(smem + L.ring + (jvp::NS - 1) * jvp::SLOT_BYTES),
                jvp::ties_per_round(in_ch));

  // ---- recompute stage 2: r's mask; sum_n relu(r) go + sum_k sum_n 1[r > 0] tr_k gto_k; sum_n g_rp ----
  const int pg = warp & 3, half = warp >> 2;
  jvp::stage2(ring, sets, cd_s, ldp, in_ch, [&](int c, float (&acc)[4][4][4]) {
    float s_f[4][2] = {}, s_b[4][2] = {};
    uint32_t word[2] = {0u, 0u};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * jvp::S2_COLS + 32 * half + 8 * nt + t2 + e;
        const float rb = rbias[col], a = fw2[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 16 * pg + g + 8 * h;
          const float rv = acc[0][nt][2 * h + e] + rb, go = gos[row];
          s_f[nt][e] = fmaf(fmaxf(rv, 0.0f), go, s_f[nt][e]);
          if (rv > 0.0f) {
            word[h] |= 1u << (8 * nt + t2 + e);
            s_b[nt][e] += go * a;
#pragma unroll
            for (int k = 0; k < 3; ++k) s_f[nt][e] = fmaf(acc[k + 1][nt][2 * h + e], gos[(k + 1) * NB + row], s_f[nt][e]);
          }
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t w = quad_or(word[h]);
      if ((lane & 3) == 0) maskr_s[(16 * pg + g + 8 * h) * WORDS + 2 * c + half] = w;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float f = column_sum(s_f[nt][e]), b = column_sum(s_b[nt][e]);
        if (g == 0) {
          const int col = c * jvp::S2_COLS + 32 * half + 8 * nt + t2 + e;
          atomicAdd(&gfw2[col], f);
          atomicAdd(&grbias[col], b);
        }
      }
  });
  __syncthreads();  // r's mask is published; every warp is done with stage 2's tiles

  // g W^T's tiles of w2f1 ([64 rows, 128 columns]: pass kp = i / 2, columns 128 (i & 1) ..) are
  // in flight while the point contractions below run
  auto wring = tc::make_ring<jvp::NS>(smem + L.ring, jvp::SLOT_BYTES, 2 * HID / WT_ROWS, [=](int i, unsigned char* slot) {
    tc::tile_async<WT_COLS>(reinterpret_cast<bf16*>(slot), WT_LD,
                            W + (size_t)(i >> 1) * WT_ROWS * HID + (i & 1) * WT_COLS, HID, WT_ROWS);
  });
  wring.start();

  // gwdwo = 2 sum_n cd go
  for (int i = tid; i < in_ch; i += THREADS) {
    float s = 0.0f;
    for (int p = 0; p < NB; ++p) s = fmaf(to_f32(cd_s[p * ldp + i]), gos[p], s);
    atomicAdd(&gwdwo[v * in_ch + i], 2.0f * s);
  }

  // ---- gw2f1 = sum_s A_s^T g_r,s (K = 4 NB) and gwdf1 = cd^T g_rp: warp w owns columns 32 w .. ----
  {
    float a_c[4];  // a at the lane's B columns 32 warp + 8 nt + g
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) a_c[nt] = fw2[32 * warp + 8 * nt + g];
    // step ks: points 16 (ks % 4) .. of row set ks / 4; the lane's rows 2t, 2t + 1, 2t + 8, 2t + 9
    const auto g_frag = [&](int ks, uint32_t (&bf)[4][2]) {
      const int s = ks >> 2, row = 16 * (ks & 3) + t2;
      const float* go = gos + s * NB;
      const uint32_t m0 = maskr_s[row * WORDS + warp], m1 = maskr_s[(row + 1) * WORDS + warp];
      const uint32_t m8 = maskr_s[(row + 8) * WORDS + warp], m9 = maskr_s[(row + 9) * WORDS + warp];
      const float g0 = go[row], g1 = go[row + 1], g8 = go[row + 8], g9 = go[row + 9];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int bit = 8 * nt + g;
        bf[nt][0] = mma::pack_bf16x2(g_r(m0, bit, g0, a_c[nt]), g_r(m1, bit, g1, a_c[nt]));
        bf[nt][1] = mma::pack_bf16x2(g_r(m8, bit, g8, a_c[nt]), g_r(m9, bit, g9, a_c[nt]));
      }
    };
    for (int it = 0; it < HID / 64; ++it) {
      float acc[4][4][4];
      tc::zero_acc(acc);
      contract(acc, tc::quad_lane(sets + 64 * it, LDA, lane), 16 * LDA * sizeof(bf16), 4 * NB / 16, g_frag);
      tc::add_tile(gw2f1 + (size_t)v * HID * HID, HID, 64 * it, 32 * warp, acc, lane);
    }
    for (int it = 0; it < in_ch / 64; ++it) {
      float acc[4][4][4];
      tc::zero_acc(acc);
      contract(acc, tc::quad_lane(cd_s + 64 * it, ldp, lane), 16 * ldp * sizeof(bf16), NB / 16, g_frag);
      tc::add_tile(gwdf1 + (size_t)v * in_ch * HID, HID, 64 * it, 32 * warp, acc, lane);
    }
  }
  __syncthreads();  // every read of the row sets and of cd is done

  // the primal rows again, over cd, for gw1g and gw1t
  jvp::primal_rows_async(src, cd_s, ldp, n0);
  mma::cp_async_commit();

  // ---- g_z = 1[z > 0] (g_r W^T + 2 go b) for the four row sets, over the row sets ----
  {
    const int s = warp >> 1, rbase = 32 * (warp & 1);  // the warp's row set and first point
    float go_r[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) go_r[mt][h] = gos[s * NB + rbase + 16 * mt + g + 8 * h];
#pragma unroll 1
    for (int kp = 0; kp < HID / WT_ROWS; ++kp) {
      float acc[2][8][4];
      tc::zero_acc(acc);
      for (int half_k = 0; half_k < HID / WT_COLS; ++half_k) {
        const bf16* tile = wring.next();
        for (int ks = 0; ks < WT_COLS / 16; ++ks) {
          const int c = half_k * WT_COLS + 16 * ks + t2, word = c >> 5, bit = c & 31;
          const float a0 = fw2[c], a1 = fw2[c + 1], a8 = fw2[c + 8], a9 = fw2[c + 9];
          uint32_t af[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t m = maskr_s[(rbase + 16 * mt + g + 8 * h) * WORDS + word];
              const float go = go_r[mt][h];
              af[mt][h] = mma::pack_bf16x2(g_r(m, bit, go, a0), g_r(m, bit + 1, go, a1));
              af[mt][2 + h] = mma::pack_bf16x2(g_r(m, bit + 8, go, a8), g_r(m, bit + 9, go, a9));
            }
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // W^T's fragments of n8 tiles 2j and 2j + 1
            uint32_t bf[4];
            mma::ldmatrix_x4(bf, tc::quad_lane(tile + 16 * j * WT_LD + 16 * ks, WT_LD, lane));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma::mma_16816(acc[mt][2 * j], af[mt], bf[0], bf[1]);
              mma::mma_16816(acc[mt][2 * j + 1], af[mt], bf[2], bf[3]);
            }
          }
        }
      }
      // epilogue: columns 64 kp + 8 nt + t2 + e; z's mask word 2 kp + nt / 4
      float s_z[8][2] = {};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = WT_ROWS * kp + 8 * nt + t2;
        const float b0 = w2wo[col], b1v = w2wo[col + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = rbase + 16 * mt + g + 8 * h;
            const uint32_t m = mask_s[row * WORDS + 2 * kp + (nt >> 2)] >> (8 * (nt & 3) + t2);
            const float go = go_r[mt][h];
            const float z0 = m & 1u ? acc[mt][nt][2 * h] + 2.0f * (go * b0) : 0.0f;
            const float z1 = (m >> 1) & 1u ? acc[mt][nt][2 * h + 1] + 2.0f * (go * b1v) : 0.0f;
            s_z[nt][0] += z0;
            s_z[nt][1] += z1;
            *reinterpret_cast<uint32_t*>(sets + (s * NB + row) * LDA + col) = mma::pack_bf16x2(z0, z1);
          }
      }
      if (s == 0) {  // gb1 = sum_n g_z: warps 0 and 1
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z = column_sum(s_z[nt][e]);
            if (g == 0) atomicAdd(&gb1[WT_ROWS * kp + 8 * nt + t2 + e], z);
          }
      }
    }
  }
  mma::cp_async_wait<0>();
  __syncthreads();  // g_z, g_tz,k and the primal rows are published

  // ---- gw1g = pe^T g_z and gw1t[k] = pe[:, k ch ..]^T g_tz,k ----
  const auto gz_frag = [&](const bf16* gz) {
    return [=](int ks, uint32_t (&bf)[4][2]) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        mma::ldmatrix_x4_trans(r, tc::b_lane(gz + 16 * ks * LDA + 32 * warp + 16 * j, LDA, lane));
        bf[2 * j][0] = r[0], bf[2 * j][1] = r[1], bf[2 * j + 1][0] = r[2], bf[2 * j + 1][1] = r[3];
      }
    };
  };
  for (int it = 0; it < in_ch / 64; ++it) {
    float acc[4][4][4];
    tc::zero_acc(acc);
    contract(acc, tc::quad_lane(cd_s + 64 * it, ldp, lane), 16 * ldp * sizeof(bf16), NB / 16, gz_frag(sets));
    tc::add_tile(gw1g + (size_t)v * in_ch * HID, HID, 64 * it, 32 * warp, acc, lane);
  }
  for (int k = 0; k < 3; ++k)
    for (int it = 0; it < ch / 64; ++it) {
      float acc[4][4][4];
      tc::zero_acc(acc);
      contract(acc, tc::quad_lane(cd_s + k * ch + 64 * it, ldp, lane), 16 * ldp * sizeof(bf16), NB / 16,
               gz_frag(sets + (k + 1) * NB * LDA));
      tc::add_tile(gw1t + ((size_t)v * 3 + k) * ch * HID, HID, 64 * it, 32 * warp, acc, lane);
    }
}

int launch_tc(const void* pe, const void* cd, const float* g_primal, const float* g_tang, const void* w1g,
              const void* w1t, const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
              const float* fw2, const float* w2wo, float* gw1g, float* gw1t, float* gb1, float* gw2f1,
              float* gwdf1, float* grbias, float* gfw2, float* gw2wo, float* gwdwo, int64_t n, int in_ch,
              int n_vars, int v6, cudaStream_t stream) {
  if (!jvp::row_region_valid(in_ch, false) || in_ch % 192) return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(in_ch).total;
  cudaError_t err = cudaFuncSetAttribute(decode_bwd_v4s_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_bwd_v4s_tc<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(pe), static_cast<const bf16*>(cd), g_primal, g_tang, static_cast<const bf16*>(w1g),
      static_cast<const bf16*>(w1t), b1, static_cast<const bf16*>(w2f1), static_cast<const bf16*>(wdf1), rbias,
      fw2, w2wo, gw1g, gw1t, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch, n_vars, v6);
  return (int)cudaGetLastError();
}

// ---- float: CUDA cores ------------------------------------------------------------------------

// Column sums of this block, combined in shared memory before they go out.
enum { CS_FW2 = 0, CS_W2WO, CS_RBIAS, CS_B1, CS_COUNT };

template <typename T, int TM>
__global__ void __launch_bounds__(THREADS, 1)
decode_bwd_v4s_kernel(const T* __restrict__ pe, const T* __restrict__ cd,
                      const float* __restrict__ g_primal, const float* __restrict__ g_tang,
                      const T* __restrict__ w1g, const T* __restrict__ w1t,
                      const float* __restrict__ b1, const T* __restrict__ w2f1,
                      const T* __restrict__ wdf1,
                      const float* __restrict__ rbias, const float* __restrict__ fw2,
                      const float* __restrict__ w2wo,
                      float* __restrict__ gw1g, float* __restrict__ gw1t, float* __restrict__ gb1,
                      float* __restrict__ gw2f1, float* __restrict__ gwdf1,
                      float* __restrict__ grbias, float* __restrict__ gfw2,
                      float* __restrict__ gw2wo, float* __restrict__ gwdwo,
                      int64_t n, int in_ch, int n_vars, int v6) {
  constexpr int NB = WARPS * TM;
  extern __shared__ __align__(16) unsigned char smem[];
  float* p_s = reinterpret_cast<float*>(smem);    // [NB, HID] f32: p, then t_k
  T* G_s = reinterpret_cast<T*>(p_s + NB * HID);  // [NB, HID]: g_rp / g_rt_k, then g_z / g_tz_k
  T* Ws = G_s + NB * HID;                         // [KT, HID]
  T* pe_s = Ws + KT * HID;                        // [NB, in_ch]
  T* cd_s = pe_s + NB * in_ch;                    // [NB, in_ch]
  float* go_s = reinterpret_cast<float*>(cd_s + NB * in_ch);  // [4, NB]: go, gto_0..2
  float* cs = go_s + 4 * NB;                      // [CS_COUNT, HID]

  const int tid = threadIdx.x;
  const int tx = tid & 31, ty = tid >> 5;
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int two_f = in_ch / 3;
  const T* W = w2f1 + (size_t)v * HID * HID;

  const bool var_major = v6 == 0;
  if (v6)
    load_rows_dm<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
  else
    load_rows<T>(pe, cd, pe_s, cd_s, n0, n, NB, in_ch);
  for (int i = tid; i < 4 * NB; i += THREADS) {
    const int which = i / NB;  // 0: primal, 1..3: tangent direction which - 1
    const int64_t point = n0 + i % NB;
    float g = 0.0f;
    if (point < n)
      g = which == 0 ? g_primal[primal_at(var_major, point, v, n, n_vars)]
                     : g_tang[tangent_at(var_major, which - 1, point, v, n, n_vars)];
    go_s[i] = g;
  }
  for (int i = tid; i < CS_COUNT * HID; i += THREADS) cs[i] = 0.0f;

  float acc[TM][TN];
  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0

  // ---- primal chain -------------------------------------------------------
  // z, p (f32, shared); sum_n p go.  The product's first barrier publishes the
  // loads above.
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(pe_s, in_ch, w1g + (size_t)v * in_ch * HID, in_ch, Ws, acc);
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
  point_contraction<T, T>(pe_s, in_ch, in_ch, G_s, NB, gw1g + (size_t)v * in_ch * HID);

  // ---- tangent chains, one direction at a time ------------------------------
  for (int k = 0; k < 3; ++k) {
    const float* gto_s = go_s + (k + 1) * NB;
    const T* pe_k = pe_s + k * two_f;
    // t_k = 1[z > 0] (pe[:, block k] . w1t[v, k]) in f32 over p_s; sum_n t_k gto_k.
    // The product's first barrier comes after every thread's last read of
    // p_s / G_s in the contractions above.
    zero_tile<TM>(acc);
    block_gemm<T, T, TM>(pe_k, in_ch, w1t + ((size_t)v * 3 + k) * two_f * HID, two_f, Ws, acc);
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
    point_contraction<T, T>(pe_k, in_ch, two_f, G_s, NB,
                            gw1t + ((size_t)v * 3 + k) * two_f * HID);
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
         2 * (size_t)NB * in_ch * sizeof(T) + (size_t)(4 * NB + CS_COUNT * HID) * sizeof(float);
}

template <typename T, int TM>
int launch(const void* pe, const void* cd, const float* g_primal, const float* g_tang,
           const void* w1g, const void* w1t, const float* b1, const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
           const float* w2wo, float* gw1g, float* gw1t, float* gb1, float* gw2f1, float* gwdf1,
           float* grbias, float* gfw2, float* gw2wo, float* gwdwo, int64_t n, int in_ch,
           int n_vars, int v6, cudaStream_t stream) {
  constexpr int NB = WARPS * TM;
  const size_t smem = shared_bytes<T, TM>(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_bwd_v4s_kernel<T, TM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_bwd_v4s_kernel<T, TM><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(pe), static_cast<const T*>(cd), g_primal, g_tang,
      static_cast<const T*>(w1g), static_cast<const T*>(w1t), b1, static_cast<const T*>(w2f1),
      static_cast<const T*>(wdf1), rbias, fw2, w2wo, gw1g, gw1t,
      gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch, n_vars, v6);
  return (int)cudaGetLastError();
}

// Points per block of the float body: 32 (its buffers are twice bf16's).
constexpr int TM_F32 = 4;

}  // namespace

extern "C" {

// Hidden width the kernel was built for; shared memory one block needs at this
// input width.
int dpn_decode_bwd_v4s_hid() { return dpn::HID; }
// Points a block takes.
int dpn_decode_bwd_v4s_block(int is_bf16) { return is_bf16 ? jvp::NB : WARPS * TM_F32; }
// Bytes a block adds into the outputs with atomic adds: the point contractions' partials and the
// column sums.  bf16: gw2f1 once (its four row-set pairs summed first), gwdf1, gw1g, gw1t; one
// add a column for gw2wo, one a column and point group for gfw2 and grbias, one a column and
// warp of row set 0 for gb1, gwdwo.  float: gw2f1 once for each row-set pair, the others
// once, the column sums once from shared memory.
int64_t dpn_decode_bwd_v4s_atomic_bytes(int is_bf16, int in_ch) {
  const int64_t partials = (int64_t)(is_bf16 ? 1 : 4) * HID * HID + 3 * (int64_t)in_ch * HID;
  const int64_t sums = is_bf16 ? HID + 2 * (jvp::NB / 16) * HID + 2 * HID + in_ch : CS_COUNT * HID + in_ch;
  return 4 * (partials + sums);
}
int dpn_decode_bwd_v4s_shared_bytes(int is_bf16, int in_ch) {
  if (!is_bf16) return (int)shared_bytes<float, TM_F32>(in_ch);
  return jvp::row_region_valid(in_ch, false) ? (int)bwd_smem(in_ch).total : 1 << 30;
}

// is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  v6: 0 for pe [n, in_ch],
// g_primal [n_vars, n] and g_tang [3, n_vars, n]; 1 for pe = trig [3, n, in_ch / 3],
// g_primal [n, n_vars] and g_tang [3, n, n_vars].  The nine outputs must be
// zero on entry; the kernel adds into them.  Returns cudaGetLastError() after
// the launch (0 on success).
int dpn_decode_bwd_v4s(int is_bf16, const void* pe, const void* cd, const float* g_primal,
                       const float* g_tang, const void* w1g, const void* w1t, const float* b1,
                       const void* w2f1, const void* wdf1,
                       const float* rbias, const float* fw2, const float* w2wo, float* gw1g,
                       float* gw1t, float* gb1, float* gw2f1, float* gwdf1, float* grbias,
                       float* gfw2, float* gw2wo, float* gwdwo, int64_t n, int in_ch,
                       int n_vars, int v6, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tc(pe, cd, g_primal, g_tang, w1g, w1t, b1, w2f1, wdf1, rbias, fw2, w2wo, gw1g, gw1t, gb1,
                     gw2f1, gwdf1, grbias, gfw2, gw2wo, gwdwo, n, in_ch, n_vars, v6, s);
  return launch<float, TM_F32>(pe, cd, g_primal, g_tang, w1g, w1t, b1, w2f1, wdf1, rbias,
                               fw2, w2wo, gw1g, gw1t, gb1, gw2f1, gwdf1, grbias, gfw2, gw2wo,
                               gwdwo, n, in_ch, n_vars, v6, s);
}

}  // extern "C"
