// The bf16 tensor-core body of the collapsed decode's backward, shared by decode_bwd_v4s.cu (v4s
// and v6: the tangent rows are lane blocks of the primal row) and decode_bwd_v4.cu (v4 / v4t: the
// tangent rows come from the compact dpe input).  The two differ only in where the block's
// layer-1 rows come from (jvp::RowSource) and in the operand of the last contraction:
// g_w1c[k] = tan_k^T g_tz_k reads lanes k ch .. k ch + ch - 1 of the primal rows (v4s, v6) or
// the dpe rows of direction k (v4).  The cotangents' layout changes only their addresses.
//
// Per block of NB = 64 points and ONE variable v (grid = blocks x variables), with go =
// g_primal[v], gto_k = g_tang[k, v] as per-point columns, a = fw2[v], b = w2wo[v], W = w2f1[v]:
//
//   z, p, t_k, r, pr, tr_k        as the forward; t_k stays f32 here and is rounded only as a
//                                 product's input, where the forward kernels round it once
//   g_rp  = 1[r > 0] go a         g_rt_k = 1[r > 0] gto_k a
//   gfw2  += sum_n pr go + sum_k sum_n tr_k gto_k
//   gw2wo += 2 (sum_n p go + sum_k sum_n t_k gto_k)
//   gwdwo += 2 sum_n cd go        grbias += sum_n g_rp
//   gw2f1 += p^T g_rp + sum_k t_k^T g_rt_k       gwdf1 += cd^T g_rp
//   g_z   = 1[z > 0] (g_rp W^T + 2 go b)   g_tz_k = 1[z > 0] (g_rt_k W^T + 2 gto_k b)
//   gw1   += pe^T g_z             gb1 += sum_n g_z
//   gw1c[k] += tan_k^T g_tz_k
//
// Every operand of every product is rounded to bf16 first, also g_rp, g_rt, g_z and g_tz; sums
// are f32.  Every product runs on the tensor cores (mma.sync m16n8k16), eight warps:
// * Recompute: stages 1 and 2 of the forward (decode_jvp_tc.cuh, with fix_ties), so z's and r's
//   relu masks and T(p), T(t_k) have the forward kernel's bits.  Stage 1's epilogue also sums
//   p go and t_k gto_k per column for gw2wo, t_k in f32 from the accumulator before its rounding;
//   stage 2's sums relu(r) go + 1[r > 0] tr_k gto_k (gfw2) and 1[r > 0] go a (grbias) per column
//   and stores r's mask as bits ([64, 8] words).  Per-column sums reduce over a warp's rows by
//   shuffles and go out with one atomic add a column and warp.
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
// * gw1 = pe^T g_z and gw1c[k] = tan_k^T g_tz,k.  The block's primal rows are loaded again by
//   cp.async over cd (dead after gwdf1) while g W^T runs; v4's dpe rows ([3, 64, ld_of(ch)],
//   27,648 bytes at flagship width, more than cd's 25,600) go into the ring once g W^T has
//   released it, in flight while gw1 is contracted.
// * Shared memory at flagship width (in_ch 192), either source: the row sets (135,168 bytes; the
//   block's pe rows, and v4's dpe rows, under their tail as in the forward), cd (25,600), the
//   ring (55,296), z's and r's mask bits (2 x 2,048), the block's cotangents (1,024), fix_ties's
//   list (2,048): 223,232 bytes of the 232,448 a block may take.
// * Each product that contracts the point axis is summed over the block's points in registers and
//   added into the zero-initialised output with float4 atomic adds, which resolve in L2: 864 KB a
//   block with the column sums (atomic_bytes).  The order in which blocks add is not fixed, so
//   the result is not bit-reproducible from run to run.  Points past n enter with zero rows and
//   zero cotangents, and every output is linear in the cotangents, so they add nothing.
// * Why 64 points a flush: a partial of 852 KB can leave the SM less often only if more points
//   are contracted into it first, and its accumulators do not fit one SM.  The options weighed:
//   a cluster of 8 blocks holding one variable's partial in distributed shared memory needs 106
//   KB a block on top of this body's 223 KB; a second pass that contracts over all points
//   (K = N) would write and read back g_z, T(p) and T(t_k), 4 KB a point and variable (0.5 GB
//   each way at 20,480 points).  Both are left for later.  chip_smoke.py's [backward traffic]
//   lines give the atomic bytes a launch and what the adds cost (a variant built without them).

#pragma once

#include "decode_jvp_tc.cuh"

namespace dpn {
namespace bwd {

using jvp::bf16;
using jvp::LDA;
using jvp::NB;
using tc::ld_of;

constexpr int WT_ROWS = 64;   // w2f1 rows of a g W^T tile: the pass's output columns
constexpr int WT_COLS = 128;  // w2f1 columns of a tile: half the contraction
constexpr int WT_LD = ld_of(WT_COLS);
constexpr int WORDS = HID / 32;  // mask words a point

static_assert(WT_ROWS * WT_LD * (int)sizeof(__nv_bfloat16) <= jvp::SLOT_BYTES, "a w2f1 tile fits a ring slot");

// Byte offsets of the backward's shared memory at input width in_ch (see the header); with_dpe
// for v4, whose dpe rows lie under the row sets' tail in stage 1 and in the ring at the end.
struct BwdSmem {
  jvp::RowRegion rows;
  size_t cd, ring, mask, maskr, gos, list, total;
};

__host__ __device__ inline BwdSmem bwd_smem(int in_ch, bool with_dpe) {
  BwdSmem s;
  s.rows = jvp::row_region(in_ch, with_dpe);
  s.cd = s.rows.rows;
  s.ring = s.cd + (size_t)NB * s.rows.ldp * sizeof(bf16);
  s.mask = s.ring + (size_t)jvp::NS * jvp::SLOT_BYTES;
  s.maskr = s.mask + (size_t)NB * WORDS * sizeof(uint32_t);
  s.gos = s.maskr + (size_t)NB * WORDS * sizeof(uint32_t);
  s.list = s.gos + (size_t)4 * NB * sizeof(float);
  s.total = s.list + (size_t)(jvp::TIE_CAP + 1) * sizeof(int);
  return s;
}

// The widths the body takes: the row region's layout, the 64-row tiles of the point contractions
// (in_ch a multiple of 192, so a tangent block is a multiple of 64 lanes) and, for v4, the dpe
// rows in the ring.
__host__ __device__ inline bool bwd_valid(int in_ch, bool with_dpe) {
  if (!jvp::row_region_valid(in_ch, with_dpe) || in_ch % 192) return false;
  return !with_dpe || 3 * bwd_smem(in_ch, true).rows.dpe_k <= (size_t)jvp::NS * jvp::SLOT_BYTES;
}

// Bytes a block adds into the outputs with atomic adds: the point contractions' partials and the
// column sums.  This body (tc): gw2f1 once (its four row-set pairs summed first), gwdf1, gw1,
// gw1c; one add a column for gw2wo, one a column and point group for gfw2 and grbias, one a column
// and warp of row set 0 for gb1, gwdwo.  The float bodies of decode_bwd_v4s.cu and
// decode_bwd_v4.cu: gw2f1 once for each row-set pair, the other partials once, their four column
// sums once from shared memory, gwdwo.
__host__ __device__ inline int64_t atomic_bytes(bool tc, int in_ch) {
  const int64_t partials = (int64_t)(tc ? 1 : 4) * HID * HID + 3 * (int64_t)in_ch * HID;
  const int64_t sums = (tc ? HID + 2 * (NB / 16) * HID + 2 * HID : 4 * HID) + in_ch;
  return 4 * (partials + sums);
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

// The backward of one block (NB points from blockIdx.x, variable blockIdx.y): adds its share of
// the nine weight cotangents into the outputs.  src says where the layer-1 rows lie; w1v
// [in_ch, HID] and w1cv [3, ch, HID] are the variable's primal and tangent layer-1 rows; the
// cotangents are var-major ([n_vars, n], [3, n_vars, n]) or point-major as var_major says.
// Shared memory: bwd_smem(src.in_ch, !src.tangents_in_primal()).total bytes.
__device__ __forceinline__ void backward_block(const jvp::RowSource& src, const bf16* __restrict__ cd,
                                               const float* __restrict__ g_primal,
                                               const float* __restrict__ g_tang, const bf16* __restrict__ w1v,
                                               const bf16* __restrict__ w1cv, const float* __restrict__ b1,
                                               const bf16* __restrict__ w2f1, const bf16* __restrict__ wdf1,
                                               const float* __restrict__ rbias, const float* __restrict__ fw2,
                                               const float* __restrict__ w2wo, float* __restrict__ gw1,
                                               float* __restrict__ gw1c, float* __restrict__ gb1,
                                               float* __restrict__ gw2f1, float* __restrict__ gwdf1,
                                               float* __restrict__ grbias, float* __restrict__ gfw2,
                                               float* __restrict__ gw2wo, float* __restrict__ gwdwo, int n_vars,
                                               bool var_major) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t n = src.n;
  const int in_ch = src.in_ch;
  const bool with_dpe = !src.tangents_in_primal();
  const BwdSmem L = bwd_smem(in_ch, with_dpe);
  bf16* sets = reinterpret_cast<bf16*>(smem);  // [4 x NB, LDA]: T(p), T(t_k); then T(g_z), T(g_tz,k)
  bf16* pe_s = reinterpret_cast<bf16*>(smem + L.rows.pe);
  bf16* dpe_s = reinterpret_cast<bf16*>(smem + L.rows.dpe);  // v4, stage 1
  bf16* cd_s = reinterpret_cast<bf16*>(smem + L.cd);  // cd; then the primal rows again
  uint32_t* mask_s = reinterpret_cast<uint32_t*>(smem + L.mask);    // [NB, WORDS]: z > 0
  uint32_t* maskr_s = reinterpret_cast<uint32_t*>(smem + L.maskr);  // [NB, WORDS]: r > 0
  float* gos = reinterpret_cast<float*>(smem + L.gos);              // [4, NB]: go, gto_0..2

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3, ldp = L.rows.ldp, ldd = L.rows.ldd;
  const bf16* W = w2f1 + (size_t)v * HID * HID;
  b1 += v * HID; rbias += v * HID; fw2 += v * HID; w2wo += v * HID;
  gb1 += v * HID; grbias += v * HID; gfw2 += v * HID; gw2wo += v * HID;

  // the block's rows (the first cp.async group) and cotangents (published by stage 1's barrier)
  jvp::primal_rows_async(src, pe_s, ldp, n0);
  tc::rows_async(cd_s, ldp, cd, n0, n, NB, in_ch);
  if (with_dpe)
    for (int k = 0; k < 3; ++k) tc::rows_async(dpe_s + k * NB * ldd, ldd, src.dm + (size_t)k * n * ch, n0, n, NB, ch);
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
    // direction k's tangent rows: v4's dpe block k, or lanes k ch .. of the primal rows
    // the forward's windows and floors (forward_block), so T(p) and t_k are the ones it stored
    jvp::stage1<true, true>(pe_s, ldp, with_dpe ? dpe_s : pe_s, with_dpe ? ldd : ldp, with_dpe ? NB * ldd : ch,
                            w1v, w1cv, b1, in_ch, smem + L.ring, sets, mask, tie_z, tie_u, on_z, on_u,
                            jvp::TIE_FLOOR_Z, jvp::TIE_FLOOR_U);
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

  jvp::fix_ties(tie_z, tie_u, src, w1v, w1cv, b1, n0, sets, reinterpret_cast<int*>(smem + L.list), smem + L.ring);
  auto ring = jvp::stage2_ring(smem + L.ring, W, wdf1 + (size_t)v * in_ch * HID, in_ch);
  ring.start();

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

  // the primal rows again, over cd, for gw1 (and, for v4s / v6, gw1c)
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
  __syncthreads();  // g_z, g_tz,k and the primal rows are published; the ring is free

  // v4's dpe rows into the ring, in flight while gw1 is contracted
  bf16* dpe_r = reinterpret_cast<bf16*>(smem + L.ring);
  if (with_dpe) {
    for (int k = 0; k < 3; ++k) tc::rows_async(dpe_r + k * NB * ldd, ldd, src.dm + (size_t)k * n * ch, n0, n, NB, ch);
    mma::cp_async_commit();
  }

  // ---- gw1 = pe^T g_z and gw1c[k] = tan_k^T g_tz,k ----
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
    tc::add_tile(gw1 + (size_t)v * in_ch * HID, HID, 64 * it, 32 * warp, acc, lane);
  }
  if (with_dpe) {
    mma::cp_async_wait<0>();
    __syncthreads();  // the dpe rows are published
  }
  // direction k's tangent rows: v4's dpe rows in the ring, or lanes k ch .. of the primal rows
  const int ldt = with_dpe ? ldd : ldp;
  for (int k = 0; k < 3; ++k) {
    const bf16* tan = with_dpe ? dpe_r + k * NB * ldd : cd_s + k * ch;
    for (int it = 0; it < ch / 64; ++it) {
      float acc[4][4][4];
      tc::zero_acc(acc);
      contract(acc, tc::quad_lane(tan + 64 * it, ldt, lane), 16 * ldt * sizeof(bf16), NB / 16,
               gz_frag(sets + (k + 1) * NB * LDA));
      tc::add_tile(gw1c + ((size_t)v * 3 + k) * ch * HID, HID, 64 * it, 32 * warp, acc, lane);
    }
  }
}

}  // namespace bwd
}  // namespace dpn
