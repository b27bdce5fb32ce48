// The bf16 tensor-core body of the collapsed jvp decode, forward, and the stages of it that the
// backward recomputes: shared by decode_jvp_v4.cu (v4 / v4t: tangent rows from the compact dpe
// input), decode_jvp_v4s.cu (v4s: tangent rows are lane blocks of the primal row; v6: the same
// row laid out by direction), decode_bwd_tc.cuh (the backward of v4 / v4t and v4s / v6) and
// decode_jvp_v2.cu (stage 1 is the uncollapsed decode's layer 1).  The design,
// its shared-memory budget and its rounding are set out in decode_jvp_v4.cu's header; in brief:
//
// * 64 points and one variable a block, eight warps.
// * Stage 1 (z, then u_k = tan_k . w1c_k for k = 0, 1, 2): warp w owns all 64 points x columns
//   32 w .. 32 w + 31, streaming its own 32 weight columns in [16, 32] slices through a ring of
//   five of its own; z's relu mask stays in registers (64 bits a lane); T(p) and t_k go to one
//   [4 x 64, 256] bf16 array of row sets.
// * fix_ties: T(p) and t_k near a bf16 rounding tie (a window of ulps with an absolute floor)
//   recomputed in the plain version's order.
// * Stage 2: one pass over w2f1 for the four row sets, cd . wdf1 into r's accumulator (v5: into
//   one of its own, a compile-time switch), in four 64-column passes (warp: 16 points of all four
//   row sets x 32 columns), [128, 64] weight tiles through a block ring of three.
//
// The callers differ in where the block's layer-1 rows come from and in what their epilogues sum;
// the stages take the epilogues as callables.  The rows come from global memory (RowSource: v4 /
// v4t, v4s, v6, the residual sums, the backwards, v2) or from raw coordinates in the kernel
// (decode_pe.cuh's PeSource: v4pe, v3), a compile-time choice of forward_block and fix_ties: the
// front end fills the block's rows, and fix_ties's recompute reads a point's row from global memory
// or computes it again from the point's coordinates.

#pragma once

#include "decode_mma.cuh"

namespace dpn {
namespace jvp {

using tc::bf16;
using tc::ld_of;

constexpr int NB = 64;           // points a block
constexpr int NS = 3;            // weight tiles in the block's ring (stage 2)
constexpr int S1_ROWS = 16;      // weight rows of a warp's stage-1 slice [16, 32]
constexpr int S1_LD = ld_of(32);
constexpr int S1_SLOTS = 5;      // slices in a warp's ring
constexpr int S1_BYTES = S1_ROWS * S1_LD * (int)sizeof(__nv_bfloat16);
constexpr int S2_ROWS = 128;     // weight rows of a stage-2 tile [128, S2_COLS]
constexpr int S2_COLS = 64;      // hidden columns of a stage-2 pass
constexpr int LDA = ld_of(HID);  // row stride of the row sets [T(p); t_0; t_1; t_2]
constexpr int SLOT_BYTES = S2_ROWS * ld_of(S2_COLS) * (int)sizeof(__nv_bfloat16);

static_assert(NB == 8 * WARPS, "stage 1: 4 m16 row tiles a warp; stage 2: 4 point groups x 2 halves");
static_assert(WARPS * S1_SLOTS * S1_BYTES <= NS * SLOT_BYTES, "the warps' stage-1 rings fit in the block's ring");

// T(p) and t_k as the plain version rounds them.  The plain version's z and u_k (cuBLAS in
// f32) sum the products one FMA a term in k order; the tensor cores sum them in another order,
// and where the two sums straddle a bf16 rounding tie, T(p) or t_k differs by one step.
// Through r's relu mask a flipped T(p) switches tangent terms on or off far from any kink of
// r, and a flipped t_k moves a tangent by up to about 5e-4 of its largest (chip_smoke.py's
// [rounding] reading shows the first: float64 sums in place of cuBLAS's flip about 1,650 T(p)
// elements of a flagship frame and move some points' tangents past the bound).  So the kernels
// flag every value whose f32 bits lie within TIE_ULPS_* of a tie and recompute its sum in the
// plain version's order (fix_ties).  z's window is wider: its sum has three times the terms, and
// its k16 products are added with f32 adds (round to nearest), u_k's inside the tensor cores.
// A window in ulps of the value misses the flips of small values, whose sums carry the absolute
// error of their larger terms, so the windows of v4 / v4t, v4s and v6 (forward_block, and the
// backward's recompute of stage 1) also take an absolute floor, TIE_FLOOR_* times the largest
// |value| of the warp's 32 columns of the row.  On an H100, on the flagship weights seeded and
// after two trainings of six steps, an emulation of the tensor cores' sums puts z and u_k within
// 20 and 16 x 2^-24 of that value from cuBLAS's, and the windows miss no flip of T(p) or t_k away
// from a relu kink from a floor of 8 on; the floors are twice that, and flag about 45 and 3 x 38
// values a block and variable (python -m deepphysinet_tpu_torch.diagnostics.tie_window).
constexpr int TIE_ULPS_Z = 32;  // z: twelve k16 products at flagship width
constexpr int TIE_ULPS_U = 8;   // u_k: four
constexpr float TIE_FLOOR_Z = 16.0f * 0x1p-24f;
constexpr float TIE_FLOOR_U = 16.0f * 0x1p-24f;
constexpr int TIE_CAP = 511;    // entries of a block's list of flagged values (v2's fix_group_ties)

// The relu kinks of the forwards (forward_block).  The decode is not continuous in z and r: where
// the tensor cores' sum of a relu argument lies on the other side of zero than cuBLAS's, the kernel
// switches one of 256 terms of a tangent on or off that the plain version does not.  A residual
// sum over a few points carries that point's term (chip_smoke.py's phase 11: 2.6e-3 of the
// continuity sum at 129 points, bound 2e-3).  So forward_block flags every z within KINK_FLOOR_Z,
// and every r within KINK_FLOOR_R, times the largest |value| of the warp's 32 columns of its row
// of zero, and decides its switch by the plain version's sum: z through fix_ties (with its u_k,
// which fix_ties masks by the z it sums), r through r_plain.  The floors are twice the tie floors
// and more, since r's sum has nearly twice z's terms (python -m
// deepphysinet_tpu_torch.diagnostics.residual_points reads the kinks that part).
constexpr float KINK_FLOOR_Z = 32.0f * 0x1p-24f;
constexpr float KINK_FLOOR_R = 64.0f * 0x1p-24f;

// The tests below combine their terms with & and |, not && and ||: stage 1's epilogues test every
// element of a warp tile, and with the floors the short-circuit forms compiled to branches there
// that made the v4s forward 0.91 ms at 20,480 points, the bitwise forms 0.76 (an H100 at 700 W,
// diagnostics/decode_timing.py).
template <int ULPS> __device__ __forceinline__ bool near_bf16_tie(float x) {
  const int low = (int)(__float_as_uint(x) & 0xffffu);
  return (x != 0.0f) & (abs(low - 0x8000) <= ULPS);
}

// |x - its nearest bf16 rounding tie| (ties lie halfway between neighbouring bf16 values).
__device__ __forceinline__ float bf16_tie_distance(float x) {
  const uint32_t b = __float_as_uint(x);
  return (float)abs((int)(b & 0xffffu) - 0x8000) * (__uint_as_float(b & 0x7f800000u) * 0x1p-23f);
}

// The same, or x within `floor` of a tie.  A window in ulps of x misses the flips of small values,
// whose sums carry the absolute error of their larger terms; where a downstream bf16 rounding
// magnifies any upstream flip (the uncollapsed v2 chain: a flipped T(p) moves c past a tie of
// T(c), a flipped T(c) switches r's relu mask), the window also takes an absolute floor, a
// multiple of the largest |value| of the warp's 32 columns of the row.
template <int ULPS> __device__ __forceinline__ bool near_bf16_tie(float x, float floor) {
  return near_bf16_tie<ULPS>(x) | ((x != 0.0f) & (bf16_tie_distance(x) <= floor));
}

// Where the layer-1 rows of the points lie in global memory (ch = in_ch / 3):
//   v4   pe [n, in_ch] primal rows; dm = dpe [3, n, ch] tangent rows;
//   v4s  pe [n, in_ch]; direction k's tangent row is lanes k ch .. k ch + ch - 1 of pe's row;
//   v6   dm = trig [3, n, ch]; the primal row is trig[0, p] | trig[1, p] | trig[2, p] and
//        direction k's tangent row is trig[k, p].
struct RowSource {
  static constexpr bool IN_KERNEL = false;  // the rows lie in global memory (PeSource: computed)
  const bf16* pe;  // nullptr for v6
  const bf16* dm;  // direction-major [3, n, ch]: v4's dpe, v6's trig; nullptr for v4s
  int64_t n;
  int in_ch;

  // &primal row of the point at lane k: the lanes after k to the end of its block of ch follow it
  __device__ __forceinline__ const bf16* primal_ptr(int64_t point, int k) const {
    const int ch = in_ch / 3;
    return pe ? pe + point * in_ch + k : dm + ((int64_t)(k / ch) * n + point) * ch + k % ch;
  }
  // &tangent row dir of the point at lane j (of ch, contiguous)
  __device__ __forceinline__ const bf16* tangent_ptr(int dir, int64_t point, int j) const {
    const int ch = in_ch / 3;
    return dm ? dm + ((int64_t)dir * n + point) * ch + j : pe + point * in_ch + dir * ch + j;
  }
  // the tangent rows are lane blocks of the primal row (v4s and v6), not an input of their own
  __device__ __forceinline__ bool tangents_in_primal() const { return pe == nullptr || dm == nullptr; }
};

// The block's primal rows into pe_s (row stride ldp) and, for v4, its three dpe row blocks into
// dpe_s ([3, NB, ldd]), by cp.async; rows at or past n are zeros.  No commit.
__device__ __forceinline__ void primal_rows_async(const RowSource& src, bf16* pe_s, int ldp, int64_t n0) {
  const int ch = src.in_ch / 3;
  if (src.pe) {
    tc::rows_async(pe_s, ldp, src.pe, n0, src.n, NB, src.in_ch);
  } else {
    for (int k = 0; k < 3; ++k) tc::rows_async(pe_s + k * ch, ldp, src.dm + (size_t)k * src.n * ch, n0, src.n, NB, ch);
  }
}

// Element b (bit 4 nt + i) of stage 1's row tile mt of the calling lane, in fix_ties's list form:
// q (0: z, k + 1: u_k) << 16 | row << 8 | column.
__device__ __forceinline__ int tie_entry(int q, int mt, int b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = 16 * mt + (lane >> 2) + 8 * ((b >> 1) & 1);
  const int col = 32 * warp + 8 * (b >> 2) + 2 * (lane & 3) + (b & 1);
  return q << 16 | row << 8 | col;
}

// Stage 1's values near a bf16 tie, recomputed (the forwards of v4 / v4t, v4s, v6, v2, v3 and v4pe,
// and the backwards): bit 4 nt + i of tie_z[mt] and bit 16 k + 4 nt + i of tie_u[mt] flag the lane's
// accumulator element [mt][nt][i] of stage 1's warp tile (row 16 mt + g + 8 (i >> 1), column
// 32 warp + 8 nt + 2 t + (i & 1)) of z or u_k.  Each flagged element's sum s = sum_k a[n0 + row, k]
// w[k, col] (primal row . w1, or tangent row k . w1c_k) is formed again as the plain version forms
// it, one FMA a term in k order from zero (the product of two bf16 values is exact in f32), and
// T(relu(s + b1)) or T(s) goes to its row set.  Each warp recomputes its own tile's elements, one
// lane an element: it lists them in its 32 entries of list ([WARPS x 32]), z's first, then u_k's,
// up to a pass's worth at a time (32; 16 for PeSource), so that the lanes of a pass run chains of
// one length and all their weights lie in the warp's 32 columns.  Those columns come FIX_ROWS rows
// at a time into the warp's slice of the ring's memory (16-byte cp.async copies, a weight row's 64
// bytes by four lanes, all in flight at once), and each lane reads its weights there and its row's
// values from global memory (RowSource: 8 values a load, issued before the slice's copies) or, for
// PeSource, from the warp's chunk rows in the ring's memory after the slices, which the warp fills
// from the points' coordinates while the copies are in flight: a chunk of FIX_ROWS values is one
// coordinate channel, and lane j computes its angle j (PeSource::chunk_pair) for every listed element
// that reads the chunk, so a pass costs each lane one sincosf an element and chunk, not 32.  Rows at
// or past n are zeros (s = 0).  The ring must be free: no cp.async group of the thread in flight,
// stage 2's not started.  Needs in_ch / 3 to be a multiple of FIX_ROWS (PeSource: equal to it).
// Called by the whole block; ends with a barrier.
constexpr int FIX_ROWS = 64;                                            // weight rows a slice holds
constexpr int FIX_SLICE_BYTES = FIX_ROWS * 32 * (int)sizeof(__nv_bfloat16);  // [FIX_ROWS, 32]
constexpr int FIX_PE_PASS = 16;                                          // PeSource: elements a pass
constexpr int FIX_CHUNK_BYTES = FIX_PE_PASS * FIX_ROWS * (int)sizeof(__nv_bfloat16);  // a warp's chunk rows
static_assert(WARPS * (FIX_SLICE_BYTES + FIX_CHUNK_BYTES) <= NS * SLOT_BYTES,
              "fix_ties's warp slices and chunk rows fit in the ring");

template <class Src>
__device__ __forceinline__ void fix_ties(uint32_t (&tie_z)[4], uint64_t (&tie_u)[4], const Src& src,
                                         const bf16* __restrict__ w1v, const bf16* __restrict__ w1cv,
                                         const float* __restrict__ b1, int64_t n0, bf16* sets, int* list,
                                         unsigned char* ring) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int PASS = Src::IN_KERNEL ? FIX_PE_PASS : 32;  // elements a pass lists
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, in_ch = src.in_ch, ch = in_ch / 3;
  int* wl = list + warp * 32;
  bf16* slice = reinterpret_cast<bf16*>(ring + warp * FIX_SLICE_BYTES);  // rows of the warp's 32 columns
  // PeSource: the chunk of each listed element, [PASS, FIX_ROWS]
  bf16* chunks = reinterpret_cast<bf16*>(ring + WARPS * FIX_SLICE_BYTES + warp * FIX_CHUNK_BYTES);
  for (int kind = 0; kind < 2; ++kind) {  // z's elements, then u_k's
    while (true) {
      int mine = 0;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) mine += kind == 0 ? __popc(tie_z[mt]) : __popcll(tie_u[mt]);
      int upto = mine;  // the warp's inclusive prefix sum
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(FULL, upto, d);
        if (lane >= d) upto += x;
      }
      const int total = __shfl_sync(FULL, upto, 31);
      if (total == 0) break;
      int at = upto - mine;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        if (kind == 0) {
          for (uint32_t f = tie_z[mt]; f != 0u && at < PASS; f &= f - 1u) {
            const int b = __ffs(f) - 1;
            wl[at++] = tie_entry(0, mt, b);
            tie_z[mt] &= ~(1u << b);
          }
        } else {
          for (uint64_t f = tie_u[mt]; f != 0u && at < PASS; f &= f - 1u) {
            const int b = __ffsll(f) - 1;
            wl[at++] = tie_entry(1 + (b >> 4), mt, b & 15);
            tie_u[mt] &= ~(1ull << b);
          }
        }
      }
      __syncwarp();
      const int n_listed = min(total, PASS);
      const bool listed = lane < n_listed;
      const int entry = listed ? wl[lane] : 0;
      const int q = entry >> 16, row = (entry >> 8) & 0xff, col = entry & 0xff;
      const int64_t point = n0 + row;
      // the weights the listed elements read: w1v (z), or w1c_k of each direction k present
      const unsigned dirs = kind == 0 ? 1u : __reduce_or_sync(FULL, listed ? 1u << (q - 1) : 0u);
      float s = 0.0f;
      for (int d = 0; d < 3; ++d) {
        if (!((dirs >> d) & 1u)) continue;
        const bf16* w = kind == 0 ? w1v : w1cv + (size_t)d * ch * HID;
        const bool live = listed && (kind == 0 || q == d + 1) && point < src.n;
#pragma unroll 1
        for (int k0 = 0; k0 < (kind == 0 ? in_ch : ch); k0 += FIX_ROWS) {
          uint4 av[FIX_ROWS / 8];
          if constexpr (!Src::IN_KERNEL) {
            if (live) {
              const bf16* a = kind == 0 ? src.primal_ptr(point, k0) : src.tangent_ptr(d, point, k0);
#pragma unroll
              for (int j = 0; j < FIX_ROWS / 8; ++j) av[j] = *reinterpret_cast<const uint4*>(a + 8 * j);
            }
          }
          __syncwarp();  // the slice's (and the chunk rows') last reads are done
#pragma unroll
          for (int m = 0; m < FIX_ROWS * 4 / 32; ++m) {  // by cp.async: all of a lane's copies in flight at once
            const int i = lane + 32 * m;
            mma::cp_async16(mma::smem_addr(slice + (i >> 2) * 32 + (i & 3) * 8),
                            w + (size_t)(k0 + (i >> 2)) * HID + 32 * warp + (i & 3) * 8, true);
          }
          mma::cp_async_commit();
          if constexpr (Src::IN_KERNEL) {  // the listed elements' chunks, lane j their angle j
            for (int e = 0; e < n_listed; ++e) {
              const int ent = wl[e], q_e = ent >> 16;
              const int64_t point_e = n0 + ((ent >> 8) & 0xff);
              if ((kind == 0 || q_e == d + 1) && point_e < src.n)
                src.chunk_pair(kind == 0 ? k0 / ch : d, kind != 0, point_e, lane, chunks + e * FIX_ROWS);
            }
            __syncwarp();
            if (live) {
#pragma unroll
              for (int j = 0; j < FIX_ROWS / 8; ++j)
                av[j] = *reinterpret_cast<const uint4*>(chunks + lane * FIX_ROWS + 8 * j);
            }
          }
          mma::cp_async_wait<0>();
          __syncwarp();
          if (live) {
            const bf16* wc = slice + (col - 32 * warp);
#pragma unroll
            for (int j = 0; j < FIX_ROWS / 8; ++j) {
              const uint32_t x[4] = {av[j].x, av[j].y, av[j].z, av[j].w};
#pragma unroll
              for (int h = 0; h < 4; ++h) {
                s = fmaf(__uint_as_float(x[h] << 16), to_f32(wc[(8 * j + 2 * h) * 32]), s);
                s = fmaf(__uint_as_float(x[h] & 0xffff0000u), to_f32(wc[(8 * j + 2 * h + 1) * 32]), s);
              }
            }
          }
        }
      }
      // u_k masked by the sign of z as stored: a z listed near zero was summed again above
      if (listed)
        sets[(q * NB + row) * LDA + col] = __float2bfloat16_rn(
            q == 0 ? fmaxf(s + b1[col], 0.0f) : (to_f32(sets[row * LDA + col]) > 0.0f ? s : 0.0f));
      __syncwarp();  // wl is written again
    }
  }
  __syncthreads();  // the row sets are published
}

// Byte offsets of the row region at input width in_ch: the four row sets (rows bytes), under
// whose tail lie the block's primal rows (pe) and, for v4 (with_dpe), its three dpe row blocks
// before them (a dpe block is no larger than a row set, so dpe_k starts no earlier than t_k's
// rows and no t_j with j < k is written over it; pe is dead before T(p) is written).  Without
// dpe the primal rows lie under t_2's rows and are read until u_2 is done.
struct RowRegion {
  int ldp, ldd;
  size_t pe, dpe, dpe_k, rows;
};

__host__ __device__ inline RowRegion row_region(int in_ch, bool with_dpe) {
  RowRegion s;
  s.ldp = ld_of(in_ch);
  s.ldd = ld_of(in_ch / 3);
  const size_t set = (size_t)NB * LDA * sizeof(bf16);
  const size_t pe = (size_t)NB * s.ldp * sizeof(bf16);
  s.dpe_k = with_dpe ? (size_t)NB * s.ldd * sizeof(bf16) : 0;
  s.rows = tc::max_of(4 * set, pe + 3 * s.dpe_k);
  s.dpe = s.rows - 3 * s.dpe_k;
  s.pe = s.dpe - pe;
  return s;
}

// The layout is valid when a dpe block (or, without dpe, the primal rows) fits under one row set.
__host__ __device__ inline bool row_region_valid(int in_ch, bool with_dpe) {
  const RowRegion r = row_region(in_ch, with_dpe);
  const size_t set = (size_t)NB * LDA * sizeof(bf16);
  return with_dpe ? r.dpe_k <= set : r.rows - r.pe <= set;
}

// ---- stage 1 ----------------------------------------------------------------------------
//
// z = pe . w1v + b1 and u_k = tan_k . w1c_k (k = 0, 1, 2) for the block's NB points, warp w
// owning columns 32 w .. 32 w + 31: mask gets z > 0 (bit 4 nt + i of mask[mt] for acc[mt][nt][i]),
// T(p) goes to row set 0 and T(1[z > 0] u_k) to row set k + 1, tie_z / tie_u flag the values
// near a bf16 tie (fix_ties).  The primal rows pe_s (stride ldp) and direction k's tangent rows
// at tan_s + k * tan_k (stride ldt) are the caller's first cp.async group, committed before the
// call; the weights stream through per-warp slice rings in the block ring's memory (ring).
// on_z(mt, nt, h, col, p0, p1) sees p = relu(z) at columns col = 32 w + 8 nt + 2 t and col + 1 of
// row 16 mt + g + 8 h, and on_u(k, mt, nt, h, col, u0, u1) the masked u_k in f32, both before the
// bf16 rounding.  With Z_FLOOR, tie_z also flags each p within z_tie_floor times the largest |z|
// of the warp's 32 columns of its row of a tie (the two-argument near_bf16_tie); with U_FLOOR,
// tie_u each masked u_k within u_tie_floor times the largest |masked u_k| of those columns.  With
// Z_KINK (and Z_FLOOR), a z within z_kink_floor times that largest |z| of zero flags its p in tie_z
// and its three u_k in tie_u, masked or not: fix_ties sums them again and masks the u_k by the new
// z (KINK_FLOOR_Z).  mask keeps the tensor cores' signs.
template <bool Z_FLOOR = false, bool U_FLOOR = false, bool Z_KINK = false, class OnZ, class OnU>
__device__ __forceinline__ void stage1(const bf16* pe_s, int ldp, const bf16* tan_s, int ldt, int tan_k,
                                       const bf16* __restrict__ w1v, const bf16* __restrict__ w1cv,
                                       const float* __restrict__ b1, int in_ch, unsigned char* ring,
                                       bf16* sets, uint32_t (&mask)[4], uint32_t (&tie_z)[4],
                                       uint64_t (&tie_u)[4], OnZ on_z, OnU on_u, float z_tie_floor = 0.0f,
                                       float u_tie_floor = 0.0f, float z_kink_floor = 0.0f) {
  static_assert(Z_FLOOR || !Z_KINK, "the kink floor is a share of the tie floor's largest |z|");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int ch = in_ch / 3;
  // stage 1's weights, per warp and without block barriers: the warp's 32 columns of w1, then
  // of w1c_0..2, in [16, 32] slices through a ring of S1_SLOTS slices of its own (in the block
  // ring's memory, which stage 2 takes once stage 1 is done).  Slice i lands in slot
  // i % S1_SLOTS; each slice taken issues the one S1_SLOTS - 1 ahead, into the slot the warp
  // read before.
  bf16* wring = reinterpret_cast<bf16*>(ring) + warp * S1_SLOTS * S1_ROWS * S1_LD;
  const int nz = in_ch / S1_ROWS, nu = ch / S1_ROWS;
  const auto slice_issue = [&](int i) {
    if (i < nz + 3 * nu) {
      const bf16* src = (i < nz ? w1v + (size_t)i * S1_ROWS * HID : w1cv + (size_t)(i - nz) * S1_ROWS * HID) +
                        32 * warp;
      bf16* dst = wring + (i % S1_SLOTS) * S1_ROWS * S1_LD;
      for (int c = lane; c < S1_ROWS * 4; c += 32)  // four 16-byte pieces a row
        mma::cp_async16(mma::smem_addr(dst + (c >> 2) * S1_LD + (c & 3) * 8),
                        src + (size_t)(c >> 2) * HID + (c & 3) * 8, true);
    }
    mma::cp_async_commit();
  };
  int slice = 0;
  const auto slice_next = [&]() {
    mma::cp_async_wait<S1_SLOTS - 2>();  // this lane's copies of the slice are done ...
    __syncwarp();                         // ... and every lane's, and the slot refilled below is read
    slice_issue(slice + S1_SLOTS - 1);
    return tc::b_lane(wring + (slice++ % S1_SLOTS) * S1_ROWS * S1_LD, S1_LD, lane);
  };
  for (int i = 0; i < S1_SLOTS - 1; ++i) slice_issue(i);
  mma::cp_async_wait<S1_SLOTS - 1>();  // the rows ...
  __syncthreads();                      // ... of every thread

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) mask[mt] = tie_z[mt] = 0u, tie_u[mt] = 0u;
  tc::zero_acc(acc);
  for (int j = 0; j < nz; ++j)
    tc::warp_mma<4, 4, 1, 4>(acc, tc::a_lane(pe_s + j * S1_ROWS, ldp, lane), 16 * ldp * sizeof(bf16),
                             slice_next(), 0);
  __syncthreads();  // pe_s may lie under the row sets
  float floor_z[4][2] = {};  // z_tie_floor times the largest |z| of the warp's 32 columns of each of the lane's rows
  float kink_z[4][2] = {};   // Z_KINK: z_kink_floor times the same
  if constexpr (Z_FLOOR) {
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float m = 0.0f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * warp + 8 * nt + t2;
          m = fmaxf(m, fmaxf(fabsf(acc[mt][nt][2 * h] + b1[col]), fabsf(acc[mt][nt][2 * h + 1] + b1[col + 1])));
        }
        m = mma::quad_max(m);
        floor_z[mt][h] = z_tie_floor * m;
        kink_z[mt][h] = z_kink_floor * m;
      }
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int col = 32 * warp + 8 * nt + t2;
    const float bias0 = b1[col], bias1 = b1[col + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float z0 = acc[mt][nt][2 * h] + bias0, z1 = acc[mt][nt][2 * h + 1] + bias1;
        mask[mt] |= (z0 > 0.0f ? 1u : 0u) << (4 * nt + 2 * h);
        mask[mt] |= (z1 > 0.0f ? 1u : 0u) << (4 * nt + 2 * h + 1);
        const float p0 = fmaxf(z0, 0.0f), p1 = fmaxf(z1, 0.0f);
        const bool tie0 = Z_FLOOR ? near_bf16_tie<TIE_ULPS_Z>(p0, floor_z[mt][h]) : near_bf16_tie<TIE_ULPS_Z>(p0);
        const bool tie1 = Z_FLOOR ? near_bf16_tie<TIE_ULPS_Z>(p1, floor_z[mt][h]) : near_bf16_tie<TIE_ULPS_Z>(p1);
        tie_z[mt] |= (tie0 ? 1u : 0u) << (4 * nt + 2 * h);
        tie_z[mt] |= (tie1 ? 1u : 0u) << (4 * nt + 2 * h + 1);
        if constexpr (Z_KINK) {
          const uint32_t kinks = (fabsf(z0) <= kink_z[mt][h] ? 1u : 0u) << (4 * nt + 2 * h) |
                                 (fabsf(z1) <= kink_z[mt][h] ? 1u : 0u) << (4 * nt + 2 * h + 1);
          tie_z[mt] |= kinks;
          tie_u[mt] |= (uint64_t)kinks | (uint64_t)kinks << 16 | (uint64_t)kinks << 32;
        }
        on_z(mt, nt, h, col, p0, p1);
        *reinterpret_cast<uint32_t*>(sets + (16 * mt + g + 8 * h) * LDA + col) = mma::pack_bf16x2(p0, p1);
      }
  }

  for (int k = 0; k < 3; ++k) {
    tc::zero_acc(acc);
    const bf16* d_s = tan_s + k * tan_k;
    for (int j = 0; j < nu; ++j)
      tc::warp_mma<4, 4, 1>(acc, tc::a_lane(d_s + j * S1_ROWS, ldt, lane), 16 * ldt * sizeof(bf16),
                            slice_next(), 0);
    __syncthreads();  // the tangent rows may lie under t_k's rows
    bf16* t_s = sets + (k + 1) * NB * LDA;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)  // u_k = 1[z > 0] (tan_k . w1c_k)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (!((mask[mt] >> (4 * nt + i)) & 1u)) acc[mt][nt][i] = 0.0f;
    float floor_u[4][2] = {};  // u_tie_floor times the largest |u_k| of the warp's 32 columns of each row
    if constexpr (U_FLOOR) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float m = 0.0f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) m = fmaxf(m, fmaxf(fabsf(acc[mt][nt][2 * h]), fabsf(acc[mt][nt][2 * h + 1])));
          floor_u[mt][h] = u_tie_floor * mma::quad_max(m);
        }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 32 * warp + 8 * nt + t2;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bit = 4 * nt + 2 * h;
          const float u0 = acc[mt][nt][2 * h], u1 = acc[mt][nt][2 * h + 1];
          const bool tie0 = U_FLOOR ? near_bf16_tie<TIE_ULPS_U>(u0, floor_u[mt][h]) : near_bf16_tie<TIE_ULPS_U>(u0);
          const bool tie1 = U_FLOOR ? near_bf16_tie<TIE_ULPS_U>(u1, floor_u[mt][h]) : near_bf16_tie<TIE_ULPS_U>(u1);
          tie_u[mt] |= (uint64_t)(tie0 ? 1u : 0u) << (16 * k + bit);
          tie_u[mt] |= (uint64_t)(tie1 ? 1u : 0u) << (16 * k + bit + 1);
          on_u(k, mt, nt, h, col, u0, u1);
          *reinterpret_cast<uint32_t*>(t_s + (16 * mt + g + 8 * h) * LDA + col) = mma::pack_bf16x2(u0, u1);
        }
    }
  }
}

// ---- stage 2 ----------------------------------------------------------------------------
//
// The ring of stage 2's weight tiles in the order they are multiplied: per 64-column pass c,
// w2f1 and wdf1 ([128, 64], wdf1's last one shorter).  Start it only once every warp is past its
// stage-1 slices (stage 1's last barrier), since the slices lie in the same memory.
__device__ __forceinline__ auto stage2_ring(unsigned char* ring, const bf16* __restrict__ w2f1v,
                                            const bf16* __restrict__ wdf1v, int in_ch) {
  const int nd = (in_ch + S2_ROWS - 1) / S2_ROWS, per_pass = HID / S2_ROWS + nd;
  auto issue = [=](int i, unsigned char* slot) {
    const int c = i / per_pass, j = i - c * per_pass;
    bf16* dst = reinterpret_cast<bf16*>(slot);
    if (j < HID / S2_ROWS) {
      tc::tile_async<S2_COLS>(dst, ld_of(S2_COLS), w2f1v + (size_t)j * S2_ROWS * HID + c * S2_COLS, HID,
                              S2_ROWS);
    } else {
      const int r0 = (j - HID / S2_ROWS) * S2_ROWS;
      tc::tile_async<S2_COLS>(dst, ld_of(S2_COLS), wdf1v + (size_t)r0 * HID + c * S2_COLS, HID,
                              min(S2_ROWS, in_ch - r0));
    }
  };
  return tc::make_ring<NS>(ring, SLOT_BYTES, (HID / S2_COLS) * per_pass, issue);
}

// [T(p); t_0; t_1; t_2] . w2f1 with cd . wdf1 added into r's accumulator (row set 0), in four
// 64-column passes: warp w owns points 16 (w & 3) .. + 15 of the four row sets (acc[s]) and
// columns 32 (w >> 2) .. + 31 of the pass.  epi(c, acc) after pass c: acc[s][nt][i] is row
// 16 (w & 3) + g + 8 (i >> 1) of set s at column 64 c + 32 (w >> 2) + 8 nt + 2 t + (i & 1),
// r without rbias for s = 0.  With SPLIT_R (v5) cd . wdf1 goes into an accumulator of its own,
// live only over the pass's wdf1 tiles, and set 0 reaches epi as r = T(p) . w2f1 + (cd . wdf1 +
// rbias), rbias [HID] included.  The sets and cd_s (stride ldp) must be published (a barrier).
template <bool SPLIT_R = false, class Ring, class Epi>
__device__ __forceinline__ void stage2(Ring& ring, const bf16* sets, const bf16* cd_s, int ldp, int in_ch, Epi epi,
                                       const float* __restrict__ rbias = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, pg = warp & 3, half = warp >> 2;
  const int nd = (in_ch + S2_ROWS - 1) / S2_ROWS;
  constexpr uint32_t S2_K16 = 16 * ld_of(S2_COLS) * sizeof(bf16);
  float acc[4][4][4];
#pragma unroll 1
  for (int c = 0; c < HID / S2_COLS; ++c) {
    tc::zero_acc(acc);
    for (int j = 0; j < HID / S2_ROWS; ++j) {  // [T(p); t_0; t_1; t_2] . w2f1
      const uint32_t b = tc::b_lane(ring.next() + 32 * half, ld_of(S2_COLS), lane);
      const uint32_t a = tc::a_lane(sets + 16 * pg * LDA + j * S2_ROWS, LDA, lane);
      tc::warp_mma<4, 4, 4, 1>(acc, a, NB * LDA * sizeof(bf16), b, S2_K16);
      tc::warp_mma<4, 4, 4, 1>(acc, a + 64 * sizeof(bf16), NB * LDA * sizeof(bf16), b + 4 * S2_K16, S2_K16);
    }
    float acc_cd[1][4][4];  // SPLIT_R: cd . wdf1 of set 0
    if constexpr (SPLIT_R) tc::zero_acc(acc_cd);
    for (int j = 0; j < nd; ++j) {  // + cd . wdf1, into r's accumulator (SPLIT_R: its own)
      const uint32_t b = tc::b_lane(ring.next() + 32 * half, ld_of(S2_COLS), lane);
      const uint32_t a = tc::a_lane(cd_s + 16 * pg * ldp + j * S2_ROWS, ldp, lane);
      const int k16 = min(S2_ROWS, in_ch - j * S2_ROWS) / 16;
      for (int q = 0; q < k16; q += 4)
        tc::warp_mma<1, 4, 4, 1>(SPLIT_R ? acc_cd : acc, a + q * 32, 0, b + q * S2_K16, S2_K16);
    }
    if constexpr (SPLIT_R) {
      const int t2 = 2 * (lane & 3);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[0][nt][i] += acc_cd[0][nt][i] + rbias[c * S2_COLS + 32 * half + 8 * nt + t2 + (i & 1)];
    }
    epi(c, acc);
  }
}

// ---- the forward ----------------------------------------------------------------------------
//
// Byte offsets of the forward's shared memory at input width in_ch: the row region (row_region),
// cd, the ring, the per-point partial sums of stage 1 ([4][WARPS][NB]: p . w2wo, t_k . w2wo by
// warp), of stage 2 ([2][4][NB]: relu(r) . fw2, then the three masked tangents, by column half)
// and cd . wdwo ([NB]).
struct FwdSmem {
  RowRegion rows;
  size_t cd, ring, red1, red2, redc, total;
};

__host__ __device__ inline FwdSmem fwd_smem(int in_ch, bool with_dpe) {
  FwdSmem s;
  s.rows = row_region(in_ch, with_dpe);
  s.cd = s.rows.rows;
  s.ring = s.cd + (size_t)NB * s.rows.ldp * sizeof(bf16);
  s.red1 = s.ring + (size_t)NS * SLOT_BYTES;
  s.red2 = s.red1 + (size_t)4 * WARPS * NB * sizeof(float);
  s.redc = s.red2 + (size_t)2 * 4 * NB * sizeof(float);
  s.total = s.redc + (size_t)NB * sizeof(float);
  return s;
}

static_assert(WARPS * 32 <= 2 * 4 * NB, "fix_ties's lists fit in stage 2's partial sums");

// r at one element as the plain version sums it (KINK_FLOOR_R): T(p) . w2f1 and cd . wdf1 each one
// FMA a term in k order from zero (a product of two bf16 values is exact in f32), then (s1 + s2),
// to which the caller adds rbias, or with SPLIT_R s1 + (s2 + rbias).  p_row and cd_row are the
// point's rows of T(p) and cd in shared memory, w2f1v and wdf1v the variable's weights.  Not
// inlined: forward_block's epilogue calls it from one site, for its rare r near zero only.
template <bool SPLIT_R>
__device__ __noinline__ float r_plain(const bf16* p_row, const bf16* cd_row, const bf16* __restrict__ w2f1v,
                                      const bf16* __restrict__ wdf1v, int in_ch, int col, float rb) {
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll 8
  for (int k = 0; k < HID; ++k) s1 = fmaf(to_f32(p_row[k]), to_f32(w2f1v[(size_t)k * HID + col]), s1);
#pragma unroll 8
  for (int k = 0; k < in_ch; ++k) s2 = fmaf(to_f32(cd_row[k]), to_f32(wdf1v[(size_t)k * HID + col]), s2);
  return SPLIT_R ? s1 + (s2 + rb) : s1 + s2;
}

// The forward of one block (NB points from blockIdx.x, variable blockIdx.y): primal and the three
// tangents of every point, from src (RowSource, with cd [n, in_ch]; or PeSource, which computes the
// pe, dpe and cd rows, cd unused) and ref, into primal / tang in the var-major ([n_vars, n],
// [3, n_vars, n]; tl) or point-major layout.  w1v [in_ch, HID] and w1cv [3, ch, HID] are the
// variable's primal and tangent layer-1 rows.  The layout changes only addresses, so the layouts,
// and v4s against v6, give the same bits.  SPLIT_R: r summed as v5 sums it (stage2).
template <bool SPLIT_R = false, class Src>
__device__ __forceinline__ void forward_block(const Src& src, const bf16* cd, const float* __restrict__ ref,
                                              const bf16* __restrict__ w1v, const bf16* __restrict__ w1cv,
                                              const float* __restrict__ b1, const bf16* __restrict__ w2f1,
                                              const bf16* __restrict__ wdf1, const float* __restrict__ rbias,
                                              const float* __restrict__ fw2, const float* __restrict__ w2wo,
                                              const float* __restrict__ wdwo, const float* __restrict__ obias,
                                              float* __restrict__ primal, float* __restrict__ tang, int n_vars,
                                              bool tl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t n = src.n;
  const int in_ch = src.in_ch;
  const bool with_dpe = !src.tangents_in_primal();
  const FwdSmem L = fwd_smem(in_ch, with_dpe);
  bf16* sets = reinterpret_cast<bf16*>(smem);  // [4 x NB, LDA]: T(p), t_0, t_1, t_2
  bf16* pe_s = reinterpret_cast<bf16*>(smem + L.rows.pe);
  bf16* dpe_s = reinterpret_cast<bf16*>(smem + L.rows.dpe);
  bf16* cd_s = reinterpret_cast<bf16*>(smem + L.cd);
  float* red1 = reinterpret_cast<float*>(smem + L.red1);
  float* red2 = reinterpret_cast<float*>(smem + L.red2);
  float* redc = reinterpret_cast<float*>(smem + L.redc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3, ldp = L.rows.ldp, ldd = L.rows.ldd;
  const bf16* w2f1v = w2f1 + (size_t)v * HID * HID;
  const bf16* wdf1v = wdf1 + (size_t)v * in_ch * HID;
  b1 += v * HID; rbias += v * HID; fw2 += v * HID; w2wo += v * HID;

  // the block's rows: the first cp.async group of every thread (computed by the front end: an empty
  // group, and stage 1's first barrier publishes the rows)
  if constexpr (Src::IN_KERNEL) {
    src.front(pe_s, ldp, dpe_s, ldd, cd_s, n0, NB);
  } else {
    primal_rows_async(src, pe_s, ldp, n0);
    tc::rows_async(cd_s, ldp, cd, n0, n, NB, in_ch);
    if (with_dpe)
      for (int k = 0; k < 3; ++k) tc::rows_async(dpe_s + k * NB * ldd, ldd, src.dm + (size_t)k * n * ch, n0, n, NB, ch);
  }
  mma::cp_async_commit();

  // ---- stage 1, with the per-point sums p . w2wo (p in f32) ----
  uint32_t mask[4], tie_z[4];
  uint64_t tie_u[4];
  {
    float s[4][2] = {};
    const auto on_z = [&](int mt, int, int h, int col, float p0, float p1) {
      s[mt][h] = fmaf(p1, w2wo[col + 1], fmaf(p0, w2wo[col], s[mt][h]));
    };
    const auto on_u = [](int, int, int, int, int, float, float) {};
    // direction k's tangent rows: v4's dpe block k, or lanes k ch .. of the primal rows
    stage1<true, true, true>(pe_s, ldp, with_dpe ? dpe_s : pe_s, with_dpe ? ldd : ldp, with_dpe ? NB * ldd : ch,
                             w1v, w1cv, b1, in_ch, smem + L.ring, sets, mask, tie_z, tie_u, on_z, on_u, TIE_FLOOR_Z,
                             TIE_FLOOR_U, KINK_FLOOR_Z);
    tc::store_row_sums(s, red1 + warp * NB, lane);
  }
  tc::cd_sums(cd_s, ldp, in_ch, wdwo + v * in_ch, NB, redc);

  // T(p) and t_k near a rounding tie, recomputed in the plain version's order: red2 holds the
  // lists until stage 2 ends, and the ring's memory the warps' weight slices (every warp is past
  // its stage-1 slices)
  fix_ties(tie_z, tie_u, src, w1v, w1cv, b1, n0, sets, reinterpret_cast<int*>(red2), smem + L.ring);
  // stage 2's tiles are in flight from here on
  auto ring = stage2_ring(smem + L.ring, w2f1v, wdf1v, in_ch);
  ring.start();
  // sum(t_k * w2wo) from t_k as stored (published by fix_ties's barrier)
  for (int k = 0; k < 3; ++k) {
    const bf16* t_s = sets + (k + 1) * NB * LDA;
    float s[4][2] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 32 * warp + 8 * nt + t2;
      const float wo0 = w2wo[col], wo1 = w2wo[col + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t t16 = *reinterpret_cast<const uint32_t*>(t_s + (16 * mt + g + 8 * h) * LDA + col);
          s[mt][h] = fmaf(__uint_as_float(t16 & 0xffff0000u), wo1,
                          fmaf(__uint_as_float(t16 << 16), wo0, s[mt][h]));
        }
    }
    tc::store_row_sums(s, red1 + ((k + 1) * WARPS + warp) * NB, lane);
  }

  // ---- stage 2, with the per-point sums relu(r) . fw2 and 1[r > 0] (t_k . w2f1) . fw2 ----
  const int pg = warp & 3, half = warp >> 2;
  float s_r[2] = {0.0f, 0.0f}, s_t[3][2] = {};
  stage2<SPLIT_R>(ring, sets, cd_s, ldp, in_ch, [&](int c, float (&acc)[4][4][4]) {
    // r near zero (KINK_FLOOR_R of the largest |r| of the warp's 32 columns of its row), summed
    // again as the plain version sums it: the tests are branch-free, the rare recompute is not
    float kink_r[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float rb = SPLIT_R ? 0.0f : rbias[c * S2_COLS + 32 * half + 8 * nt + t2 + (i & 1)];
        kink_r[i >> 1] = fmaxf(kink_r[i >> 1], fabsf(acc[0][nt][i] + rb));
      }
    kink_r[0] = KINK_FLOOR_R * mma::quad_max(kink_r[0]);
    kink_r[1] = KINK_FLOOR_R * mma::quad_max(kink_r[1]);
    uint32_t kinks = 0u;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float rb = SPLIT_R ? 0.0f : rbias[c * S2_COLS + 32 * half + 8 * nt + t2 + (i & 1)];
        kinks |= (fabsf(acc[0][nt][i] + rb) <= kink_r[i >> 1] ? 1u : 0u) << (4 * nt + i);
      }
#pragma unroll 1
    for (; kinks != 0u; kinks &= kinks - 1u) {
      const int b = __ffs(kinks) - 1, i = b & 3;
      const int row = 16 * pg + g + 8 * (i >> 1), col = c * S2_COLS + 32 * half + 8 * (b >> 2) + t2 + (i & 1);
      const float r = r_plain<SPLIT_R>(sets + row * LDA, cd_s + row * ldp, w2f1v, wdf1v, in_ch, col,
                                       SPLIT_R ? rbias[col] : 0.0f);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nt][e] = 4 * nt + e == b ? r : acc[0][nt][e];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c * S2_COLS + 32 * half + 8 * nt + t2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float rb = SPLIT_R ? 0.0f : rbias[col + e], f = fw2[col + e];  // SPLIT_R: in acc[0]
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float rv = SPLIT_R ? acc[0][nt][2 * h + e] : acc[0][nt][2 * h + e] + rb;
          s_r[h] = fmaf(fmaxf(rv, 0.0f), f, s_r[h]);
          if (rv > 0.0f) {
#pragma unroll
            for (int k = 0; k < 3; ++k) s_t[k][h] = fmaf(acc[k + 1][nt][2 * h + e], f, s_t[k][h]);
          }
        }
      }
    }
  }, rbias);
  {
    float sr[1][2] = {{s_r[0], s_r[1]}};
    tc::store_row_sums(sr, red2 + (half * 4) * NB + 16 * pg, lane);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float st[1][2] = {{s_t[k][0], s_t[k][1]}};
      tc::store_row_sums(st, red2 + (half * 4 + k + 1) * NB + 16 * pg, lane);
    }
  }
  __syncthreads();

  // ---- the block's outputs: one thread a point, the partial sums in a fixed order ----
  const int row = threadIdx.x;
  const int64_t point = n0 + row;
  if (row < NB && point < n) {
    float s_p = 0.0f;
    for (int w = 0; w < WARPS; ++w) s_p += red1[w * NB + row];
    const int64_t at = primal_at(tl, point, v, n, n_vars);
    primal[at] = (red2[row] + red2[4 * NB + row]) + 2.0f * (s_p + redc[row]) + obias[v] + ref[at];
    for (int k = 0; k < 3; ++k) {
      float s_tw = 0.0f;
      for (int w = 0; w < WARPS; ++w) s_tw += red1[((k + 1) * WARPS + w) * NB + row];
      tang[tangent_at(tl, k, point, v, n, n_vars)] =
          (red2[(k + 1) * NB + row] + red2[(5 + k) * NB + row]) + 2.0f * s_tw;
    }
  }
}

}  // namespace jvp
}  // namespace dpn
