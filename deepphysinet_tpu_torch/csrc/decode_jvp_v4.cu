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
// about 1,200 bytes of point I/O, so it is compute bound.  Blocks own NB = 64
// points and ONE variable (grid = blocks x variables), so blocks are independent and
// a 4,096-point launch still fills the card; the ragged last block is masked here (zero
// rows in, no stores out).  The layout flag changes only the addresses of the ref load
// and the output stores, so the two layouts give the same bits.
//
// bf16 (decode_jvp_v4_tc, the flagship's type): the products on the tensor cores
// (mma.sync m16n8k16 through decode_mma.cuh), in the TPU kernel's two stages
// (_v4_stage1 / _v4_stage2, decode_kernel.py:583-606, :554-580).  Eight warps.
// * Stage 1: z, then u_k = dpe_k . w1c_k for k = 0, 1, 2, each [64, 256] with the same
//   warp tiling (warp w: all 64 points x columns 32 w .. 32 w + 31), so the relu mask of z
//   stays in registers as 64 bits a lane and masks u_k at the same positions.  The
//   epilogues write T(p) and t_k as bf16 rows of one [4 x 64, 256] array (the rounding the
//   TPU kernel does, so the round trip through shared memory rounds nothing more) and sum
//   p * w2wo (p in f32) and t_k * w2wo per point.
// * Stage 2: ONE pass over w2f1 serves the four row sets [T(p); t_0; t_1; t_2]: each
//   weight fragment feeds four products.  The 256 columns go in four passes of 64 (the
//   accumulators of four row sets over all 256 columns would need 256 registers a thread);
//   warp w holds points 16 (w & 3) .. + 15 of all four row sets and columns 32 (w >> 2) ..
//   + 31 of the pass, and cd . wdf1 goes into r's accumulator.  The epilogue takes
//   1[r > 0] from r's fragments, masks the tangents' fragments at the same positions and
//   sums relu(r) * fw2 and 1[r > 0] * rt_k * fw2 without storing r.
// * Weights by cp.async.  Stage 1: each warp streams its own 32 columns in [16, 32] slices
//   through a ring of five of its own, four in flight, with no block barrier a slice (a
//   block-wide ring with a barrier a tile left stage 1 latency-bound).  Stage 2: [128, 64]
//   tiles through a block-wide ring of three (decode_mma.cuh's TileRing), in the same memory,
//   the next tile's copy in flight while one is multiplied.  Per block and variable the
//   weights come to 416 KB of L2 reads at flagship width (w1 96 KB, w1c 96 KB, w2f1 128 KB,
//   wdf1 96 KB): 6.5 KB a point and variable, 39 KB a point for the six, where the CUDA-core
//   body, which streams w2f1 once for p and once for each tangent, reads 800 KB (75 KB).
// * Per-point sums: quad shuffles, then across warps through small shared arrays, added in
//   a fixed order (no atomics), so a launch's bits do not depend on timing.
// * Shared memory at flagship width (in_ch 192): the [256, 264] bf16 row sets (135,168
//   bytes; the block's pe and dpe rows are loaded into its tail, each dead before the rows
//   over it are written), cd (25,600), the ring (3 x 18,432; stage 1's eight warp rings,
//   8 x 5 x 1,280, lie in it), the per-point partial sums (10,496): 226,560 bytes (V4Smem).
// * Rounding.  The products are exact and summed in f32 in another order than the plain
//   version's (cuBLAS: one FMA a term, in k order).  z and r take each k16 product into
//   zeros and add it with an f32 add (warp_mma's RN rows): the tensor cores' own running
//   sum rounds differently, and z feeds T(p) and both relu masks.  Where z or u_k lies
//   within TIE_ULPS_Z / TIE_ULPS_U of a bf16 rounding tie, T(p) or t_k is recomputed in the
//   plain version's order once stage 1 is done (fix_ties); without that, T(p) and t_k flip by
//   one step at some elements of a flagship frame, and tangents move past chip_smoke.py's
//   bound.
//
// float (decode_jvp_v4_kernel, the parity configuration; no TF32): the products on the
// CUDA cores (FMA), the chain of decode_common.cuh's primal_stages and tangent_stage; the
// compact tangent rows are loaded over the block's pe rows once r is done.
//
// Two more TPU kernels are compile-time variants of decode_jvp_v4_kernel ([N, 6] outputs,
// CUDA-core products in both types):
// * v5, _decode_kernel_v5 (fused_decode_jvp_v5, decode_kernel.py:1117-1247): the same
//   function with r summed as T(p) . w2f1 + (cd . wdf1 + rbias) (:1149, :1156), so
//   cd . wdf1 gets an accumulator of its own (primal_stages<SPLIT>).  The TPU kernel
//   stacks the six variables' layer-1 products by column into one wide product to cut
//   op dispatch; that changes no sum and is not carried over.
// * v4pe, _decode_kernel_v4pe (fused_decode_jvp_v4pe, :1249-1407): raw coordinates
//   [N, 3] and conditioning values [N, 6] in; decode_pe.cuh computes the block's
//   channel-major pe, cd and tangent rows in the kernel (the wrapper permutes w1, wdf1
//   and wdwo to that order), so direction k's tangent rows are rows k*ch:(k+1)*ch of
//   w1 and no w1c is read.  That adds some 37,000 sinf / cosf per block of a variable
//   to 26 M multiply-adds, and saves the 1,150 bytes a point of prepared inputs.

#include "decode_common.cuh"
#include "decode_mma.cuh"
#include "decode_pe.cuh"

namespace {

using namespace dpn;

constexpr int TM = 8;            // accumulator rows per thread
constexpr int NB = WARPS * TM;   // points per block

enum Variant { kV4 = 0, kV5 = 1, kV4pe = 2 };

// ---- bf16: tensor cores -------------------------------------------------------------

using tc::bf16;
using tc::ld_of;

constexpr int NS = 3;           // weight tiles in the block's ring (stage 2)
constexpr int S1_ROWS = 16;     // weight rows of a warp's stage-1 slice [16, 32]
constexpr int S1_LD = ld_of(32);
constexpr int S1_SLOTS = 5;     // slices in a warp's ring
constexpr int S1_BYTES = S1_ROWS * S1_LD * (int)sizeof(__nv_bfloat16);
constexpr int S2_ROWS = 128;    // weight rows of a stage-2 tile [128, S2_COLS]
constexpr int S2_COLS = 64;     // hidden columns of a stage-2 pass
constexpr int LDA = ld_of(HID); // row stride of the row sets [T(p); t_0; t_1; t_2]

// T(p) and t_k as the plain version rounds them.  The plain version's z and u_k (cuBLAS in
// f32) sum the products one FMA a term in k order; the tensor cores sum them in another order,
// and where the two sums straddle a bf16 rounding tie, T(p) or t_k differs by one step.
// Through r's relu mask a flipped T(p) switches tangent terms on or off far from any kink of
// r, and a flipped t_k moves a tangent by up to about 5e-4 of its largest (chip_smoke.py's
// [rounding] reading shows the first: float64 sums in place of cuBLAS's flip about 1,650 T(p)
// elements of a flagship frame and move some points' tangents past the bound).  So the kernel
// flags every value whose f32 bits lie within TIE_ULPS_* of a tie (about fifteen elements a
// block and variable) and recomputes its sum in the plain version's order (fix_ties).  z's
// window is wider: its sum has three times the terms, and its k16 products are added with f32
// adds (round to nearest), u_k's inside the tensor cores.
constexpr int TIE_ULPS_Z = 32;  // z: twelve k16 products at flagship width
constexpr int TIE_ULPS_U = 8;   // u_k: four
constexpr int TIE_CAP = 511;    // flagged elements a pass of fix_ties lists

template <int ULPS> __device__ __forceinline__ bool near_bf16_tie(float x) {
  const int low = (int)(__float_as_uint(x) & 0xffffu);
  return x != 0.0f && abs(low - 0x8000) <= ULPS;
}

// Stage 1's four values near a bf16 tie, recomputed: bit 4 nt + i of tie_z[mt] and bit
// 16 k + 4 nt + i of tie_u[mt] flag the lane's accumulator element [mt][nt][i] of stage 1's warp
// tile (row 16 mt + g + 8 (i >> 1), column 32 warp + 8 nt + 2 t + (i & 1)) of z or u_k.  Each flagged element's sum
// s = sum_k a[n0 + row, k] w[k, col] (pe . w1, or dpe_k . w1c_k) is formed again as the plain
// version forms it, one FMA a term in k order from zero, and T(relu(s + b1)) or T(s) goes to its
// row set.  pe [n, in_ch] and dpe [3, n, ch] are read from global memory (rows at or past n are
// zeros).  The block lists its flagged elements in list ([TIE_CAP] entries, then their count);
// for up to per_round of them at a time the threads form the products (exact in f32 for bf16
// operands) into prods, one row of in_ch + 1 floats an element, and one thread an element adds
// its row in order, so the block's elements take one chain's time.  A pass takes at most
// TIE_CAP elements; passes repeat until none is left.  Called by the whole block.
__device__ __forceinline__ void fix_ties(uint32_t (&tie_z)[4], uint64_t (&tie_u)[4],
                                         const bf16* __restrict__ pe, const bf16* __restrict__ dpe,
                                         const bf16* __restrict__ w1v,
                                         const bf16* __restrict__ w1cv, const float* __restrict__ b1,
                                         int64_t n0, int64_t n, int in_ch, bf16* sets, int* list,
                                         float* prods, int per_round) {
  constexpr int BATCH = 8;  // products a thread loads before it stores any
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ch = in_ch / 3, ld = in_ch + 1;
  // element b (bit 4 nt + i) of row tile mt in list form: its q (0: z, k + 1: u_k), row, column
  const auto entry_of = [&](int q, int mt, int b) {
    const int row = 16 * mt + (lane >> 2) + 8 * ((b >> 1) & 1);
    const int col = 32 * warp + 8 * (b >> 2) + 2 * (lane & 3) + (b & 1);
    return q << 16 | row << 8 | col;
  };
  bool any = false;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) any |= (tie_z[mt] | tie_u[mt]) != 0u;
  while (__syncthreads_or(any)) {
    if (tid == 0) list[TIE_CAP] = 0;
    __syncthreads();
    any = false;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
      for (uint32_t f = tie_z[mt]; f != 0u; f &= f - 1u) {
        const int b = __ffs(f) - 1, at = atomicAdd(&list[TIE_CAP], 1);
        if (at < TIE_CAP) {
          list[at] = entry_of(0, mt, b);
          tie_z[mt] &= ~(1u << b);
        }
      }
      for (uint64_t f = tie_u[mt]; f != 0u; f &= f - 1u) {
        const int b = __ffsll(f) - 1, at = atomicAdd(&list[TIE_CAP], 1);
        if (at < TIE_CAP) {
          list[at] = entry_of(1 + (b >> 4), mt, b & 15);
          tie_u[mt] &= ~(1ull << b);
        }
      }
      any |= (tie_z[mt] | tie_u[mt]) != 0u;
    }
    __syncthreads();
    const int count = min(list[TIE_CAP], TIE_CAP);
    for (int base = 0; base < count; base += per_round) {
      const int m = min(per_round, count - base), total = m * in_ch;
      for (int i0 = tid; i0 < total; i0 += BATCH * THREADS) {
        float p[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {  // element e's product k: pe or dpe_k by w1 or w1c_k
          const int i = i0 + u * THREADS, e = i / in_ch, k = i - e * in_ch;
          const int entry = i < total ? list[base + e] : 0;
          const int q = entry >> 16, col = entry & 0xff;
          const int64_t point = n0 + ((entry >> 8) & 0xff);
          p[u] = 0.0f;
          if (i < total && point < n && k < (q == 0 ? in_ch : ch)) {
            const bf16* a = q == 0 ? pe + point * in_ch : dpe + ((q - 1) * n + point) * ch;
            const bf16* w = (q == 0 ? w1v : w1cv + (size_t)(q - 1) * ch * HID) + col;
            p[u] = to_f32(a[k]) * to_f32(w[(size_t)k * HID]);
          }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int i = i0 + u * THREADS;
          if (i < total) prods[i / in_ch * ld + i % in_ch] = p[u];
        }
      }
      __syncthreads();
      if (tid < m) {
        const int entry = list[base + tid];
        const int q = entry >> 16, row = (entry >> 8) & 0xff, col = entry & 0xff;
        const float* pr = prods + tid * ld;
        float s = 0.0f;
#pragma unroll 8
        for (int k = 0; k < (q == 0 ? in_ch : ch); ++k) s += pr[k];
        sets[(q * NB + row) * LDA + col] = __float2bfloat16_rn(q == 0 ? fmaxf(s + b1[col], 0.0f) : s);
      }
      __syncthreads();
    }
  }
}

// Byte offsets of the bf16 kernel's shared memory at input width in_ch: the four row sets
// (rows), under whose tail lie the block's pe rows and its three dpe row blocks (a dpe
// block is no larger than a row set, so dpe_k starts no earlier than t_k's rows and no
// t_j with j < k is written over it; pe is dead before T(p) is written); cd; the ring; the
// per-point partial sums of
// stage 1 ([4][WARPS][NB]: p . w2wo, t_k . w2wo by warp), of stage 2 ([2][4][NB]: relu(r) .
// fw2, then the three masked tangents, by column half) and cd . wdwo ([NB]).
struct V4Smem {
  int ldp, ldd;
  size_t pe, dpe, dpe_k, cd, ring, slot, red1, red2, redc, total;
};

__host__ __device__ inline V4Smem v4_smem(int in_ch) {
  V4Smem s;
  s.ldp = ld_of(in_ch);
  s.ldd = ld_of(in_ch / 3);
  const size_t set = (size_t)NB * LDA * sizeof(bf16);
  const size_t pe = (size_t)NB * s.ldp * sizeof(bf16);
  s.dpe_k = (size_t)NB * s.ldd * sizeof(bf16);
  const size_t rows = tc::max_of(4 * set, pe + 3 * s.dpe_k);
  s.dpe = rows - 3 * s.dpe_k;
  s.pe = s.dpe - pe;
  s.cd = rows;
  s.ring = s.cd + pe;
  s.slot = (size_t)S2_ROWS * ld_of(S2_COLS) * sizeof(bf16);
  s.red1 = s.ring + NS * s.slot;
  s.red2 = s.red1 + (size_t)4 * WARPS * NB * sizeof(float);
  s.redc = s.red2 + (size_t)2 * 4 * NB * sizeof(float);
  s.total = s.redc + (size_t)NB * sizeof(float);
  return s;
}

static_assert(TIE_CAP + 1 <= 2 * 4 * NB, "fix_ties's list fits in stage 2's partial sums");
static_assert(WARPS * S1_SLOTS * S1_BYTES <= NS * S2_ROWS * ld_of(S2_COLS) * (int)sizeof(__nv_bfloat16),
              "the warps' stage-1 rings fit in the block's ring");

// The layout is valid when a dpe block fits under one row set (in_ch <= 768).
inline bool v4_smem_valid(int in_ch) {
  return v4_smem(in_ch).dpe_k <= (size_t)NB * LDA * sizeof(bf16);
}

__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v4_tc(PointInputs in, const bf16* __restrict__ w1, const bf16* __restrict__ w1c,
                 const float* __restrict__ b1, const bf16* __restrict__ w2f1,
                 const bf16* __restrict__ wdf1, const float* __restrict__ rbias,
                 const float* __restrict__ fw2, const float* __restrict__ w2wo,
                 const float* __restrict__ wdwo, const float* __restrict__ obias,
                 float* __restrict__ primal, float* __restrict__ tang, int64_t n, int in_ch,
                 int n_vars, int t_layout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const V4Smem L = v4_smem(in_ch);
  bf16* sets = reinterpret_cast<bf16*>(smem);  // [4 x NB, LDA]: T(p), t_0, t_1, t_2
  bf16* pe_s = reinterpret_cast<bf16*>(smem + L.pe);
  bf16* dpe_s = reinterpret_cast<bf16*>(smem + L.dpe);
  bf16* cd_s = reinterpret_cast<bf16*>(smem + L.cd);
  float* red1 = reinterpret_cast<float*>(smem + L.red1);
  float* red2 = reinterpret_cast<float*>(smem + L.red2);
  float* redc = reinterpret_cast<float*>(smem + L.redc);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3, ldp = L.ldp, ldd = L.ldd;
  const bool tl = t_layout != 0;
  const bf16* w1v = w1 + (size_t)v * in_ch * HID;
  const bf16* w1cv = w1c + (size_t)v * in_ch * HID;  // [3, ch, HID]
  const bf16* w2f1v = w2f1 + (size_t)v * HID * HID;
  const bf16* wdf1v = wdf1 + (size_t)v * in_ch * HID;
  b1 += v * HID; rbias += v * HID; fw2 += v * HID; w2wo += v * HID;

  // the block's rows: the first cp.async group of every thread
  const bf16* dpe = static_cast<const bf16*>(in.dpe);
  tc::rows_async(pe_s, ldp, static_cast<const bf16*>(in.pe), n0, n, NB, in_ch);
  tc::rows_async(cd_s, ldp, static_cast<const bf16*>(in.cd), n0, n, NB, in_ch);
  for (int k = 0; k < 3; ++k)
    tc::rows_async(dpe_s + k * NB * ldd, ldd, dpe + (size_t)k * n * ch, n0, n, NB, ch);
  mma::cp_async_commit();

  // stage 1's weights, per warp and without block barriers: the warp's 32 columns of w1, then
  // of w1c_0..2, in [16, 32] slices through a ring of S1_SLOTS slices of its own (in the block
  // ring's memory, which stage 2 takes once stage 1 is done).  Slice i lands in slot
  // i % S1_SLOTS; each slice taken issues the one S1_SLOTS - 1 ahead, into the slot the warp
  // read before.
  bf16* wring = reinterpret_cast<bf16*>(smem + L.ring) + warp * S1_SLOTS * S1_ROWS * S1_LD;
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

  // ---- stage 1: warp w owns all NB points x columns 32 w .. 32 w + 31 ----
  uint32_t mask[4] = {0u, 0u, 0u, 0u};  // bit 4 nt + i of mask[mt]: z > 0 at acc[mt][nt][i]
  tc::zero_acc(acc);
  for (int j = 0; j < nz; ++j)
    tc::warp_mma<4, 4, 1, 4>(acc, tc::a_lane(pe_s + j * S1_ROWS, ldp, lane), 16 * ldp * sizeof(bf16),
                             slice_next(), 0);
  __syncthreads();  // pe_s lies under the row sets
  uint32_t tie_z[4] = {0u, 0u, 0u, 0u};  // bits as in mask: z near a bf16 rounding tie
  uint64_t tie_u[4] = {0u, 0u, 0u, 0u};  // bit 16 k + 4 nt + i: u_k near one
  {
    float s[4][2] = {};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 32 * warp + 8 * nt + t2;
      const float bias0 = b1[col], bias1 = b1[col + 1], wo0 = w2wo[col], wo1 = w2wo[col + 1];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float z0 = acc[mt][nt][2 * h] + bias0, z1 = acc[mt][nt][2 * h + 1] + bias1;
          mask[mt] |= (z0 > 0.0f ? 1u : 0u) << (4 * nt + 2 * h);
          mask[mt] |= (z1 > 0.0f ? 1u : 0u) << (4 * nt + 2 * h + 1);
          const float p0 = fmaxf(z0, 0.0f), p1 = fmaxf(z1, 0.0f);
          tie_z[mt] |= (near_bf16_tie<TIE_ULPS_Z>(p0) ? 1u : 0u) << (4 * nt + 2 * h);
          tie_z[mt] |= (near_bf16_tie<TIE_ULPS_Z>(p1) ? 1u : 0u) << (4 * nt + 2 * h + 1);
          s[mt][h] = fmaf(p1, wo1, fmaf(p0, wo0, s[mt][h]));
          *reinterpret_cast<uint32_t*>(sets + (16 * mt + g + 8 * h) * LDA + col) = mma::pack_bf16x2(p0, p1);
        }
    }
    tc::store_row_sums(s, red1 + warp * NB, lane);
  }
  tc::cd_sums(cd_s, ldp, in_ch, wdwo + v * in_ch, NB, redc);

  for (int k = 0; k < 3; ++k) {
    tc::zero_acc(acc);
    const bf16* d_s = dpe_s + k * NB * ldd;
    for (int j = 0; j < nu; ++j)
      tc::warp_mma<4, 4, 1>(acc, tc::a_lane(d_s + j * S1_ROWS, ldd, lane), 16 * ldd * sizeof(bf16),
                            slice_next(), 0);
    __syncthreads();  // dpe_k may lie under t_k's rows
    bf16* t_s = sets + (k + 1) * NB * LDA;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = 32 * warp + 8 * nt + t2;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int bit = 4 * nt + 2 * h;
          const float u0 = (mask[mt] >> bit) & 1u ? acc[mt][nt][2 * h] : 0.0f;
          const float u1 = (mask[mt] >> (bit + 1)) & 1u ? acc[mt][nt][2 * h + 1] : 0.0f;
          tie_u[mt] |= (uint64_t)(near_bf16_tie<TIE_ULPS_U>(u0) ? 1u : 0u) << (16 * k + bit);
          tie_u[mt] |= (uint64_t)(near_bf16_tie<TIE_ULPS_U>(u1) ? 1u : 0u) << (16 * k + bit + 1);
          *reinterpret_cast<uint32_t*>(t_s + (16 * mt + g + 8 * h) * LDA + col) = mma::pack_bf16x2(u0, u1);
        }
    }
  }
  // stage 2's weight tiles in the order they are multiplied: per 64-column pass c, w2f1 and
  // wdf1 ([128, 64], wdf1's last one shorter), through the block's ring, whose first tiles
  // are in flight from here on (every warp is past its stage-1 slices: the barrier above)
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
  auto ring = tc::make_ring<NS>(smem + L.ring, (int)L.slot, (HID / S2_COLS) * per_pass, issue);
  ring.start();

  // T(p) and t_k near a rounding tie, recomputed in the plain version's order: red2 holds the
  // list until stage 2 ends, and the ring's last slot is free until its first tile is taken
  fix_ties(tie_z, tie_u, static_cast<const bf16*>(in.pe), dpe, w1v, w1cv, b1, n0, n, in_ch, sets,
           reinterpret_cast<int*>(red2), reinterpret_cast<float*>(smem + L.ring + (NS - 1) * L.slot),
           (int)(L.slot / (sizeof(float) * (in_ch + 1))));
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

  // ---- stage 2: warp w owns points 16 (w & 3) .. + 15 of the four row sets and columns
  // 32 (w >> 2) .. + 31 of each 64-column pass ----
  const int pg = warp & 3, half = warp >> 2;
  constexpr uint32_t S2_K16 = 16 * ld_of(S2_COLS) * sizeof(bf16);
  float s_r[2] = {0.0f, 0.0f}, s_t[3][2] = {};
#pragma unroll 1
  for (int c = 0; c < HID / S2_COLS; ++c) {
    tc::zero_acc(acc);
    for (int j = 0; j < HID / S2_ROWS; ++j) {  // [T(p); t_0; t_1; t_2] . w2f1
      const uint32_t b = tc::b_lane(ring.next() + 32 * half, ld_of(S2_COLS), lane);
      const uint32_t a = tc::a_lane(sets + 16 * pg * LDA + j * S2_ROWS, LDA, lane);
      tc::warp_mma<4, 4, 4, 1>(acc, a, NB * LDA * sizeof(bf16), b, S2_K16);
      tc::warp_mma<4, 4, 4, 1>(acc, a + 64 * sizeof(bf16), NB * LDA * sizeof(bf16), b + 4 * S2_K16, S2_K16);
    }
    for (int j = 0; j < nd; ++j) {  // + cd . wdf1, into r's accumulator
      const uint32_t b = tc::b_lane(ring.next() + 32 * half, ld_of(S2_COLS), lane);
      const uint32_t a = tc::a_lane(cd_s + 16 * pg * ldp + j * S2_ROWS, ldp, lane);
      const int k16 = min(S2_ROWS, in_ch - j * S2_ROWS) / 16;
      for (int q = 0; q < k16; q += 4)
        tc::warp_mma<1, 4, 4, 1>(acc, a + q * 32, 0, b + q * S2_K16, S2_K16);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c * S2_COLS + 32 * half + 8 * nt + t2;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float rb = rbias[col + e], f = fw2[col + e];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float rv = acc[0][nt][2 * h + e] + rb;
          s_r[h] = fmaf(fmaxf(rv, 0.0f), f, s_r[h]);
          if (rv > 0.0f) {
#pragma unroll
            for (int k = 0; k < 3; ++k) s_t[k][h] = fmaf(acc[k + 1][nt][2 * h + e], f, s_t[k][h]);
          }
        }
      }
    }
  }
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
    primal[at] = (red2[row] + red2[4 * NB + row]) + 2.0f * (s_p + redc[row]) + obias[v] + in.ref[at];
    for (int k = 0; k < 3; ++k) {
      float s_tw = 0.0f;
      for (int w = 0; w < WARPS; ++w) s_tw += red1[((k + 1) * WARPS + w) * NB + row];
      tang[tangent_at(tl, k, point, v, n, n_vars)] =
          (red2[(k + 1) * NB + row] + red2[(5 + k) * NB + row]) + 2.0f * s_tw;
    }
  }
}

int launch_tc(const PointInputs& in, const void* w1, const void* w1c, const float* b1,
              const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
              const float* w2wo, const float* wdwo, const float* obias, float* primal, float* tang,
              int64_t n, int in_ch, int n_vars, int t_layout, cudaStream_t stream) {
  if (!v4_smem_valid(in_ch)) return (int)cudaErrorInvalidValue;
  const size_t smem = v4_smem(in_ch).total;
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v4_tc, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_jvp_v4_tc<<<grid, THREADS, smem, stream>>>(
      in, static_cast<const bf16*>(w1), static_cast<const bf16*>(w1c), b1, static_cast<const bf16*>(w2f1),
      static_cast<const bf16*>(wdf1), rbias, fw2, w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars, t_layout);
  return (int)cudaGetLastError();
}

// ---- float, and the v5 / v4pe variants: CUDA cores -----------------------------------

template <typename T, int VARIANT>
__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v4_kernel(PointInputs in, const T* __restrict__ w1, const T* __restrict__ w1c,
                     const float* __restrict__ b1, const T* __restrict__ w2f1,
                     const T* __restrict__ wdf1, const float* __restrict__ rbias,
                     const float* __restrict__ fw2, const float* __restrict__ w2wo,
                     const float* __restrict__ wdwo, const float* __restrict__ obias,
                     float* __restrict__ primal, float* __restrict__ tang, int64_t n, int in_ch,
                     int n_vars, int t_layout) {
  constexpr bool PE = VARIANT == kV4pe;
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

  front_rows<T, PE>(in, pe_s, cd_s, n0, n, NB, in_ch);

  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0
  float o[TM];
  const T* w2f1_v = w2f1 + (size_t)v * HID * HID;
  primal_stages<T, TM, VARIANT == kV5>(
      pe_s, in_ch, in_ch, w1 + (size_t)v * in_ch * HID, cd_s, in_ch, b1 + v * HID, w2f1_v,
      wdf1 + (size_t)v * in_ch * HID, rbias + v * HID, fw2 + v * HID, w2wo + v * HID,
      wdwo + v * in_ch, p_s, Ws, mask, maskr, o);
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t point = n0 + ty * TM + r;
    if (tx == r && point < n) {
      const int64_t at = primal_at(tl, point, v, n, n_vars);
      primal[at] = o[r] + obias[v] + in.ref[at];
    }
  }

  // The block's compact tangent rows [3, NB, ch] over pe_s: every thread's last
  // read of pe_s (stage 1) lies before the barriers of stage 2's products, and
  // the first barrier of the next product publishes these writes.
  T* d_s = pe_s;
  front_tangent_rows<T, PE>(in, d_s, n0, n, NB, in_ch);

  // tangents, one direction at a time
  for (int k = 0; k < 3; ++k) {
    float to[TM];
    const T* w1k = PE ? w1 + ((size_t)v * in_ch + k * ch) * HID     // rows k*ch:(k+1)*ch
                      : w1c + ((size_t)v * 3 + k) * ch * HID;
    tangent_stage<T, TM>(d_s + k * NB * ch, ch, ch, w1k, w2f1_v,
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

template <typename T, int VARIANT>
int launch(const PointInputs& in, const void* w1, const void* w1c, const float* b1, const void* w2f1,
           const void* wdf1, const float* rbias, const float* fw2, const float* w2wo,
           const float* wdwo, const float* obias, float* primal, float* tang, int64_t n, int in_ch,
           int n_vars, int t_layout, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v4_kernel<T, VARIANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_jvp_v4_kernel<T, VARIANT><<<grid, THREADS, smem, stream>>>(
      in, static_cast<const T*>(w1), static_cast<const T*>(w1c), b1, static_cast<const T*>(w2f1),
      static_cast<const T*>(wdf1), rbias, fw2, w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars,
      t_layout);
  return (int)cudaGetLastError();
}

template <int VARIANT>
int dispatch(int is_bf16, const PointInputs& in, const void* w1, const void* w1c, const float* b1,
             const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
             const float* w2wo, const float* wdwo, const float* obias, float* primal, float* tang,
             int64_t n, int in_ch, int n_vars, int t_layout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (VARIANT == kV4) {
    if (is_bf16)
      return launch_tc(in, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, primal, tang, n,
                       in_ch, n_vars, t_layout, s);
  } else if (is_bf16) {
    return launch<__nv_bfloat16, VARIANT>(in, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo,
                                          obias, primal, tang, n, in_ch, n_vars, t_layout, s);
  }
  return launch<float, VARIANT>(in, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, primal,
                                tang, n, in_ch, n_vars, t_layout, s);
}

PointInputs prepared(const void* pe, const void* dpe, const void* cd, const float* ref) {
  return PointInputs{pe, dpe, cd, ref, nullptr, nullptr, nullptr, nullptr, nullptr};
}

}  // namespace

extern "C" {

// Hidden width the kernel was built for; shared memory one block needs at this
// input width, the most of any variant (bf16: the tensor-core body of v4 and the
// CUDA-core body of v5 / v4pe).
int dpn_decode_jvp_v4_hid() { return dpn::HID; }
int dpn_decode_jvp_v4_block() { return NB; }  // points a block takes, every body and variant
int dpn_decode_jvp_v4_shared_bytes(int is_bf16, int in_ch) {
  if (!is_bf16) return (int)shared_bytes<float>(in_ch);
  const size_t tc_bytes = v4_smem_valid(in_ch) ? v4_smem(in_ch).total : (size_t)1 << 30;
  return (int)tc::max_of(tc_bytes, shared_bytes<__nv_bfloat16>(in_ch));
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
  return dispatch<kV4>(is_bf16, prepared(pe, dpe, cd, ref), w1, w1c, b1, w2f1, wdf1, rbias, fw2,
                       w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars, t_layout, stream);
}

// v5: the arguments of dpn_decode_jvp_v4.
int dpn_decode_jvp_v5(int is_bf16, const void* pe, const void* dpe, const void* cd,
                      const float* ref, const void* w1, const void* w1c, const float* b1,
                      const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
                      const float* w2wo, const float* wdwo, const float* obias, float* primal,
                      float* tang, int64_t n, int in_ch, int n_vars, int t_layout, void* stream) {
  return dispatch<kV5>(is_bf16, prepared(pe, dpe, cd, ref), w1, w1c, b1, w2f1, wdf1, rbias, fw2,
                       w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars, t_layout, stream);
}

// v4pe: coords [n, 3] and cdata [n, 6] f32 (cdata is also the reference value),
// scales [3], fb [in_ch / 6], fb2 [in_ch / 12] f32; w1 [n_vars, in_ch, HID], wdf1 and
// wdwo with their rows channel-major; n_vars is 6.
int dpn_decode_jvp_v4pe(int is_bf16, const float* coords, const float* cdata,
                        const float* scales, const float* fb, const float* fb2, const void* w1,
                        const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
                        const float* fw2, const float* w2wo, const float* wdwo,
                        const float* obias, float* primal, float* tang, int64_t n, int in_ch,
                        int n_vars, int t_layout, void* stream) {
  const PointInputs in{nullptr, nullptr, nullptr, cdata, coords, cdata, scales, fb, fb2};
  return dispatch<kV4pe>(is_bf16, in, w1, nullptr, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias,
                         primal, tang, n, in_ch, n_vars, t_layout, stream);
}

}  // extern "C"
