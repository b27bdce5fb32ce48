// Uncollapsed decode, forward: primal and three space-time tangents of the round-1 decode
// (DecodeWeights), [N, 6] / [3, N, 6] outputs, for Hopper (sm_90a).
//
// Replaces two TPU kernels of deepphysinet_tpu/ops/decode_kernel.py:
// * v2, _decode_kernel (called through fused_decode_jvp, :166-290): the interleaved PE,
//   the compact tangent input dpe [3, N, ch] through the channel-sliced rows w1c, the cd PE;
// * v3, _decode_kernel_v3 (fused_decode_jvp_v3, :315-478): the same chain with the
//   channel-major PE computed in the kernel from raw coordinates (decode_pe.cuh); w1 and
//   wd come channel-major, so direction k's tangent rows are rows k*ch:(k+1)*ch of w1.
// Per point n, variable v and direction k (ch = in_ch / 3):
//
//   z    = pe[n] . w1 + b1,  p = relu(z)
//   t_k  = 1[z > 0] * (dpe[k, n] . w1c_k)                         f32
//   c    = T(p) . w2 + b2 + cd[n] . wd + bd + fh                   f32
//   t2_k = T(t_k) . w2                                             f32
//   r    = T(c) . f1 + g1
//   tr_k = 1[r > 0] * (T(t2_k) . f1)                               f32
//   o    = sum((T(relu r) . f2 + g2 + 2 c) * T(wo)) + bo + ref[n, v]
//   to_k = sum((T(tr_k) . f2 + 2 t2_k) * T(wo))
//
// with the TPU kernel's rounding points (:196-233): every product's operands in the
// compute type T, sums in f32, c and the tangents f32 between products, and the head wo
// read in T (the TPU wrapper casts it, :264; its XLA twin reads it in f32: ROADMAP C19).
// c is summed in the TPU kernel's order, (T(p) . w2 + b2) + (cd . wd + bd) + fh (:203-207),
// each product in an accumulator of its own: T(c) rounds c to bf16 before the next product,
// so a last-bit change of c flips a few of those roundings, and near a relu kink of r that
// switches a tangent term (chip_smoke.py on an H100: one accumulator for both products left
// 4e-3 to 2e-2 of the largest tangent between the kernel and its plain version in bf16).
// The order of the head's sums is this kernel's own: the g2 + 2 c and 2 t2_k terms are
// summed against wo when c and t2_k are formed, so that neither has to be kept.
//
// What bounds it: 933,888 multiply-adds per point and variable (layer 1 49,152; tangents
// 3 x 16,384; w2, f1 and f2 on the primal and three tangent rows, 12 x 65,536; wd 49,152),
// 11.21 MFLOP a point, against about 1,300 bytes of point I/O: compute bound, 2.28 times
// the collapsed v4 decode.  A block owns NB = 64 points and ONE variable (grid = blocks x
// variables), so blocks are independent; the ragged last block is masked (zero rows in, no
// stores out).
//
// bf16, v2 and v3 (decode_jvp_v2_tc<false> and <true>, the flagship's type): every product on the
// tensor cores (mma.sync m16n8k16 through decode_mma.cuh), eight warps.
// * Layer 1 with z's mask, T(p) and t_k is the v4 forward's stage 1 (decode_jvp_tc.cuh, with
//   jvp::RowSource{pe, dm = dpe}), and fix_ties (the per-warp form, before the layers' ring starts:
//   it takes the ring's memory) recomputes in the plain version's order every T(p) and t_k near a
//   bf16 rounding tie, so the four row sets [T(p); T(t_0..2)] have the v4 forward kernel's bits.
// * v3's layer-1 rows come from decode_pe.cuh's PeSource: the front end writes the block's
//   channel-major pe, tangent and cd rows at the body's strides from one sincosf an angle, and
//   fix_ties computes a flagged value's row again from the point's coordinates, with the same
//   bits; w1 and wd come channel-major (the wrapper's permutation), the tangent rows of direction
//   k are rows k*ch:(k+1)*ch of w1, and cols holds the columns of w2 and of the channel-major wd.
// * Layers 2 to 4 (w2 with cd . wd, f1, f2) each serve the four row sets from one pass over their
//   weight, but a point group at a time: warp w owns the group's 16 points of all four row sets
//   and output columns 32 w .. 32 w + 31 (each weight fragment feeds four products, each row
//   fragment four), so when the group is done its rows are dead and the epilogue writes the next
//   layer's bf16 row sets over them in place.  (Column passes over all 64 points, as the v4
//   stage 2 runs, would need the layer's input rows until the last pass and a second 135 KB of
//   row sets for its output; the block has 227 KB.)  The price is the weights: each layer streams
//   its [32, 256] tiles through the block ring of three once per point group, 1.9 MB of L2 reads
//   a block and variable, against 128 KB of weight a layer.
// * The head needs no row set: layer 2's epilogue sums (g2 + 2 c) T(wo) and 2 t2_k T(wo) as c
//   and t2_k are formed, layer 4's (T(relu r) . f2) T(wo) and (T(tr_k) . f2) T(wo); per-point
//   partial sums by warp go through shared memory ([4][8][64] f32) and are added in a fixed
//   order, so a launch's bits do not depend on timing.
// * Rounding.  The products are exact and summed in f32 in another order than the plain version's
//   (cuBLAS: one FMA a term, in k order), so a sum that lies near a bf16 rounding tie can round one
//   step the other way.  In this chain that is not a last-bit matter at T(p) and T(c): r's relu mask
//   comes from the chain z -> T(p) -> c -> T(c) -> r, and a flip there, even of a small value, moves
//   a later sum past a tie of a large one (a T(p) flip moves c, a flipped T(c) moves r by 2^-8 of c
//   times f1) and so switches r's mask far from any kink.  chip_smoke.py's [rounding] v2 line shows
//   it: float64 sums in place of cuBLAS's at T(p) or at T(c) alone move 4 to 6 and 1 to 3 points of
//   a 20,480-point launch past the bounds (flagship weights), at the other
//   four rounding points none: T(relu r) feeds only the primal, and r's own sum switches its mask
//   only within the kink set.  So z and c near a tie are summed again in cuBLAS's order: z by
//   fix_ties (stage 1), c by fix_group_ties after each point group's products, from the group's rows
//   and the weights' columns, which the wrapper passes as one transposed copy (cols: w2 and wd by
//   column).  "Near" is TIE_ULPS ulps of the value, or within TIE_FLOOR times the largest |value|
//   of the warp's 32 columns of the row: an absolute window, since a small value's sum carries the
//   error of its large terms (a window in ulps alone left hundreds of flips of small T(p) and T(c) a
//   launch).  The tangents' roundings (T(t_k), T(t2_k), T(tr_k)) switch nothing; their flips move a
//   tangent by a share of one term.  c and r's k16 products are added with f32 adds (warp_mma's RN
//   row tile), the tangents' inside the tensor cores.
// * Shared memory at flagship width (in_ch 192): the row sets (135,168 bytes; the block's pe and
//   dpe rows under their tail for layer 1), cd (25,600), the ring (55,296; stage 1's eight warp
//   rings lie in it), the head's partial sums (8,192), the list of values of c near a tie and
//   their sums (2 x 2,048): 228,352 bytes.
//
// float, v2 and v3 (decode_jvp_v2_kernel, the parity configuration; no TF32): the products on the
// CUDA cores (FMA), weights through shared memory in KT-row tiles (decode_common.cuh's block_gemm),
// the relu masks as bits of the thread's register tile.  The uncollapsed chain needs four row sets
// of [NB, HID] (p, c, relu r and one tangent's), 256 KB in f32, over a block's 227 KB; every one of
// them is the operand of exactly one product, so a single [NB, HID] buffer holds whichever is next
// (192 KB).  v3's rows come from the PE front end of decode_pe.cuh (front_rows).

#include "decode_common.cuh"
#include "decode_jvp_tc.cuh"
#include "decode_pe.cuh"

namespace {

using namespace dpn;

constexpr int TM = 8;            // accumulator rows per thread
constexpr int NB = WARPS * TM;   // points per block

// The decode weights of all variables, as the wrapper lays them out: the matrices and wo in
// T (w1 [V, in_ch, HID], w1c [V, 3, ch, HID] or null, w2 / f1 / f2 [V, HID, HID],
// wd [V, in_ch, HID], wo [V, HID]), the biases f32 ([V, HID]; bo [V]); for the bf16 body also
// cols, c's weights by column: [V, HID, cols_ld(in_ch)] bf16, row c of variable v the c-th
// columns of w2 and wd one after the other (the float body does not read it).
struct V2Weights {
  const void* w1;
  const void* w1c;
  const float* b1;
  const void* w2;
  const float* b2;
  const void* wd;
  const float* bd;
  const float* fh;
  const void* f1;
  const float* g1;
  const void* f2;
  const float* g2;
  const void* wo;
  const float* bo;
  const void* cols;
};

// The row length of V2Weights::cols: a column of w2, then one of wd.
__host__ __device__ constexpr int cols_ld(int in_ch) { return HID + in_ch; }

template <typename T> __device__ __forceinline__ const T* mat(const void* w, size_t offset) {
  return static_cast<const T*>(w) + offset;
}

// ---- bf16, v2 (PE = false) and v3 (PE = true): tensor cores ----------------------------------
//
// One block: NB = 64 points and ONE variable, eight warps (see the header).  Layer 1 is the v4
// forward's stage 1 (decode_jvp_tc.cuh, with fix_ties); the three hidden layers run per point
// group through one ring of [L_ROWS, HID] weight tiles.  PE picks the layer-1 rows' source.

using jvp::bf16;
using jvp::LDA;

constexpr int L_ROWS = 32;  // weight rows of a layer tile [32, 256]: two k16 steps
constexpr uint32_t L_K16 = 16 * LDA * sizeof(bf16);
constexpr uint32_t SET_BYTES = jvp::NB * LDA * sizeof(bf16);  // between two row sets

static_assert(L_ROWS * LDA * (int)sizeof(bf16) <= jvp::SLOT_BYTES, "a layer tile fits a ring slot");
static_assert(jvp::NB == 16 * 4 && HID == 32 * WARPS, "four point groups of 16; a warp owns 32 columns");

// Byte offsets of the v2 body's shared memory at input width in_ch: the row region (four row
// sets [4 x NB, LDA]; the block's pe and dpe rows under its tail for layer 1), cd, the ring, the
// per-point partial sums of the head ([4][WARPS][NB]: o, then to_0..2, by warp), the list of
// values near a tie (fix_ties, then fix_group_ties) and the values fix_group_ties sums again.
struct V2Smem {
  jvp::RowRegion rows;
  size_t cd, ring, red, list, vals, total;
};

__host__ __device__ inline V2Smem v2_smem(int in_ch) {
  V2Smem s;
  s.rows = jvp::row_region(in_ch, true);
  s.cd = s.rows.rows;
  s.ring = s.cd + (size_t)jvp::NB * s.rows.ldp * sizeof(bf16);
  s.red = s.ring + (size_t)jvp::NS * jvp::SLOT_BYTES;
  s.list = s.red + (size_t)4 * WARPS * jvp::NB * sizeof(float);
  s.vals = s.list + (size_t)(jvp::TIE_CAP + 1) * sizeof(int);
  s.total = s.vals + (size_t)(jvp::TIE_CAP + 1) * sizeof(float);
  return s;
}

// The widths the body takes: the row region's layout, 64-lane tangent blocks, cd . wd's sum no
// longer than T(p) . w2's (fix_group_ties runs them side by side), the budget of shared memory and,
// for v3, the PE source's width.
template <bool PE> __host__ __device__ inline bool v2_tc_valid(int in_ch) {
  return jvp::row_region_valid(in_ch, true) && in_ch % 192 == 0 && in_ch <= HID && v2_smem(in_ch).total <= 232448 &&
         (!PE || PeSource::valid(in_ch));
}

// The owner lane (t = 0) of each of the warp's rows 16 pg + g + 8 h adds the quad's sum of
// s[h] into red[row]: one thread a (quantity, warp, row), so no two threads add to one place.
__device__ __forceinline__ void add_row_sums(const float (&s)[2], float* red, int pg, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = mma::quad_sum(s[h]);
    if ((lane & 3) == 0) red[16 * pg + (lane >> 2) + 8 * h] += v;
  }
}

// The values of z and c near a bf16 rounding tie (see the header) are summed again in cuBLAS's
// order: those whose f32 bits lie within TIE_ULPS ulps of a tie, or within TIE_FLOOR times the
// largest |value| of the warp's 32 columns of the row.  On an H100, on the flagship weights at
// 20,480 points, an emulation of the tensor cores' sums puts z and c within 23 and 17 x 2^-24 of
// that value from cuBLAS's, and this window misses no flip of T(p) or T(c) from a floor of 8 on;
// at 20 it flags 53 and 108 values a block and variable
// (python -m deepphysinet_tpu_torch.diagnostics.tie_window).
constexpr int TIE_ULPS = 32;
constexpr float TIE_FLOOR = 20.0f * 0x1p-24f;

// The values c of point group pg near a bf16 rounding tie (bit 4 nt + 2 h + e of each lane's ties
// flags its element [nt][h][e] of the group's warp tile), summed again in the plain version's
// order: c = ((T(p) . w2 + b2) + (cd . wd + bd)) + fh.  The block lists them (list[TIE_CAP] must
// be 0 on entry) and, in rounds, copies their weights' columns from cols (the variable's
// V2Weights::cols, where a column is contiguous: a column of the row-major weight takes one 32-byte
// sector a value) into the group's rows of the tangent row sets, dead from the layer's last product
// to its epilogue, an odd number of words apart (K + 2 values), so that the threads' reads of one k
// fall in distinct banks; then one thread a value adds the products of its row of row set 0 and of
// cd, which are only read, by its column (exact in f32 for two bf16 values) in k order, one fused
// add a term from zero, as cuBLAS's f32 product sums them, the two sums side by side.  Value i goes
// to vals[i] for list entry i = row << 8 | column; returns how many are listed.  At most TIE_CAP
// values of a group are listed, an eighth of its 4,096: the window flags about 27 on the flagship
// weights, and a value beyond the cap would keep the tensor cores' rounding, as outside the window.
// Called by the whole block; ends with a barrier.
__device__ __forceinline__ int fix_group_ties(uint32_t ties, int pg, int v, bf16* sets, const bf16* cd_s, int ldp,
                                              int in_ch, const bf16* __restrict__ cols, const float* __restrict__ b2,
                                              const float* __restrict__ bd, const float* __restrict__ fh, int* list,
                                              float* vals) {
  constexpr int REGION = 16 * LDA;  // bf16 values in a group's rows of a row set
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (uint32_t f = ties; f != 0u; f &= f - 1u) {
    const int b = __ffs(f) - 1, at = atomicAdd(&list[jvp::TIE_CAP], 1);
    if (at < jvp::TIE_CAP)
      list[at] = (16 * pg + (lane >> 2) + 8 * ((b >> 1) & 1)) << 8 | (32 * warp + 8 * (b >> 2) + 2 * (lane & 3) + (b & 1));
  }
  __syncthreads();
  const int count = min(list[jvp::TIE_CAP], jvp::TIE_CAP);
  const int K = HID + in_ch, ldc = K + 2, per_region = REGION / ldc;  // the weights a value reads: w2's, wd's
  const auto column = [&](int e) { return sets + ((1 + e / per_region) * jvp::NB + 16 * pg) * LDA + (e % per_region) * ldc; };
  for (int base = 0; base < count; base += 3 * per_region) {
    const int m = min(3 * per_region, count - base), vec = K / 8;
#pragma unroll 4
    for (int i = tid; i < m * vec; i += THREADS) {
      const int e = i / vec, j = i - e * vec;
      const uint4 x = *reinterpret_cast<const uint4*>(cols + (size_t)(list[base + e] & 0xff) * cols_ld(in_ch) + 8 * j);
      uint32_t* to = reinterpret_cast<uint32_t*>(column(e) + 8 * j);  // 4-byte aligned: ldc is even
      to[0] = x.x, to[1] = x.y, to[2] = x.z, to[3] = x.w;
    }
    __syncthreads();
    if (tid < m) {
      const int row = list[base + tid] >> 8, col = list[base + tid] & 0xff;
      const bf16 *a = sets + row * LDA, *d = cd_s + row * ldp, *w = column(tid);
      float s = 0.0f, t = 0.0f;
#pragma unroll 8
      for (int k = 0; k < HID; ++k) {
        s = fmaf(to_f32(a[k]), to_f32(w[k]), s);
        if (k < in_ch) t = fmaf(to_f32(d[k]), to_f32(w[HID + k]), t);
      }
      const int at = v * HID + col;
      vals[base + tid] = ((s + b2[at]) + (t + bd[at])) + fh[at];
    }
    __syncthreads();  // the columns' rows may be written again
  }
  return count;
}

template <bool PE>
__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v2_tc(PointInputs in, V2Weights w, float* __restrict__ primal, float* __restrict__ tang, int64_t n,
                 int in_ch, int n_vars) {
  extern __shared__ __align__(16) unsigned char smem[];
  const V2Smem L = v2_smem(in_ch);
  bf16* sets = reinterpret_cast<bf16*>(smem);  // [4 x NB, LDA]: the four row sets of the next layer
  bf16* pe_s = reinterpret_cast<bf16*>(smem + L.rows.pe);
  bf16* dpe_s = reinterpret_cast<bf16*>(smem + L.rows.dpe);
  bf16* cd_s = reinterpret_cast<bf16*>(smem + L.cd);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* list = reinterpret_cast<int*>(smem + L.list);
  float* vals = reinterpret_cast<float*>(smem + L.vals);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * jvp::NB;
  const int ch = in_ch / 3, ldp = L.rows.ldp, ldd = L.rows.ldd;
  const auto src = [&] {
    if constexpr (PE) return PeSource{in.coords, in.cdata, in.scales, in.fb, in.fb2, n, in_ch};
    else return jvp::RowSource{static_cast<const bf16*>(in.pe), static_cast<const bf16*>(in.dpe), n, in_ch};
  }();
  const bf16* w1v = mat<bf16>(w.w1, (size_t)v * in_ch * HID);
  // v3: direction k's tangent rows are rows k ch .. (k + 1) ch - 1 of the channel-major w1
  const bf16* w1cv = PE ? w1v : mat<bf16>(w.w1c, (size_t)v * in_ch * HID);
  const bf16* w2v = mat<bf16>(w.w2, (size_t)v * HID * HID);
  const bf16* wdv = mat<bf16>(w.wd, (size_t)v * in_ch * HID);
  const bf16* f1v = mat<bf16>(w.f1, (size_t)v * HID * HID);
  const bf16* f2v = mat<bf16>(w.f2, (size_t)v * HID * HID);
  const bf16* wo = mat<bf16>(w.wo, (size_t)v * HID);
  const bf16* cols = mat<bf16>(w.cols, (size_t)v * HID * cols_ld(in_ch));
  const float* b1 = w.b1 + v * HID;

  // the block's rows: the first cp.async group of every thread (v3: computed, an empty group, and
  // stage 1's first barrier publishes the rows)
  if constexpr (PE) {
    src.front(pe_s, ldp, dpe_s, ldd, cd_s, n0, jvp::NB);
  } else {
    jvp::primal_rows_async(src, pe_s, ldp, n0);
    tc::rows_async(cd_s, ldp, static_cast<const bf16*>(in.cd), n0, n, jvp::NB, in_ch);
    for (int k = 0; k < 3; ++k)
      tc::rows_async(dpe_s + k * jvp::NB * ldd, ldd, src.dm + (size_t)k * n * ch, n0, n, jvp::NB, ch);
  }
  mma::cp_async_commit();
  for (int i = tid; i < 4 * WARPS * jvp::NB; i += THREADS) red[i] = 0.0f;

  // ---- layer 1: T(relu z) and T(t_k) = T(1[z > 0] dpe_k . w1c_k) into the four row sets ----
  {
    uint32_t mask[4], tie_z[4];
    uint64_t tie_u[4];
    const auto none = [](auto...) {};
    jvp::stage1<true>(pe_s, ldp, dpe_s, ldd, jvp::NB * ldd, w1v, w1cv, b1, in_ch, smem + L.ring, sets, mask, tie_z,
                      tie_u, none, none, TIE_FLOOR);

    // the hidden layers' tiles, in the order they are multiplied: per point group, w2 then wd
    // (layer 2), then f1 (layer 3), then f2 (layer 4); in flight from here on (every warp is past
    // its stage-1 slices)
    const int nd = in_ch / L_ROWS, per_pg = HID / L_ROWS + nd, l2_tiles = 4 * per_pg;
    auto ring = tc::make_ring<jvp::NS>(smem + L.ring, jvp::SLOT_BYTES, l2_tiles + 8 * HID / L_ROWS,
                                       [=](int i, unsigned char* slot) {
      const bf16* from;
      if (i < l2_tiles) {
        const int j = i % per_pg;
        from = j < HID / L_ROWS ? w2v + (size_t)j * L_ROWS * HID : wdv + (size_t)(j - HID / L_ROWS) * L_ROWS * HID;
      } else {
        const int j = i - l2_tiles, layer = j / (4 * HID / L_ROWS);
        from = (layer == 0 ? f1v : f2v) + (size_t)(j % (HID / L_ROWS)) * L_ROWS * HID;
      }
      tc::tile_async<HID>(reinterpret_cast<bf16*>(slot), LDA, from, HID, L_ROWS);
    });
    // T(p) and T(t_k) near a rounding tie, recomputed in the plain version's order; fix_ties takes
    // the ring's memory, so the ring starts after it
    jvp::fix_ties(tie_z, tie_u, src, w1v, w1cv, b1, n0, sets, list, smem + L.ring);
    ring.start();
    if (tid == 0) list[jvp::TIE_CAP] = 0;  // fix_group_ties counts from zero (published by the ring's barrier)

    // ---- layers 2 to 4, one point group of 16 points at a time: warp w owns the group's rows of
    // the four row sets (acc[s]) and columns 32 w .. 32 w + 31, acc[s][nt][i] at row
    // 16 pg + g + 8 (i >> 1) and column 32 w + 8 nt + 2 t + (i & 1) ----
#pragma unroll
    for (int layer = 2; layer <= 4; ++layer) {
#pragma unroll 1
      for (int pg = 0; pg < 4; ++pg) {
        float acc[4][4][4], acc_cd[1][4][4];
        tc::zero_acc(acc);
        tc::zero_acc(acc_cd);
        const uint32_t a = tc::a_lane(sets + 16 * pg * LDA, LDA, lane);
        for (int j = 0; j < HID / L_ROWS; ++j) {
          const uint32_t b = tc::b_lane(ring.next() + 32 * warp, LDA, lane);
          // the primal's sum (c, r) feeds a bf16 rounding and a relu mask: its k16 products are
          // added with f32 adds; the tangents' accumulate inside the tensor cores
          tc::warp_mma<4, 4, 2, 1>(acc, a + j * L_ROWS * sizeof(bf16), SET_BYTES, b, L_K16);
        }
        if (layer == 2) {  // cd . wd, in an accumulator of its own
          const uint32_t a_cd = tc::a_lane(cd_s + 16 * pg * ldp, ldp, lane);
          for (int j = 0; j < nd; ++j) {
            const uint32_t b = tc::b_lane(ring.next() + 32 * warp, LDA, lane);
            tc::warp_mma<1, 4, 2, 1>(acc_cd, a_cd + j * L_ROWS * sizeof(bf16), 0, b, L_K16);
          }
        }
        // layer 2: c at the lane's elements [nt][h][e] before its rounding; those near a bf16
        // rounding tie are summed again in the plain version's order
        float cv[4][2][2];
        int fixed = 0;  // how many (the same in every thread)
        if (layer == 2) {
          uint32_t ties = 0u;
          float tie_floor[2] = {0.0f, 0.0f};  // TIE_FLOOR times the row's largest |c| of the warp's columns
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int at = v * HID + 32 * warp + 8 * nt + t2 + e;
                // c = (T(p) . w2 + b2) + (cd . wd + bd) + fh, summed as the plain version sums it
                cv[nt][h][e] = ((acc[0][nt][2 * h + e] + w.b2[at]) + (acc_cd[0][nt][2 * h + e] + w.bd[at])) + w.fh[at];
                tie_floor[h] = fmaxf(tie_floor[h], fabsf(cv[nt][h][e]));
              }
#pragma unroll
          for (int h = 0; h < 2; ++h) tie_floor[h] = TIE_FLOOR * mma::quad_max(tie_floor[h]);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                ties |= (jvp::near_bf16_tie<TIE_ULPS>(cv[nt][h][e], tie_floor[h]) ? 1u : 0u) << (4 * nt + 2 * h + e);
          // the barrier: every warp is done reading the group's rows for the layer's products
          if (__syncthreads_or(ties != 0u))
            fixed = fix_group_ties(ties, pg, v, sets, cd_s, ldp, in_ch, cols, w.b2, w.bd, w.fh, list, vals);
        } else if (layer == 3) {
          __syncthreads();  // every warp is done reading the group's rows
        }
        float s[4][2] = {};  // the head's partial sums of the lane's rows: o, to_0..2
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = 32 * warp + 8 * nt + t2, at = v * HID + col;
          const float wo0 = to_f32(wo[col]), wo1 = to_f32(wo[col + 1]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * pg + g + 8 * h;
            if (layer == 2) {
              // the head takes (g2 + 2 c) wo and 2 t2_k wo, and the layer's outputs go to the row sets
              const float c0 = cv[nt][h][0], c1 = cv[nt][h][1];
              s[0][h] = fmaf(w.g2[at + 1] + 2.0f * c1, wo1, fmaf(w.g2[at] + 2.0f * c0, wo0, s[0][h]));
              *reinterpret_cast<uint32_t*>(sets + row * LDA + col) = mma::pack_bf16x2(c0, c1);
#pragma unroll
              for (int k = 0; k < 3; ++k) {
                const float t0 = acc[k + 1][nt][2 * h], t1 = acc[k + 1][nt][2 * h + 1];
                s[k + 1][h] = fmaf(2.0f * t1, wo1, fmaf(2.0f * t0, wo0, s[k + 1][h]));
                *reinterpret_cast<uint32_t*>(sets + ((k + 1) * jvp::NB + row) * LDA + col) = mma::pack_bf16x2(t0, t1);
              }
            } else if (layer == 3) {
              // r = T(c) . f1 + g1: T(relu r) and T(1[r > 0] (T(t2_k) . f1)) to the row sets
              const float r0 = acc[0][nt][2 * h] + w.g1[at], r1 = acc[0][nt][2 * h + 1] + w.g1[at + 1];
              *reinterpret_cast<uint32_t*>(sets + row * LDA + col) = mma::pack_bf16x2(fmaxf(r0, 0.0f), fmaxf(r1, 0.0f));
#pragma unroll
              for (int k = 0; k < 3; ++k)
                *reinterpret_cast<uint32_t*>(sets + ((k + 1) * jvp::NB + row) * LDA + col) = mma::pack_bf16x2(
                    r0 > 0.0f ? acc[k + 1][nt][2 * h] : 0.0f, r1 > 0.0f ? acc[k + 1][nt][2 * h + 1] : 0.0f);
            } else {
              // the head takes (T(relu r) . f2) wo and (T(tr_k) . f2) wo
#pragma unroll
              for (int q = 0; q < 4; ++q)
                s[q][h] = fmaf(acc[q][nt][2 * h + 1], wo1, fmaf(acc[q][nt][2 * h], wo0, s[q][h]));
            }
          }
        }
        if (fixed > 0) {  // the values summed again, over the epilogue's
          __syncthreads();
          for (int i = tid; i < fixed; i += THREADS)
            sets[(list[i] >> 8) * LDA + (list[i] & 0xff)] = __float2bfloat16_rn(vals[i]);
          if (tid == 0) list[jvp::TIE_CAP] = 0;  // no thread reads the count again before the next barrier
        }
        if (layer != 3)
#pragma unroll
          for (int q = 0; q < 4; ++q) add_row_sums(s[q], red + (q * WARPS + warp) * jvp::NB, pg, lane);
      }
    }
  }
  __syncthreads();

  // ---- the block's outputs: one thread a point, the warps' partial sums in a fixed order ----
  const int row = tid;
  const int64_t point = n0 + row;
  if (row < jvp::NB && point < n) {
    float s[4] = {};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      for (int ww = 0; ww < WARPS; ++ww) s[q] += red[(q * WARPS + ww) * jvp::NB + row];
    primal[point * n_vars + v] = s[0] + w.bo[v] + in.ref[point * n_vars + v];
    for (int k = 0; k < 3; ++k) tang[((int64_t)k * n + point) * n_vars + v] = s[k + 1];
  }
}

template <bool PE>
int launch_tc(const PointInputs& in, const V2Weights& w, float* primal, float* tang, int64_t n, int in_ch,
              int n_vars, cudaStream_t stream) {
  if (!v2_tc_valid<PE>(in_ch)) return (int)cudaErrorInvalidValue;
  const size_t smem = v2_smem(in_ch).total;
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v2_tc<PE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + jvp::NB - 1) / jvp::NB), (unsigned)n_vars);
  decode_jvp_v2_tc<PE><<<grid, THREADS, smem, stream>>>(in, w, primal, tang, n, in_ch, n_vars);
  return (int)cudaGetLastError();
}

// ---- float: CUDA cores -----------------------------------------------------------------------

// The block's row of thread (ty, r), column col of the [NB, HID] operand buffer.
__device__ __forceinline__ int at(int ty, int r, int col) { return (ty * TM + r) * HID + col; }

// The primal chain of variable v: the relu masks, and o per point (before bo and ref) in
// every lane of the point's warp.  x_s [NB, HID] of T is the next product's operand.
template <typename T>
__device__ __forceinline__ void primal_chain(const V2Weights& w, int v, const T* pe_s,
                                             const T* cd_s, int in_ch, T* x_s, T* Ws,
                                             uint32_t (&mask)[TM], uint32_t (&maskr)[TM],
                                             float (&o)[TM]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* wo = mat<T>(w.wo, (size_t)v * HID);
  float acc[TM][TN], s[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) { mask[r] = maskr[r] = 0u; s[r] = 0.0f; }

  // z = pe . w1 + b1;  x = T(relu z)
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(pe_s, in_ch, mat<T>(w.w1, (size_t)v * in_ch * HID), in_ch, Ws, acc);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float b = w.b1[v * HID + col];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float z = acc[r][c] + b;
      if (z > 0.0f) mask[r] |= 1u << c;
      x_s[at(ty, r, col)] = from_f32<T>(fmaxf(z, 0.0f));
    }
  }

  // c = (T(p) . w2 + b2) + (cd . wd + bd) + fh;  s = sum((g2 + 2 c) * wo);  x = T(c).
  // The first barrier of the cd product lies after every thread's last read of x_s.
  float acc_cd[TM][TN];
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(x_s, HID, mat<T>(w.w2, (size_t)v * HID * HID), HID, Ws, acc);
  zero_tile<TM>(acc_cd);
  block_gemm<T, T, TM>(cd_s, in_ch, mat<T>(w.wd, (size_t)v * in_ch * HID), in_ch, Ws, acc_cd);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c, i = v * HID + col;
    const float b2 = w.b2[i], bd = w.bd[i], fh = w.fh[i], g = w.g2[i], wov = to_f32(wo[col]);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float cv = ((acc[r][c] + b2) + (acc_cd[r][c] + bd)) + fh;
      s[r] = fmaf(g + 2.0f * cv, wov, s[r]);
      x_s[at(ty, r, col)] = from_f32<T>(cv);
    }
  }

  // r = T(c) . f1 + g1;  x = T(relu r)
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(x_s, HID, mat<T>(w.f1, (size_t)v * HID * HID), HID, Ws, acc);
  __syncthreads();  // every thread's reads of x_s are done
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float g = w.g1[v * HID + col];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const float rv = acc[r][c] + g;
      if (rv > 0.0f) maskr[r] |= 1u << c;
      x_s[at(ty, r, col)] = from_f32<T>(fmaxf(rv, 0.0f));
    }
  }

  // y - g2 - 2 c = T(relu r) . f2;  s += sum((y - g2 - 2 c) * wo)
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(x_s, HID, mat<T>(w.f2, (size_t)v * HID * HID), HID, Ws, acc);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const float wov = to_f32(wo[tx + 32 * c]);
#pragma unroll
    for (int r = 0; r < TM; ++r) s[r] = fmaf(acc[r][c], wov, s[r]);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) o[r] = warp_sum(s[r]);
}

// One direction's tangent of variable v: tin_s [NB, ch] is its operand, w1k [ch, HID] its
// layer-1 rows; to per point in every lane of the point's warp.  The first barrier of the
// layer-1 product lies after every thread's last read of x_s by the previous stage.
template <typename T>
__device__ __forceinline__ void tangent_chain(const V2Weights& w, int v, const T* tin_s, int ch,
                                              const T* w1k, T* x_s, T* Ws,
                                              const uint32_t (&mask)[TM],
                                              const uint32_t (&maskr)[TM], float (&to)[TM]) {
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const T* wo = mat<T>(w.wo, (size_t)v * HID);
  float acc[TM][TN], s[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) s[r] = 0.0f;

  // x = T(1[z > 0] * (tin . w1k))
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(tin_s, ch, w1k, ch, Ws, acc);
#pragma unroll
  for (int c = 0; c < TN; ++c)
#pragma unroll
    for (int r = 0; r < TM; ++r)
      x_s[at(ty, r, tx + 32 * c)] = from_f32<T>((mask[r] >> c) & 1u ? acc[r][c] : 0.0f);

  // t2 = x . w2;  s = sum(2 t2 * wo);  x = T(t2)
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(x_s, HID, mat<T>(w.w2, (size_t)v * HID * HID), HID, Ws, acc);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const int col = tx + 32 * c;
    const float wov = to_f32(wo[col]);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      s[r] = fmaf(2.0f * acc[r][c], wov, s[r]);
      x_s[at(ty, r, col)] = from_f32<T>(acc[r][c]);
    }
  }

  // x = T(1[r > 0] * (x . f1))
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(x_s, HID, mat<T>(w.f1, (size_t)v * HID * HID), HID, Ws, acc);
  __syncthreads();
#pragma unroll
  for (int c = 0; c < TN; ++c)
#pragma unroll
    for (int r = 0; r < TM; ++r)
      x_s[at(ty, r, tx + 32 * c)] = from_f32<T>((maskr[r] >> c) & 1u ? acc[r][c] : 0.0f);

  // s += sum((x . f2) * wo)
  zero_tile<TM>(acc);
  block_gemm<T, T, TM>(x_s, HID, mat<T>(w.f2, (size_t)v * HID * HID), HID, Ws, acc);
#pragma unroll
  for (int c = 0; c < TN; ++c) {
    const float wov = to_f32(wo[tx + 32 * c]);
#pragma unroll
    for (int r = 0; r < TM; ++r) s[r] = fmaf(acc[r][c], wov, s[r]);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) to[r] = warp_sum(s[r]);
}

template <typename T, bool PE>
__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v2_kernel(PointInputs in, V2Weights w, float* __restrict__ primal,
                     float* __restrict__ tang, int64_t n, int in_ch, int n_vars) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* x_s = reinterpret_cast<T*>(smem);  // [NB, HID] the next product's operand
  T* Ws = x_s + NB * HID;               // [KT, HID]
  T* pe_s = Ws + KT * HID;              // [NB, in_ch]; then the tangent rows [3, NB, ch]
  T* cd_s = pe_s + NB * in_ch;          // [NB, in_ch]

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int v = blockIdx.y;
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const int ch = in_ch / 3;

  front_rows<T, PE>(in, pe_s, cd_s, n0, n, NB, in_ch);

  uint32_t mask[TM], maskr[TM];  // bit c of row r: z > 0, r > 0
  float o[TM];
  primal_chain<T>(w, v, pe_s, cd_s, in_ch, x_s, Ws, mask, maskr, o);
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int64_t point = n0 + ty * TM + r;
    if (tx == r && point < n)
      primal[point * n_vars + v] = o[r] + w.bo[v] + in.ref[point * n_vars + v];
  }

  // The tangent rows over pe_s: every thread's last read of pe_s (layer 1) lies before the
  // barriers of the later products, and the first barrier of the next product publishes them.
  T* d_s = pe_s;
  front_tangent_rows<T, PE>(in, d_s, n0, n, NB, in_ch);
  for (int k = 0; k < 3; ++k) {
    const T* w1k = PE ? mat<T>(w.w1, ((size_t)v * in_ch + k * ch) * HID)  // rows k*ch:(k+1)*ch
                      : mat<T>(w.w1c, ((size_t)v * 3 + k) * ch * HID);
    float to[TM];
    tangent_chain<T>(w, v, d_s + k * NB * ch, ch, w1k, x_s, Ws, mask, maskr, to);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int64_t point = n0 + ty * TM + r;
      if (tx == r && point < n) tang[((int64_t)k * n + point) * n_vars + v] = to[r];
    }
  }
}

template <typename T> size_t shared_bytes(int in_ch) {
  return ((size_t)NB * HID + (size_t)KT * HID + 2 * (size_t)NB * in_ch) * sizeof(T);
}

template <typename T, bool PE>
int launch(const PointInputs& in, const V2Weights& w, float* primal, float* tang, int64_t n,
           int in_ch, int n_vars, cudaStream_t stream) {
  const size_t smem = shared_bytes<T>(in_ch);
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v2_kernel<T, PE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_jvp_v2_kernel<T, PE><<<grid, THREADS, smem, stream>>>(in, w, primal, tang, n, in_ch,
                                                               n_vars);
  return (int)cudaGetLastError();
}

template <bool PE>
int dispatch(int is_bf16, const PointInputs& in, const V2Weights& w, float* primal, float* tang,
             int64_t n, int in_ch, int n_vars, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_tc<PE>(in, w, primal, tang, n, in_ch, n_vars, s);
  return launch<float, PE>(in, w, primal, tang, n, in_ch, n_vars, s);
}

}  // namespace

extern "C" {

// Hidden width the kernels were built for; shared memory one block needs at this input width (bf16:
// the tensor-core body of v2 and v3; v3 takes in_ch 192 only).
int dpn_decode_jvp_v2_hid() { return dpn::HID; }
int dpn_decode_jvp_v2_shared_bytes(int is_bf16, int in_ch) {
  if (!is_bf16) return (int)shared_bytes<float>(in_ch);
  return v2_tc_valid<false>(in_ch) ? (int)v2_smem(in_ch).total : 1 << 30;
}
// Points a block takes, every body.
int dpn_decode_jvp_v2_block() { return NB; }

// v2.  is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  pe and cd [n, in_ch], dpe
// [3, n, in_ch / 3] of T, ref [n, n_vars] f32; cols [n_vars, HID, HID + in_ch] of T, the
// columns of w2 and wd (V2Weights; the float body does not read it); primal [n, n_vars] and tang
// [3, n, n_vars] are written in full.  flag must be 0.  Returns cudaGetLastError() after the launch.
int dpn_decode_jvp_v2(int is_bf16, const void* pe, const void* dpe, const void* cd,
                      const float* ref, const void* w1, const void* w1c, const float* b1,
                      const void* w2, const float* b2, const void* wd, const float* bd,
                      const float* fh, const void* f1, const float* g1, const void* f2,
                      const float* g2, const void* wo, const float* bo, const void* cols, float* primal,
                      float* tang, int64_t n, int in_ch, int n_vars, int flag, void* stream) {
  if (flag != 0) return (int)cudaErrorInvalidValue;
  const PointInputs in{pe, dpe, cd, ref, nullptr, nullptr, nullptr, nullptr, nullptr};
  const V2Weights w{w1, w1c, b1, w2, b2, wd, bd, fh, f1, g1, f2, g2, wo, bo, cols};
  return dispatch<false>(is_bf16, in, w, primal, tang, n, in_ch, n_vars, stream);
}

// v3.  coords [n, 3] and cdata [n, 6] f32 (cdata is also the reference value), scales [3],
// fb [in_ch / 6], fb2 [in_ch / 12] f32; w1 and wd with their rows channel-major, cols as v2's
// from them (the float body does not read it); n_vars is 6.
int dpn_decode_jvp_v3(int is_bf16, const float* coords, const float* cdata,
                      const float* scales, const float* fb, const float* fb2, const void* w1,
                      const float* b1, const void* w2, const float* b2, const void* wd,
                      const float* bd, const float* fh, const void* f1, const float* g1,
                      const void* f2, const float* g2, const void* wo, const float* bo, const void* cols,
                      float* primal, float* tang, int64_t n, int in_ch, int n_vars, int flag,
                      void* stream) {
  if (flag != 0) return (int)cudaErrorInvalidValue;
  const PointInputs in{nullptr, nullptr, nullptr, cdata, coords, cdata, scales, fb, fb2};
  const V2Weights w{w1, nullptr, b1, w2, b2, wd, bd, fh, f1, g1, f2, g2, wo, bo, cols};
  return dispatch<true>(is_bf16, in, w, primal, tang, n, in_ch, n_vars, stream);
}

}  // extern "C"
