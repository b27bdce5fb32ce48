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
// bf16 (decode_jvp_v4_tc<false>, the flagship's type): the products on the tensor cores
// (mma.sync m16n8k16 through decode_mma.cuh; the body is decode_jvp_tc.cuh, which the v4s / v6
// forward and backward share), in the TPU kernel's two stages
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
//   8 x 5 x 1,280, lie in it), the per-point partial sums (10,496): 226,560 bytes (fwd_smem).
// * Rounding.  The products are exact and summed in f32 in another order than the plain
//   version's (cuBLAS: one FMA a term, in k order).  z and r take each k16 product into
//   zeros and add it with an f32 add (warp_mma's RN rows): the tensor cores' own running
//   sum rounds differently, and z feeds T(p) and both relu masks.  Where z or u_k lies
//   within TIE_ULPS_Z / TIE_ULPS_U ulps, or TIE_FLOOR_Z / TIE_FLOOR_U of its row's largest
//   value, of a bf16 rounding tie, T(p) or t_k is recomputed in the plain version's order once
//   stage 1 is done (fix_ties); without that, T(p) and t_k flip by one step at some elements of
//   a flagship frame, and tangents move past chip_smoke.py's bound.
//
// float (decode_jvp_v4_kernel, the parity configuration; no TF32): the products on the
// CUDA cores (FMA), the chain of decode_common.cuh's primal_stages and tangent_stage; the
// compact tangent rows are loaded over the block's pe rows once r is done.
//
// Two more TPU kernels are compile-time variants ([N, 6] outputs):
// * v4pe, _decode_kernel_v4pe (fused_decode_jvp_v4pe, :1249-1407): raw coordinates
//   [N, 3] and conditioning values [N, 6] in; the block's channel-major pe, cd and tangent
//   rows are computed in the kernel (decode_pe.cuh; the wrapper permutes w1, wdf1 and wdwo
//   to that order), so direction k's tangent rows are rows k*ch:(k+1)*ch of w1 and no w1c
//   is read: the channel-major w1 [V, in_ch, HID] seen as [V, 3, ch, HID] is the tangent
//   weight, passed as w1c.  That saves the 1,150 bytes a point of prepared inputs.  bf16:
//   the tensor-core body above (decode_jvp_v4_tc<true>) with decode_pe.cuh's PeSource as
//   its row source: the front end writes the block's rows at the body's strides from one
//   sincosf an angle (12,288 a block of a variable at in_ch 192, where the CUDA-core front
//   end took 36,864 sinf / cosf), and fix_ties computes a flagged value's row again from the
//   point's coordinates (a chunk of 64 values a coordinate channel, one sincosf a lane: three
//   chunks for z, one for u_k), with the same windows and floors as v4.  float:
//   decode_jvp_v4_kernel with the PE front end of front_rows.
// * v5, _decode_kernel_v5 (fused_decode_jvp_v5, decode_kernel.py:1117-1247): the same
//   function with r summed as T(p) . w2f1 + (cd . wdf1 + rbias) (:1149, :1156), so
//   cd . wdf1 gets an accumulator of its own.  bf16: the tensor-core body above
//   (decode_jvp_v4_tc<kV5>) with forward_block's SPLIT_R switch: stage 2 sums row set 0's
//   cd . wdf1 k16 products into a [16 x 32] accumulator of its own, live only over a pass's
//   wdf1 tiles (when the four row sets' fragments are no longer held), and adds acc + (cd +
//   rbias) before the epilogue; 255 registers and no spill, as v4 (ptxas on an H100 build).
//   Its z and u_k are v4's, so fix_ties and its floors apply unchanged.  float:
//   decode_jvp_v4_kernel with primal_stages<SPLIT>.  The TPU kernel stacks the six variables'
//   layer-1 products by column into one wide product to cut op dispatch; that changes no sum
//   and is not carried over.

#include "decode_common.cuh"
#include "decode_jvp_tc.cuh"
#include "decode_pe.cuh"

namespace {

using namespace dpn;

constexpr int TM = 8;            // accumulator rows per thread
constexpr int NB = WARPS * TM;   // points per block
static_assert(NB == jvp::NB, "both bodies take the same points a block");

enum Variant { kV4 = 0, kV5 = 1, kV4pe = 2 };

// ---- bf16: tensor cores (decode_jvp_tc.cuh) ------------------------------------------

// kV4pe: the rows from raw coordinates (decode_pe.cuh's PeSource), else from pe, dpe and cd;
// kV5: r summed as v5 sums it (forward_block's SPLIT_R).  Both compile-time switches of the body.
template <int VARIANT>
__global__ void __launch_bounds__(THREADS, 1)
decode_jvp_v4_tc(PointInputs in, const jvp::bf16* __restrict__ w1, const jvp::bf16* __restrict__ w1c,
                 const float* __restrict__ b1, const jvp::bf16* __restrict__ w2f1,
                 const jvp::bf16* __restrict__ wdf1, const float* __restrict__ rbias,
                 const float* __restrict__ fw2, const float* __restrict__ w2wo,
                 const float* __restrict__ wdwo, const float* __restrict__ obias,
                 float* __restrict__ primal, float* __restrict__ tang, int64_t n, int in_ch,
                 int n_vars, int t_layout) {
  constexpr bool PE = VARIANT == kV4pe;
  const int v = blockIdx.y;
  const auto src = [&] {
    if constexpr (PE) return PeSource{in.coords, in.cdata, in.scales, in.fb, in.fb2, n, in_ch};
    else return jvp::RowSource{static_cast<const jvp::bf16*>(in.pe), static_cast<const jvp::bf16*>(in.dpe), n, in_ch};
  }();
  jvp::forward_block<VARIANT == kV5>(src, static_cast<const jvp::bf16*>(in.cd), in.ref, w1 + (size_t)v * in_ch * HID,
                     w1c + (size_t)v * in_ch * HID, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, primal, tang,
                     n_vars, t_layout != 0);
}

template <bool PE> bool tc_valid(int in_ch) {
  return jvp::row_region_valid(in_ch, true) && (!PE || PeSource::valid(in_ch));
}

template <int VARIANT>
int launch_tc(const PointInputs& in, const void* w1, const void* w1c, const float* b1,
              const void* w2f1, const void* wdf1, const float* rbias, const float* fw2,
              const float* w2wo, const float* wdwo, const float* obias, float* primal, float* tang,
              int64_t n, int in_ch, int n_vars, int t_layout, cudaStream_t stream) {
  if (!tc_valid<VARIANT == kV4pe>(in_ch)) return (int)cudaErrorInvalidValue;
  const size_t smem = jvp::fwd_smem(in_ch, true).total;
  cudaError_t err = cudaFuncSetAttribute(decode_jvp_v4_tc<VARIANT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((n + NB - 1) / NB), (unsigned)n_vars);
  decode_jvp_v4_tc<VARIANT><<<grid, THREADS, smem, stream>>>(
      in, static_cast<const jvp::bf16*>(w1), static_cast<const jvp::bf16*>(w1c), b1,
      static_cast<const jvp::bf16*>(w2f1), static_cast<const jvp::bf16*>(wdf1), rbias, fw2, w2wo, wdwo, obias, primal, tang, n, in_ch, n_vars, t_layout);
  return (int)cudaGetLastError();
}

// ---- float: CUDA cores ------------------------------------------------------------------

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
  if (is_bf16)
    return launch_tc<VARIANT>(in, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, primal, tang, n, in_ch,
                              n_vars, t_layout, s);
  return launch<float, VARIANT>(in, w1, w1c, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias, primal,
                                tang, n, in_ch, n_vars, t_layout, s);
}

// ---- the PE front ends' rows, for holding them to each other on the card -------------------
//
// One block of NB points writes the rows of one front end to pe [n, in_ch], dpe [3, n, ch] and
// cd [n, in_ch] bf16: mode 0 PeSource::front (the tensor-core bodies'), mode 1 front_rows and
// front_tangent_rows (one sinf or cosf a value) rounded to bf16, mode 2 PeSource::chunk_pair
// (fix_ties's recompute of a point's row) for pe and the tangent rows, with mode 0's cd.
__global__ void __launch_bounds__(THREADS, 1)
pe_rows_kernel(PointInputs in, int mode, __nv_bfloat16* pe, __nv_bfloat16* dpe, __nv_bfloat16* cd, int64_t n,
               int in_ch) {
  extern __shared__ __align__(16) unsigned char smem[];
  using bf16 = __nv_bfloat16;
  const int ch = in_ch / 3;
  bf16* pe_s = reinterpret_cast<bf16*>(smem);  // [NB, in_ch]
  bf16* dpe_s = pe_s + NB * in_ch;              // [3, NB, ch]
  bf16* cd_s = dpe_s + NB * in_ch;              // [NB, in_ch]
  const int64_t n0 = (int64_t)blockIdx.x * NB;
  const PeSource src{in.coords, in.cdata, in.scales, in.fb, in.fb2, n, in_ch};
  if (mode == 1) {
    front_rows<bf16, true>(in, pe_s, cd_s, n0, n, NB, in_ch);
    front_tangent_rows<bf16, true>(in, dpe_s, n0, n, NB, in_ch);
  } else {
    src.front(pe_s, in_ch, dpe_s, ch, cd_s, n0, NB);
  }
  __syncthreads();
  if (mode == 2) {
    for (int i = threadIdx.x; i < NB * 6 * PeSource::F; i += THREADS) {  // a point's three pe chunks, its tangent rows
      const int row = i / (6 * PeSource::F), q = i / PeSource::F % 6, j = i % PeSource::F;
      if (n0 + row >= n) continue;
      src.chunk_pair(q % 3, q >= 3, n0 + row, j, q < 3 ? pe_s + row * in_ch + q * ch : dpe_s + ((q - 3) * NB + row) * ch);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < NB * in_ch; i += THREADS) {
    const int row = i / in_ch, col = i - row * in_ch;
    if (n0 + row >= n) continue;
    pe[(n0 + row) * in_ch + col] = pe_s[i];
    cd[(n0 + row) * in_ch + col] = cd_s[i];
    const int k = col / ch;
    dpe[((int64_t)k * n + n0 + row) * ch + col - k * ch] = dpe_s[(k * NB + row) * ch + col - k * ch];
  }
}

PointInputs prepared(const void* pe, const void* dpe, const void* cd, const float* ref) {
  return PointInputs{pe, dpe, cd, ref, nullptr, nullptr, nullptr, nullptr, nullptr};
}

}  // namespace

extern "C" {

// Hidden width the kernel was built for; shared memory one block needs at this
// input width (bf16: the tensor-core body of every variant; v4pe takes in_ch 192 only).
int dpn_decode_jvp_v4_hid() { return dpn::HID; }
int dpn_decode_jvp_v4_block() { return NB; }  // points a block takes, every body and variant
int dpn_decode_jvp_v4_shared_bytes(int is_bf16, int in_ch) {
  if (!is_bf16) return (int)shared_bytes<float>(in_ch);
  return tc_valid<false>(in_ch) ? (int)jvp::fwd_smem(in_ch, true).total : 1 << 30;
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
// wdwo with their rows channel-major; n_vars is 6.  bf16 takes in_ch 192 (PeSource).
int dpn_decode_jvp_v4pe(int is_bf16, const float* coords, const float* cdata,
                        const float* scales, const float* fb, const float* fb2, const void* w1,
                        const float* b1, const void* w2f1, const void* wdf1, const float* rbias,
                        const float* fw2, const float* w2wo, const float* wdwo,
                        const float* obias, float* primal, float* tang, int64_t n, int in_ch,
                        int n_vars, int t_layout, void* stream) {
  const PointInputs in{nullptr, nullptr, nullptr, cdata, coords, cdata, scales, fb, fb2};
  // the channel-major w1 [n_vars, 3, ch, HID] is the tangent weight w1c
  return dispatch<kV4pe>(is_bf16, in, w1, w1, b1, w2f1, wdf1, rbias, fw2, w2wo, wdwo, obias,
                         primal, tang, n, in_ch, n_vars, t_layout, stream);
}

// The rows of one PE front end (pe_rows_kernel's mode 0, 1 or 2) for coords [n, 3], cdata [n, 6],
// scales, fb and fb2 as dpn_decode_jvp_v4pe takes them, into pe [n, in_ch], dpe [3, n, in_ch / 3]
// and cd [n, in_ch] bf16.  in_ch 192.  Returns cudaGetLastError() after the launch.
int dpn_decode_pe_rows(const float* coords, const float* cdata, const float* scales, const float* fb,
                       const float* fb2, void* pe, void* dpe, void* cd, int64_t n, int in_ch, int mode,
                       void* stream) {
  if (!PeSource::valid(in_ch) || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  const PointInputs in{nullptr, nullptr, nullptr, cdata, coords, cdata, scales, fb, fb2};
  const size_t smem = 3 * (size_t)NB * in_ch * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(pe_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  pe_rows_kernel<<<(unsigned)((n + NB - 1) / NB), THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      in, mode, static_cast<__nv_bfloat16*>(pe), static_cast<__nv_bfloat16*>(dpe), static_cast<__nv_bfloat16*>(cd),
      n, in_ch);
  return (int)cudaGetLastError();
}

}  // extern "C"
