// The whole variable encoder in one launch, for Hopper (sm_90a): n_layers post-norm
// layers, the final LayerNorm and the projection, from embedded tokens [L, D] f32 to
// the encoder's output [L, C] f32.
//
// Replaces the TPU kernel deepphysinet_tpu/ops/encoder_kernel.py::_encoder_kernel
// (:132-190, called through fused_encoder_forward :223).  Per layer, with the TPU
// kernel's rounding points (T = the compute type; matmul inputs in T, products
// summed in f32; dense outputs rounded to T before their bias, added in T):
//
//   q_h, k_h, v_h = T(T(x . W_h) + T(b_h))                        per head h
//   a_h  = T(softmax_f32(q_h . k_h^T * scale)),  o_h = T(a_h . v_h)
//   x    = LN(x + T(T(sum_h o_h . Wo_h) + T(bo)))                 LN in f32, eps 1e-6
//   x    = LN(x + T(T(T(act(T(T(x . W1) + T(b1)))) . W2) + T(b2)))
//
// then out = T(T(LN(x) . Wproj) + T(bproj)) as f32.  The residual stream stays f32.
//
// What bounds it: at flagship width (L = 287, D = F = C = 256, 8 heads of 32, 4
// layers) about 1.28 GFLOP against about 3.9 MB (bf16 weights 3.1 MB, tokens in and
// out), so about 1.3 us on paper, operations-bound; in practice the work is tiny and
// what costs is latency: as separate PyTorch operators the encoder is about fifty
// launches.  The TPU answer, kept here, is ONE launch.  A single block would leave all
// but one SM idle, so each stage is spread over the grid and the stages are separated
// by grid-wide barriers: a cooperative launch (every block resident, cooperative_groups'
// grid sync).  The activations live in device-memory scratch that the wrapper allocates
// (at 288 x 256 per buffer they stay in L2); a block reads what other blocks wrote through
// L2 (__ldcg, cp.async.cg), never its SM's own L1, which is not coherent across SMs.
//
// bf16 (encoder_tc, the flagship's type): the products on the tensor cores (mma.sync
// m16n8k16, mma_bf16.cuh), in thread-block clusters of CL = 4 blocks, launched with the
// cooperative and the cluster attribute together (cudaLaunchKernelEx; an H100 takes both).
// Eight grid barriers for four layers (the CUDA-core body below takes eleven):
//
//   A. layer 0's q, k, v: a cluster a row group of 16 rows (one m16 tile), each block of it
//      a quarter of each matrix's columns;
//   B. attention, per layer: units of (head, 32 query rows), eight warps as two m16 row
//      tiles x four 64-key slices of every 256-key block, K and V of all L keys resident in
//      shared memory; attention.cu's exact-softmax body (attention_tc.cuh: score_slice,
//      slice_max, exp_slice, pv_slice; two passes over the keys, the normalised
//      probabilities rounded to T), the head width zero-padded to EP = 16, 32 or 64;
//   C. rows, per layer: a cluster a row group.  Each block owns a quarter of the output
//      columns of the out-projection, FFN1 and FFN2 and pushes its results into every
//      block of the cluster through distributed shared memory (the full rows each LayerNorm
//      and product needs), one cluster barrier per product; every block then forms the
//      LayerNorms of the full rows itself, the same arithmetic on the same values.  After
//      LN2 the cluster forms the NEXT layer's q, k, v from the rows it holds (stage A's
//      product), which takes the q/k/v stage and its barrier out of layers 1-3; after the
//      last layer, the final LayerNorm and the projection.
//
// Products: A [16, K] bf16 in shared memory (zeros from K to the next multiple of 16) times the
// block's column slice of W [K, N], one tile of K rows (K, N <= 256: at flagship width [256, 64]);
// warp w takes the slice's n8 tile w.  The weights come packed on the host (pack_encoder_weights)
// so that a block's tile of a product is one contiguous array in its shared-memory layout (rows
// padded by 8 elements, so that ldmatrix meets no bank conflict), and one bulk copy (the tensor
// memory accelerator, cp.async.bulk, completing on an mbarrier) moves it: a ring of four slots,
// three tiles in flight, the first three of a stage C sent before the grid barrier that opens
// it.  The rows and the biases and LayerNorm vectors of a unit come by bulk copies too: timed on
// an H100 with clock64 marks in a copy of this file, 16-byte cp.async copies with their address
// arithmetic held up the issuing threads for microseconds a tile, and the vectors read from global
// memory held up each LayerNorm; the bulk copies take neither.  Each stage is called from one
// place and each product is one tile, so that the code that runs stays in the instruction cache
// (inlined at every call, the copies of a stage took longer to fetch than to run).  Rounding as
// above; the tensor cores sum the exact products of a k16 step in another order than the CUDA-core
// body, and exp is ex2.approx with log2 e folded into the scale (attention.cu), so a bf16 rounding
// here and there flips.  Head widths above 64, a width above 256, or shared memory past a block's
// limit take the CUDA-core body instead, so the wrapper accepts what it always did.
//
// float (encoder_kernel<float>, the parity configuration, no TF32) and the bf16 shapes above:
// the products on the CUDA cores (FMA), each thread owning output columns of the unit's rows
// and reading their weights straight from L2, several rows ahead.  Per layer three stages,
// three barriers (the last layer's final barrier is not needed):
//
//   1. q, k, v: units of (matrix, R = 8 rows), each a [8, D] x [D, H E] product of
//      the per-head weights [H, D, E] read in place; to qkv [3, H, L, E] in T;
//   2. attention: units of (head, 32 query rows); k_h and v_h of all L keys, the
//      block's q rows and their [32, L] f32 scores in shared memory, the softmax
//      exact over the whole row; to o [L, H E] in T;
//   3. rows: units of R = 8 whole rows; the out-projection, residual and LN1, the
//      FFN, residual and LN2 (and after the last layer the final LN and projection)
//      on shared-memory rows, to the residual stream [L, D] f32 (or the output).
//
// DPN_ENCODER_SKIP (default 0) drops the units of one stage of the tensor-core body, keeping
// every barrier, for timing the stages by difference (chip_smoke.py): 1 stage A, 2 the
// attention stages, 3 the rows stages, 4 all three.

#include <cooperative_groups.h>

#include <algorithm>

#include "attention_tc.cuh"
#include "decode_common.cuh"

#ifndef DPN_ENCODER_SKIP
#define DPN_ENCODER_SKIP 0
#endif

namespace cg = cooperative_groups;

namespace dpn {

struct EncoderArgs {
  const float* x;  // [L, D] embedded tokens
  const void* wq;  // [NL, H, D, E] T
  const float* bq; // [NL, H, E]
  const void* wk;
  const float* bk;
  const void* wv;
  const float* bv;
  const void* wo;  // [NL, H, E, D] T: [NL, H E, D]
  const float* bo; // [NL, D]
  const float* ln1s;
  const float* ln1b;
  const void* w1;  // [NL, D, F] T
  const float* b1; // [NL, F]
  const void* w2;  // [NL, F, D] T
  const float* b2; // [NL, D]
  const float* ln2s;
  const float* ln2b;
  const float* lns;  // [D]
  const float* lnb;
  const void* wproj;  // [D, C] T
  const float* bproj; // [C]
  float* xres;        // [L, D] scratch: the residual stream between layers
  void* qkv;          // [3, H, L, E] T scratch
  void* o;            // [L, H E] T scratch
  float* out;         // [L, C]
  int L, D, H, E, F, C, NL, gelu;
  float scale;
  const void* packed;           // bf16 body: the weights as its tiles (pack_encoder_weights)
  const long long* offsets;     // [NL 6 + 1, 4]: where each block's tiles of each product start
};

}  // namespace dpn

namespace {

using dpn::EncoderArgs;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int R = 8;    // rows per unit of stages 1 and 3
constexpr int QB = 32;  // query rows per unit of stage 2
constexpr float LN_EPS = 1e-6f;

// The widest product of a layer: the weight tile's and the row buffers' width.
__device__ __forceinline__ int max_width(const EncoderArgs& a) {
  return max(max(a.D, a.F), max(a.C, a.H * a.E));
}

// out_s[r, c] = sum_k a_s[r, k] W(k, c) for r < R, c < N, f32; a_s [R, K] in shared
// memory holds values already rounded to T.  W's columns come in groups of cw whose rows are
// cw apart, group g at W + g cs: a plain [K, N] matrix is one group (cw = N, cs = 0), the
// per-head q/k/v weights [H, D, E] are H groups (cw = E, cs = D E).  Thread t owns columns
// t, t + THREADS, ... and reads its column's weights straight from device memory (L2), eight
// rows ahead: a warp's reads of one row are one coalesced transaction.  (Staging 32-row
// tiles of the weights through shared memory was slower on an H100.)
template <typename T>
__device__ __forceinline__ void gemm_rows(const float* a_s, int K, const T* __restrict__ W, int N,
                                          int cw, int cs, float* out_s) {
  for (int c = threadIdx.x; c < N; c += THREADS) {
    const T* w = W + (size_t)(c / cw) * cs + c % cw;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
      const float wv = dpn::to_f32(w[(size_t)k * cw]);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(a_s[r * K + k], wv, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) out_s[r * N + c] = acc[r];
  }
}

// Rows r0 .. r0 + R - 1 of a row-major [L, width] array that other blocks of this launch
// wrote (through L2: __ldcg), as float into dst [R, width]; rows past nr are zeros.  With
// round_in, each value rounded to T (a product's input).
template <typename T, typename S>
__device__ __forceinline__ void load_unit_rows(const S* src, int r0, int nr, int width, float* dst,
                                               bool round_in) {
  constexpr int VEC = 16 / sizeof(S);
  const int per_row = width / VEC;
  dpn::copy_vectors<4>(
      R * per_row,
      [&](int i) {
        return i / per_row < nr ? __ldcg(reinterpret_cast<const uint4*>(src + (size_t)r0 * width) + i)
                                : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int i, const uint4& v) {
        float f[VEC];
        dpn::unpack<S>(v, f);
#pragma unroll
        for (int j = 0; j < VEC; ++j) dst[i * VEC + j] = round_in ? dpn::round_to<T>(f[j]) : f[j];
      });
}

// A dense layer's output: T(T(acc) + T(bias)).
template <typename T>
__device__ __forceinline__ float dense_out(float acc, float bias) {
  return dpn::round_to<T>(dpn::round_to<T>(acc) + dpn::round_to<T>(bias));
}

// LayerNorm (f32, eps 1e-6) of the rows of xs [R, D] in place, one warp per row.
__device__ __forceinline__ void layer_norm_rows(float* xs, int D, const float* __restrict__ s,
                                                const float* __restrict__ b) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < R; r += WARPS) {
    float* row = xs + r * D;
    float sum = 0.0f;
    for (int d = lane; d < D; d += 32) sum += row[d];
    const float mean = dpn::warp_sum(sum) / D;
    float sq = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float c = row[d] - mean;
      sq += c * c;
    }
    const float inv = 1.0f / sqrtf(dpn::warp_sum(sq) / D + LN_EPS);
    for (int d = lane; d < D; d += 32) row[d] = (row[d] - mean) * inv * s[d] + b[d];
  }
}

__device__ __forceinline__ float activation(float x, int gelu) {
  if (!gelu) return fmaxf(x, 0.0f);
  return x * (0.5f * (1.0f + tanhf(0.7978845608028654f * (x + 0.044715f * (x * x * x)))));
}

// Stage 1: q, k, v of R rows for one of the three matrices.
template <typename T>
__device__ void qkv_unit(const EncoderArgs& a, int layer, int m, int r0, float* smem) {
  const int D = a.D, HE = a.H * a.E, nr = min(R, a.L - r0);
  float* xs = smem;         // [R, D]
  float* acc = xs + R * D;  // [R, H E]
  load_unit_rows<T>(layer == 0 ? a.x : a.xres, r0, nr, D, xs, true);
  __syncthreads();
  const void* wm = m == 0 ? a.wq : m == 1 ? a.wk : a.wv;
  const float* bm = (m == 0 ? a.bq : m == 1 ? a.bk : a.bv) + (size_t)layer * HE;
  gemm_rows<T>(xs, D, static_cast<const T*>(wm) + (size_t)layer * a.H * D * a.E, HE, a.E, D * a.E, acc);
  __syncthreads();
  T* qkv = static_cast<T*>(a.qkv);
  for (int i = threadIdx.x; i < nr * HE; i += THREADS) {
    const int r = i / HE, c = i - r * HE, h = c / a.E, e = c - h * a.E;
    qkv[(((size_t)m * a.H + h) * a.L + r0 + r) * a.E + e] = dpn::from_f32<T>(dense_out<T>(acc[i], bm[c]));
  }
}

// Stage 2: softmax attention of QB query rows of head h over all L keys.
template <typename T>
__device__ void attention_unit(const EncoderArgs& a, int h, int q0, float* smem) {
  const int L = a.L, E = a.E, HE = a.H * a.E;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* Ks = smem;             // [L, E + 1]
  float* Vs = Ks + L * (E + 1); // [L, E]
  float* Qs = Vs + L * E;       // [QB, E + 1]
  float* S = Qs + QB * (E + 1); // [QB, L]
  const T* qkv = static_cast<const T*>(a.qkv);
  const T* qh = qkv + (size_t)h * L * E;
  const T* kh = qkv + ((size_t)a.H + h) * L * E;
  const T* vh = qkv + ((size_t)2 * a.H + h) * L * E;
  constexpr int VEC = 16 / sizeof(T);  // E is a multiple of VEC
  const int per_row = E / VEC;
  dpn::copy_vectors<8>(  // k_h and v_h of all L keys: one vector of each per i
      2 * L * per_row,
      [&](int i) { return __ldcg(reinterpret_cast<const uint4*>(i < L * per_row ? kh : vh) + i % (L * per_row)); },
      [&](int i, const uint4& v) {
        float f[VEC];
        dpn::unpack<T>(v, f);
        const bool is_k = i < L * per_row;
        const int j0 = (i % (L * per_row)) * VEC, s = j0 / E, e0 = j0 - s * E;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          if (is_k)
            Ks[s * (E + 1) + e0 + j] = f[j];
          else
            Vs[j0 + j] = f[j];
        }
      });
  dpn::copy_vectors<2>(
      QB * per_row,
      [&](int i) {
        return q0 + i / per_row < L ? __ldcg(reinterpret_cast<const uint4*>(qh + (size_t)q0 * E) + i)
                                    : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int i, const uint4& v) {
        float f[VEC];
        dpn::unpack<T>(v, f);
        const int r = i / per_row, e0 = (i - r * per_row) * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) Qs[r * (E + 1) + e0 + j] = f[j];
      });
  __syncthreads();
  for (int i = threadIdx.x; i < QB * L; i += THREADS) {
    const int r = i / L, c = i - r * L;
    float s = 0.0f;
    for (int e = 0; e < E; ++e) s = fmaf(Qs[r * (E + 1) + e], Ks[c * (E + 1) + e], s);
    S[i] = s * a.scale;
  }
  __syncthreads();
  for (int r = warp; r < QB; r += WARPS) {
    float* row = S + r * L;
    float mx = -INFINITY;
    for (int c = lane; c < L; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int c = lane; c < L; c += 32) {
      const float ex = expf(row[c] - mx);
      row[c] = ex;
      sum += ex;
    }
    sum = dpn::warp_sum(sum);
    for (int c = lane; c < L; c += 32) row[c] = dpn::round_to<T>(row[c] / sum);
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o);
  for (int i = threadIdx.x; i < QB * E; i += THREADS) {
    const int r = i / E, e = i - r * E;
    if (q0 + r >= L) continue;
    float acc = 0.0f;
    for (int c = 0; c < L; ++c) acc = fmaf(S[r * L + c], Vs[c * E + e], acc);
    o[(size_t)(q0 + r) * HE + h * E + e] = dpn::from_f32<T>(acc);
  }
}

// Stage 3: the rest of the layer for R whole rows; after the last layer, the final
// LayerNorm and the projection too.
template <typename T>
__device__ void rows_unit(const EncoderArgs& a, int layer, int r0, float* smem) {
  const int D = a.D, F = a.F, C = a.C, HE = a.H * a.E, nr = min(R, a.L - r0);
  const int W = max_width(a);
  float* xs = smem;                    // [R, D] the residual stream, f32
  float* ar = xs + R * D;              // [R, W] a product's input, rounded to T
  float* acc = ar + R * W;             // [R, W] a product's f32 sums
  load_unit_rows<T>(layer == 0 ? a.x : a.xres, r0, nr, D, xs, false);
  load_unit_rows<T>(static_cast<const T*>(a.o), r0, nr, HE, ar, false);
  __syncthreads();
  // out-projection, residual, LN1
  gemm_rows<T>(ar, HE, static_cast<const T*>(a.wo) + (size_t)layer * HE * D, D, D, 0, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += THREADS) xs[i] += dense_out<T>(acc[i], a.bo[layer * D + i % D]);
  __syncthreads();
  layer_norm_rows(xs, D, a.ln1s + layer * D, a.ln1b + layer * D);
  __syncthreads();
  // FFN, residual, LN2
  for (int i = threadIdx.x; i < R * D; i += THREADS) ar[i] = dpn::round_to<T>(xs[i]);
  __syncthreads();
  gemm_rows<T>(ar, D, static_cast<const T*>(a.w1) + (size_t)layer * D * F, F, F, 0, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < R * F; i += THREADS)
    ar[i] = dpn::round_to<T>(activation(dense_out<T>(acc[i], a.b1[layer * F + i % F]), a.gelu));
  __syncthreads();
  gemm_rows<T>(ar, F, static_cast<const T*>(a.w2) + (size_t)layer * F * D, D, D, 0, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += THREADS) xs[i] += dense_out<T>(acc[i], a.b2[layer * D + i % D]);
  __syncthreads();
  layer_norm_rows(xs, D, a.ln2s + layer * D, a.ln2b + layer * D);
  __syncthreads();
  if (layer + 1 < a.NL) {
    for (int i = threadIdx.x; i < nr * D; i += THREADS) a.xres[(size_t)r0 * D + i] = xs[i];
    return;
  }
  // final LayerNorm and projection
  layer_norm_rows(xs, D, a.lns, a.lnb);
  __syncthreads();
  for (int i = threadIdx.x; i < R * D; i += THREADS) ar[i] = dpn::round_to<T>(xs[i]);
  __syncthreads();
  gemm_rows<T>(ar, D, static_cast<const T*>(a.wproj), C, C, 0, acc);
  __syncthreads();
  for (int i = threadIdx.x; i < nr * C; i += THREADS) a.out[(size_t)r0 * C + i] = dense_out<T>(acc[i], a.bproj[i % C]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1) encoder_kernel(const EncoderArgs a) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int n_rows = (a.L + R - 1) / R, n_q = (a.L + QB - 1) / QB;
  for (int layer = 0; layer < a.NL; ++layer) {
    for (int u = blockIdx.x; u < 3 * n_rows; u += gridDim.x) {
      __syncthreads();  // the previous unit's readers of shared memory are done
      qkv_unit<T>(a, layer, u / n_rows, (u % n_rows) * R, smem);
    }
    grid.sync();
    for (int u = blockIdx.x; u < a.H * n_q; u += gridDim.x) {
      __syncthreads();
      attention_unit<T>(a, u / n_q, (u % n_q) * QB, smem);
    }
    grid.sync();
    for (int u = blockIdx.x; u < n_rows; u += gridDim.x) {
      __syncthreads();
      rows_unit<T>(a, layer, u * R, smem);
    }
    if (layer + 1 < a.NL) grid.sync();
  }
}

size_t smem_bytes(int L, int D, int H, int E, int F, int C) {
  const int HE = H * E, W = std::max(std::max(D, F), std::max(C, HE));
  // in floats
  const size_t qkv = (size_t)R * D + (size_t)R * HE;
  const size_t attn = (size_t)L * (E + 1) + (size_t)L * E + (size_t)QB * (E + 1) + (size_t)QB * L;
  const size_t rows = (size_t)R * D + 2 * (size_t)R * W;
  return sizeof(float) * std::max(qkv, std::max(attn, rows));
}

template <typename T>
int launch(const EncoderArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.L, a.D, a.H, a.E, a.F, a.C);
  cudaError_t err = cudaFuncSetAttribute(encoder_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, encoder_kernel<T>, THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int n_rows = (a.L + R - 1) / R, n_q = (a.L + QB - 1) / QB;
  const int units = std::max(3 * n_rows, a.H * n_q);
  const int blocks = std::min(units, per_sm * sms);
  EncoderArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel((const void*)encoder_kernel<T>, dim3(blocks), dim3(THREADS), params, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---- bf16: tensor cores ----------------------------------------------------------------

namespace tce {

using bf16 = __nv_bfloat16;
using dpn::mma::cp_async16;
using dpn::mma::smem_addr;

constexpr int CL = 4;      // blocks of a cluster: a row group's products split by column
constexpr int RG = 16;     // rows of a row group: one m16 tile
constexpr int QR = 32;     // query rows of an attention unit: two m16 tiles x KW key slices
constexpr int SLOT = 256 * 72 * 2;  // bytes of a weight tile's slot: a [256, 64] slice at row stride 72
constexpr int NS = 4;               // slots of the ring: NS - 1 tiles in flight
constexpr int MAX_WIDTH = 256;  // D, F, C and H E: a product is one tile of at most 64 columns a block
static_assert(WARPS == 2 * dpn::attn::KW, "an attention unit: two row tiles x KW key slices");
static_assert(MAX_WIDTH * (MAX_WIDTH / CL + 8) * 2 <= SLOT, "a product's tile fits a slot");

__host__ __device__ constexpr int up16(int x) { return (x + 15) / 16 * 16; }
// Row stride (elements) of a bf16 operand of `cols` columns in shared memory: an odd multiple
// of 16 bytes, so the eight rows of an ldmatrix lie in distinct banks.
__host__ __device__ constexpr int ld_bf16(int cols) { return up16(cols) + 8; }

// A block's columns of a product N wide: n8 tiles [rank nt / CL, (rank + 1) nt / CL).
struct Cols {
  int c0, nc;
};
__host__ __device__ inline Cols cols_of(int n, int rank) {
  const int nt = n / 8, a = rank * nt / CL, b = (rank + 1) * nt / CL;
  return Cols{8 * a, 8 * (b - a)};
}

// mbarrier and bulk-copy helpers (the tensor memory accelerator): a bulk copy runs in the
// background and signals its bytes to an mbarrier, without taking the issuing threads' load slots.
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {  // arrives once
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT_%=:\nmbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to this block's shared memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}
// orders this thread's earlier generic-proxy accesses of shared memory before its later bulk copies
__device__ __forceinline__ void fence_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// One product's weight tile: the block's slice of [K, N] (its columns cols), up16(K) rows at row
// stride ld, rows past K and columns past the slice zeros (pack_encoder_weights, which holds the
// same arithmetic).  K, N <= MAX_WIDTH, so a tile fills at most one slot.
struct Weight {
  const bf16* tile;
  int K;
  Cols cols;
  __device__ int ld() const { return ld_bf16(cols.nc); }
  __device__ uint32_t bytes() const { return (uint32_t)(up16(K) * ld() * sizeof(bf16)); }
};

// The products of the block's row units of one stage, the same for every row group, in the order
// their tiles come through the ring: stage A (layer < 0) layer 0's q, k, v; stage C of a layer the
// out-projection, FFN1, FFN2 and the next layer's q, k, v, or after the last layer the projection.
// Product p of the packed array: 6 l + (0 wo, 1 w1, 2 w2, 3 wq, 4 wk, 5 wv), 6 NL wproj.
struct Plan {
  Weight w[6];
  int n;
  // The packed-array products of a stage (stage A: layer < 0), and where the block's tiles of each
  // start: loaded into registers ahead of the stage (the loads' latency hidden behind the work
  // before it), then given to make().
  __device__ static int count_of(const EncoderArgs& a, int layer) { return (layer >= 0 ? 3 : 0) + (layer == a.NL - 1 ? 1 : 3); }
  __device__ static int product_of(const EncoderArgs& a, int layer, int i) {
    if (layer >= 0 && i < 3) return 6 * layer + i;                 // wo, w1, w2
    return layer == a.NL - 1 ? 6 * a.NL : 6 * (layer + 1) + 3 + i - (layer >= 0 ? 3 : 0);  // wproj; next q, k, v
  }
  __device__ static void fetch(const EncoderArgs& a, int layer, int rank, long long (&off)[6]) {
    const int n = count_of(a, layer);
#pragma unroll
    for (int i = 0; i < 6; ++i) off[i] = i < n ? a.offsets[product_of(a, layer, i) * CL + rank] : 0;
  }
  __device__ void make(const EncoderArgs& a, int layer, int rank, const long long (&off)[6]) {
    const int D = a.D, F = a.F, HE = a.H * a.E;
    const int K[6] = {HE, D, F, D, D, D}, N[6] = {D, F, D, HE, HE, HE};  // stage C with q, k, v
    const int base = layer >= 0 ? 0 : 3;
    n = count_of(a, layer);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i < n) {
        const bool projection = layer == a.NL - 1 && i == n - 1;
        w[i] = Weight{static_cast<const bf16*>(a.packed) + off[i], projection ? D : K[base + i],
                      cols_of(projection ? a.C : N[base + i], rank)};
      }
    }
  }
};

// The ring of NS weight-tile slots, filled by one bulk copy a tile, each slot with its mbarrier.
// Product i of a unit lands in slot seq % NS, seq counting the launch's tiles, so a slot's k-th
// fill completes its mbarrier's phase k (parity k & 1).  start() sends a unit's first NS - 1
// tiles; next() waits for the next tile, then (every warp being done with the slot before it)
// sends the tile NS - 1 ahead into that slot.
struct Ring {
  unsigned char* base;
  uint64_t* bars;
  const Plan* plan;
  int filled;
  uint32_t seq_fill, seq_use;
  __device__ void fill() {
    if (filled < plan->n) {
      if (threadIdx.x == 0) {
        const Weight& W = plan->w[filled];
        uint64_t* bar = bars + seq_fill % NS;
        bar_expect(bar, W.bytes());
        bulk_copy(base + (seq_fill % NS) * SLOT, W.tile, W.bytes(), bar);
      }
      ++seq_fill;
    }
    ++filled;
  }
  __device__ void start() {
    filled = 0;
#pragma unroll 1
    for (int i = 0; i < NS - 1; ++i) fill();
  }
  __device__ const bf16* next() {
    const uint32_t slot = seq_use % NS;
    bar_wait(bars + slot, (seq_use / NS) & 1);
    ++seq_use;
    __syncthreads();  // every warp is done with the slot the fill below takes
    fill();
    return reinterpret_cast<const bf16*>(base + slot * SLOT);
  }
};

// What a product's outputs become, and where they go (a row unit's epilogues):
//   PUSH_Y  y = T(T(acc) + T(bias)) as f32 into every cluster block's y rows [RG, ld];
//   PUSH_H  h = T(act(T(T(acc) + T(bias)))) as bf16 into every cluster block's h rows [RG, ld];
//   QKV     T(T(acc) + T(bias)) into matrix m of qkv [3, H, L, E], rows r0 .. r0 + nr - 1;
//   OUT     T(T(acc) + T(bias)) as f32 into out [L, ld], rows r0 .. r0 + nr - 1.
enum EpiKind { PUSH_Y, PUSH_H, QKV, OUT };
struct Epi {
  EpiKind kind;
  const float* bias;  // at the product's columns
  void* dst;          // PUSH_*: this block's rows (the others' are mapped from them); else global
  int ld, m, r0, nr, gelu, H, L, E;
};

__device__ __forceinline__ void epilogue(const Epi& e, int row, int col, float v0, float v1) {
  const float y0 = dense_out<bf16>(v0, e.bias[col]), y1 = dense_out<bf16>(v1, e.bias[col + 1]);
  cg::cluster_group cluster = cg::this_cluster();
  if (e.kind == PUSH_Y) {
#pragma unroll
    for (int r = 0; r < CL; ++r)
      *reinterpret_cast<float2*>(cluster.map_shared_rank(static_cast<float*>(e.dst), r) + row * e.ld + col) =
          make_float2(y0, y1);
  } else if (e.kind == PUSH_H) {
    const uint32_t h = dpn::mma::pack_bf16x2(activation(y0, e.gelu), activation(y1, e.gelu));
#pragma unroll
    for (int r = 0; r < CL; ++r)
      *reinterpret_cast<uint32_t*>(cluster.map_shared_rank(static_cast<bf16*>(e.dst), r) + row * e.ld + col) = h;
  } else if (row < e.nr) {
    if (e.kind == QKV) {
      const int hd = col / e.E, c = col - hd * e.E;
      *reinterpret_cast<uint32_t*>(static_cast<bf16*>(e.dst) + (((size_t)e.m * e.H + hd) * e.L + e.r0 + row) * e.E + c) =
          dpn::mma::pack_bf16x2(y0, y1);
    } else {
      *reinterpret_cast<float2*>(static_cast<float*>(e.dst) + (size_t)(e.r0 + row) * e.ld + col) = make_float2(y0, y1);
    }
  }
}

// acc = A [RG, K] . W [K, the block's columns] (one tile: K <= 256, at most 64 columns), A at row
// stride lda with zeros from K to up16(K); then the epilogue of each lane's pairs (columns col,
// col + 1 of row row).  Warp w takes the block's n8 tile w.  Four k16 steps at a time: their A
// fragments, then the B fragments of two steps by one ldmatrix.x4.trans, the products alternating
// between two accumulators (a chain of dependent mma.sync waits on each one's latency).
__device__ __forceinline__ void product(Ring& ring, const Weight& W, const bf16* A, int lda, const Epi& epi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bf16* slot = ring.next();
  if (warp >= W.cols.nc / 8) return;
  const int ld = W.ld(), ksteps = up16(W.K) / 16;
  float acc[4] = {}, acc2[4] = {};
  constexpr uint32_t B2 = sizeof(bf16);
  const uint32_t a0 = smem_addr(A + (lane & 15) * lda + ((lane >> 4) << 3));
  const uint32_t b4 = smem_addr(slot + lane * ld + 8 * warp);         // x4: k rows 0-31
  const uint32_t b2 = smem_addr(slot + (lane & 15) * ld + 8 * warp);  // x2: k rows 0-15
  int ks = 0;
  for (; ks + 4 <= ksteps; ks += 4) {
    uint32_t af[4][4], bf[2][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) dpn::mma::ldmatrix_x4(af[u], a0 + 16 * (ks + u) * B2);
#pragma unroll
    for (int h = 0; h < 2; ++h) dpn::mma::ldmatrix_x4_trans(bf[h], b4 + 16 * (ks + 2 * h) * ld * B2);
    dpn::mma::mma_16816(acc, af[0], bf[0][0], bf[0][1]);
    dpn::mma::mma_16816(acc2, af[1], bf[0][2], bf[0][3]);
    dpn::mma::mma_16816(acc, af[2], bf[1][0], bf[1][1]);
    dpn::mma::mma_16816(acc2, af[3], bf[1][2], bf[1][3]);
  }
  for (; ks < ksteps; ++ks) {
    uint32_t af[4], bf[2];
    dpn::mma::ldmatrix_x4(af, a0 + 16 * ks * B2);
    dpn::mma::ldmatrix_x2_trans(bf, b2 + 16 * ks * ld * B2);
    dpn::mma::mma_16816(acc, af, bf[0], bf[1]);
  }
  const int col = W.cols.c0 + 8 * warp + 2 * (lane & 3);
  epilogue(epi, lane >> 2, col, acc[0] + acc2[0], acc[1] + acc2[1]);
  epilogue(epi, (lane >> 2) + 8, col, acc[2] + acc2[2], acc[3] + acc2[3]);
}

// Byte offsets of a row unit's shared memory: the rows x [RG, D] f32, the pushed product rows y
// [RG, D] f32, the product input a [RG, lda] and the FFN's hidden rows h [RG, ldh] bf16, the
// unit's biases and LayerNorm vectors (f32, Vecs), the ring.
struct RowSmem {
  int lda, ldh;
  size_t xs, ys, as, hs, vec, ring, total;
};
__host__ __device__ inline RowSmem row_smem(int D, int HE, int F, int C) {
  RowSmem s;
  s.lda = ld_bf16(D > HE ? D : HE);
  s.ldh = ld_bf16(F);
  s.xs = 0;
  s.ys = s.xs + (size_t)RG * D * sizeof(float);
  s.as = s.ys + (size_t)RG * D * sizeof(float);
  s.hs = s.as + (size_t)RG * s.lda * sizeof(bf16);
  s.vec = s.hs + (size_t)RG * s.ldh * sizeof(bf16);
  const int tail = 3 * HE > 2 * D + C ? 3 * HE : 2 * D + C;
  s.ring = (s.vec + (size_t)(6 * D + F + tail) * sizeof(float) + 127) / 128 * 128;
  s.total = s.ring + (size_t)NS * SLOT;
  return s;
}

// Where a row unit's vectors lie in its Vecs region (floats from its start): bo, ln1s, ln1b, b1,
// b2, ln2s, ln2b, then the next layer's bq, bk, bv or lns, lnb, bproj (stage A: bq, bk, bv only).
struct Vecs {
  int bo, ln1s, ln1b, b1, b2, ln2s, ln2b, tail;
  __device__ Vecs(int D, int F, bool stage_a) {
    bo = 0, ln1s = D, ln1b = 2 * D, b1 = 3 * D, b2 = 3 * D + F, ln2s = 4 * D + F, ln2b = 5 * D + F;
    tail = stage_a ? 0 : 6 * D + F;
  }
};

// Shared memory of an attention unit: the key slices' row maxima [2][WARPS][16] and partial sums
// [WARPS][16] f32, then K and V [up16(L), EP + 8] bf16, whose place the warps' output sums
// [WARPS][16][EP + 1] f32 take after the key loop.
__host__ __device__ inline size_t attn_smem(int L, int EP) {
  const size_t kv = 2 * (size_t)up16(L) * (EP + 8) * sizeof(bf16);
  const size_t sums = (size_t)WARPS * 16 * (EP + 1) * sizeof(float);
  return 3 * WARPS * 16 * sizeof(float) + (kv > sums ? kv : sums);
}

__host__ __device__ inline size_t smem_tc(int L, int D, int H, int E, int F, int C, int EP) {
  const size_t rows = row_smem(D, H * E, F, C).total, attn = attn_smem(L, EP);
  return rows > attn ? rows : attn;
}

// xs[r] = LN(xs[r] + y[r]) (y null: LN(xs[r])) for the RG rows, one warp a row, each lane holding
// four adjacent values of every 128 columns in registers (D up to 128 LN_CHUNKS); with as, T(xs[r])
// into as (row stride lda, zeros up to up16(D)).  Every block of a cluster forms the same rows in
// the same order, so they hold the same bits.
constexpr int LN_CHUNKS = 2;
__device__ __forceinline__ void ln_rows(float* xs, const float* y, int D, const float* s, const float* b, bf16* as,
                                        int lda) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < RG; r += WARPS) {
    float4 v[LN_CHUNKS];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < LN_CHUNKS; ++j) {
      const int d = 4 * lane + 128 * j;
      if (d < D) {
        v[j] = *reinterpret_cast<const float4*>(xs + r * D + d);
        if (y) {
          const float4 t = *reinterpret_cast<const float4*>(y + r * D + d);
          v[j].x += t.x, v[j].y += t.y, v[j].z += t.z, v[j].w += t.w;
        }
        sum += (v[j].x + v[j].y) + (v[j].z + v[j].w);
      }
    }
    const float mean = dpn::warp_sum(sum) / D;
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < LN_CHUNKS; ++j) {
      if (4 * lane + 128 * j < D) {
        const float c0 = v[j].x - mean, c1 = v[j].y - mean, c2 = v[j].z - mean, c3 = v[j].w - mean;
        sq += (c0 * c0 + c1 * c1) + (c2 * c2 + c3 * c3);
      }
    }
    const float inv = 1.0f / sqrtf(dpn::warp_sum(sq) / D + LN_EPS);
#pragma unroll
    for (int j = 0; j < LN_CHUNKS; ++j) {
      const int d = 4 * lane + 128 * j;
      if (d < D) {
        const float4 sv = *reinterpret_cast<const float4*>(s + d), bv = *reinterpret_cast<const float4*>(b + d);
        float4 o;
        o.x = (v[j].x - mean) * inv * sv.x + bv.x;
        o.y = (v[j].y - mean) * inv * sv.y + bv.y;
        o.z = (v[j].z - mean) * inv * sv.z + bv.z;
        o.w = (v[j].w - mean) * inv * sv.w + bv.w;
        *reinterpret_cast<float4*>(xs + r * D + d) = o;
        if (as)
          *reinterpret_cast<uint2*>(as + r * lda + d) = make_uint2(dpn::mma::pack_bf16x2(o.x, o.y),
                                                                   dpn::mma::pack_bf16x2(o.z, o.w));
      }
    }
    if (as && D % 16 && lane < 2)  // the zero columns up to up16(D)
      *reinterpret_cast<uint2*>(as + r * lda + D + 4 * lane) = make_uint2(0u, 0u);
  }
}

// One row group's unit: layer < 0 is stage A (layer 0's q, k, v from x), else stage C of the
// layer (with the next layer's q, k, v, or the final LayerNorm and projection).  Called by every
// block of the cluster for the same row group, with the stage's plan in the ring; with started,
// the ring's first tiles were sent before the stage's grid barrier.  The unit's rows and vectors
// come by bulk copies on rows_bar, whose phase count is rows_phase.
__device__ __forceinline__ void row_unit(const EncoderArgs& a, int layer, int rg, unsigned char* smem, Ring& ring,
                                         bool started,
                         uint64_t* rows_bar, uint32_t& rows_phase) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Plan& plan = *ring.plan;
  const int D = a.D, F = a.F, E = a.E, H = a.H, HE = a.H * a.E, L = a.L;
  const int r0 = rg * RG, nr = min(RG, L - r0);
  const RowSmem S = row_smem(D, HE, F, a.C);
  float* xs = reinterpret_cast<float*>(smem + S.xs);
  float* ys = reinterpret_cast<float*>(smem + S.ys);
  bf16* as = reinterpret_cast<bf16*>(smem + S.as);
  bf16* hs = reinterpret_cast<bf16*>(smem + S.hs);
  float* vec = reinterpret_cast<float*>(smem + S.vec);
  const bool stage_a = layer < 0, proj = layer == a.NL - 1;
  const Vecs V(D, F, stage_a);

  // the unit's rows, x (f32) into xs and, in stage C, o (bf16, row by row) into as; its vectors
  if (threadIdx.x == 0) {
    const float* xin = layer <= 0 ? a.x : a.xres;
    const bf16* o = static_cast<const bf16*>(a.o);
    const size_t at = (size_t)(layer + 1) * HE;  // the next layer's q, k, v biases (stage A: layer 0's)
    const size_t l = stage_a ? 0 : layer;
    const float* const vecs[10][2] = {
        {a.bo + l * D, vec + V.bo}, {a.ln1s + l * D, vec + V.ln1s}, {a.ln1b + l * D, vec + V.ln1b},
        {a.b1 + l * F, vec + V.b1}, {a.b2 + l * D, vec + V.b2}, {a.ln2s + l * D, vec + V.ln2s},
        {a.ln2b + l * D, vec + V.ln2b}, {proj ? a.lns : a.bq + at, vec + V.tail},
        {proj ? a.lnb : a.bk + at, vec + V.tail + (proj ? D : HE)},
        {proj ? a.bproj : a.bv + at, vec + V.tail + 2 * (proj ? D : HE)}};
    const int lens[10] = {D, D, D, F, D, D, D, proj ? D : HE, proj ? D : HE, proj ? a.C : HE};
    uint32_t bytes = (uint32_t)(nr * D * sizeof(float));
    for (int v = stage_a ? 7 : 0; v < 10; ++v) bytes += (uint32_t)(lens[v] * sizeof(float));
    if (!stage_a) bytes += (uint32_t)(nr * HE * sizeof(bf16));
    fence_async();  // the buffers' earlier readers and writers (ordered by a barrier) come first
    bar_expect(rows_bar, bytes);
    bulk_copy(xs, xin + (size_t)r0 * D, (uint32_t)(nr * D * sizeof(float)), rows_bar);
    for (int v = stage_a ? 7 : 0; v < 10; ++v)
      bulk_copy(const_cast<float*>(vecs[v][1]), vecs[v][0], (uint32_t)(lens[v] * sizeof(float)), rows_bar);
    if (!stage_a)
      for (int r = 0; r < nr; ++r)
        bulk_copy(as + r * S.lda, o + (size_t)(r0 + r) * HE, (uint32_t)(HE * sizeof(bf16)), rows_bar);
  }
  if (!started) ring.start();
  // zeros: x's and o's rows past the last token, o's 8 columns up to up16(HE), h's up to up16(F)
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int q = threadIdx.x; q < (RG - nr) * D / 4; q += THREADS) reinterpret_cast<uint4*>(xs + nr * D)[q] = zero;
  if (!stage_a) {
    for (int q = threadIdx.x; q < (RG - nr) * S.lda / 8; q += THREADS) reinterpret_cast<uint4*>(as + nr * S.lda)[q] = zero;
    if (HE % 16)
      for (int r = threadIdx.x; r < nr; r += THREADS) *reinterpret_cast<uint4*>(as + r * S.lda + HE) = zero;
  }
  if (F % 16)
    for (int r = threadIdx.x; r < RG; r += THREADS) *reinterpret_cast<uint4*>(hs + r * S.ldh + F) = zero;
  bar_wait(rows_bar, rows_phase++ & 1);
  __syncthreads();

  if (stage_a) {  // T(x), four columns a thread at a time, zeros up to up16(D)
    const int c4 = up16(D) / 4;
    for (int q = threadIdx.x; q < RG * c4; q += THREADS) {
      const int r = q / c4, c = 4 * (q - r * c4);
      const float4 v = c < D ? *reinterpret_cast<const float4*>(xs + r * D + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<uint2*>(as + r * S.lda + c) =
          make_uint2(dpn::mma::pack_bf16x2(v.x, v.y), dpn::mma::pack_bf16x2(v.z, v.w));
    }
  } else {
    // out-projection, residual and LN1
    product(ring, plan.w[0], as, S.lda, Epi{PUSH_Y, vec + V.bo, ys, D});
    cluster.sync();
    ln_rows(xs, ys, D, vec + V.ln1s, vec + V.ln1b, as, S.lda);
    // FFN
    product(ring, plan.w[1], as, S.lda, Epi{PUSH_H, vec + V.b1, hs, S.ldh, 0, 0, 0, a.gelu});
    cluster.sync();
    product(ring, plan.w[2], hs, S.ldh, Epi{PUSH_Y, vec + V.b2, ys, D});
    cluster.sync();
    // residual and LN2; the block's columns of the rows to the residual stream
    ln_rows(xs, ys, D, vec + V.ln2s, vec + V.ln2b, proj ? nullptr : as, S.lda);
    if (proj) {
      ln_rows(xs, nullptr, D, vec + V.tail, vec + V.tail + D, as, S.lda);
    } else {
      const Cols c = cols_of(D, rank);
      for (int q = threadIdx.x; q < nr * c.nc / 4; q += THREADS) {
        const int r = q / (c.nc / 4), col = c.c0 + 4 * (q - r * (c.nc / 4));
        *reinterpret_cast<float4*>(a.xres + (size_t)(r0 + r) * D + col) = *reinterpret_cast<const float4*>(xs + r * D + col);
      }
    }
  }
  if (proj) {
    product(ring, plan.w[3], as, S.lda, Epi{OUT, vec + V.tail + 2 * D, a.out, a.C, 0, r0, nr});
  } else {
    for (int m = 0; m < 3; ++m)
      product(ring, plan.w[plan.n - 3 + m], as, S.lda, Epi{QKV, vec + V.tail + m * HE, a.qkv, 0, m, r0, nr, 0, H, L, E});
  }
}

// Attention of 32 query rows q0 .. of head h over all L keys: attention.cu's single-tile body
// (FLASH = false) with K and V resident, warp (rw, kw) taking rows q0 + 16 rw .. and keys
// 64 kw .. 64 kw + 63 of every 256-key block; E zero-padded to EP.  To o [L, H E] in bf16.
template <int EP>
__device__ void attention_unit_tc(const EncoderArgs& a, int h, int q0, unsigned char* smem) {
  using namespace dpn::attn;
  constexpr int LD = EP + 8, KS = EP / 16, ET = EP / 8, R = 16, CS = EP + 1, CH = EP / 8;
  const int L = a.L, E = a.E, HE = a.H * a.E;
  float* red = reinterpret_cast<float*>(smem);  // [2][WARPS][R]
  float* lsum = red + 2 * WARPS * R;            // [WARPS][R]
  unsigned char* uni = smem + 3 * WARPS * R * sizeof(float);
  bf16* Ks = reinterpret_cast<bf16*>(uni);
  const int rows = up16(L);
  bf16* Vs = Ks + (size_t)rows * LD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rw = warp / KW, kw = warp - rw * KW;
  const int row0 = q0 + 16 * rw;
  const bool active = row0 < L;
  const bf16* qkv = static_cast<const bf16*>(a.qkv);
  const bf16* qh = qkv + (size_t)h * L * E;
  const bf16* kh = qkv + ((size_t)a.H + h) * L * E;
  const bf16* vh = qkv + ((size_t)2 * a.H + h) * L * E;

  // K and V of all L keys; zeros past L (up to a multiple of 16) and past E
  for (int i = threadIdx.x; i < rows * CH; i += THREADS) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const bool valid = r < L && c < E;
    const size_t src = valid ? (size_t)r * E + c : 0;
    const uint32_t off = (uint32_t)(r * LD + c) * sizeof(bf16);
    cp_async16(smem_addr(Ks) + off, kh + src, valid);
    cp_async16(smem_addr(Vs) + off, vh + src, valid);
  }
  dpn::mma::cp_async_commit();
  // the warp's Q fragments (rows past L and columns past E are zeros)
  uint32_t qa[1][KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + (i & 1) * 8, c = ks * 16 + t2 + (i >> 1) * 8;
      qa[0][ks][i] = r < L && c < E ? __ldcg(reinterpret_cast<const unsigned int*>(qh + (size_t)r * E + c)) : 0u;
    }
  float m[1][2], l[1][2], nm[1][2], rl[1][2];
  float acc[1][ET][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[0][r] = -INFINITY;
    l[0][r] = nm[0][r] = rl[0][r] = 0.f;
  }
#pragma unroll
  for (int n8 = 0; n8 < ET; ++n8)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[0][n8][i] = 0.f;
  dpn::mma::cp_async_wait<0>();

  const int n_kb = (L + BK - 1) / BK;
  const float sl2 = a.scale * LOG2E;  // exp(x scale) = 2^(x sl2)
  for (int t = 0; t < 2 * n_kb; ++t) {  // two passes over the keys
    __syncthreads();  // K and V are in; the maxima slot (t & 1) and lsum are free / written
    const int kb = t % n_kb;
    const int n = min(SLICE, max(0, min(BK, L - kb * BK) - kw * SLICE));  // keys in the slice
    const size_t slice = ((size_t)kb * BK + kw * SLICE) * LD;
    const bool stats = t < n_kb;
    if (t == n_kb && active) {  // the second pass begins: the row group's sums
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lt = 0.f;
#pragma unroll
        for (int w = 0; w < KW; ++w) lt += lsum[(rw * KW + w) * R + g + 8 * r];
        rl[0][r] = 1.f / lt;
        nm[0][r] = -m[0][r] * sl2;
      }
    }
    float s[1][NT8][4], mx[1][2];
    if (active) {
      score_slice<EP, 1>(s, qa, Ks + slice, n, lane);
      if (stats) {
        slice_max<1>(s, mx);
        if ((lane & 3) == 0) {
          red[((t & 1) * WARPS + warp) * R + g] = mx[0][0];
          red[((t & 1) * WARPS + warp) * R + g + 8] = mx[0][1];
        }
      }
    }
    if (stats) __syncthreads();  // the slices' maxima are visible
    if (!active) continue;
    if (stats) {
      float alpha[1][2], sum[1][2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mn = m[0][r];
#pragma unroll
        for (int w = 0; w < KW; ++w) mn = fmaxf(mn, red[((t & 1) * WARPS + rw * KW + w) * R + g + 8 * r]);
        alpha[0][r] = dpn::mma::ex2((m[0][r] - mn) * sl2);  // mn is finite: every key block has a key
        nm[0][r] = -mn * sl2;
        m[0][r] = mn;
        sum[0][r] = 0.f;
      }
      if (n == SLICE)
        exp_slice<1, true, false>(s, sl2, nm, rl, n, sum);
      else
        exp_slice<1, false, false>(s, sl2, nm, rl, n, sum);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[0][r] = alpha[0][r] * l[0][r] + dpn::mma::quad_sum(sum[0][r]);
      if (t == n_kb - 1 && (lane & 3) == 0) {
        lsum[warp * R + g] = l[0][0];
        lsum[warp * R + g + 8] = l[0][1];
      }
      continue;
    }
    float unused[1][2] = {};  // a = exp(s - m) / l with the final m and l
    if (n == SLICE)
      exp_slice<1, true, true>(s, sl2, nm, rl, n, unused);
    else
      exp_slice<1, false, true>(s, sl2, nm, rl, n, unused);
    pv_slice<EP, 1>(acc, s, Vs + slice, n, lane);
  }

  __syncthreads();  // K and V are no longer read: their place takes the warps' sums
  float* sums = reinterpret_cast<float*>(uni);  // [WARPS][R][CS]
  if (active) {
    float* s0 = sums + (warp * R + g) * CS;
    float* s1 = s0 + 8 * CS;
#pragma unroll
    for (int n8 = 0; n8 < ET; ++n8) {
      s0[n8 * 8 + t2] = acc[0][n8][0];
      s0[n8 * 8 + t2 + 1] = acc[0][n8][1];
      s1[n8 * 8 + t2] = acc[0][n8][2];
      s1[n8 * 8 + t2 + 1] = acc[0][n8][3];
    }
  }
  __syncthreads();
  bf16* o = static_cast<bf16*>(a.o);
  for (int i = threadIdx.x; i < 2 * R * (EP / 2); i += THREADS) {  // two columns a thread
    const int c = 2 * (i % (EP / 2)), rr = i / (EP / 2), rg = rr / R, row = rr - rg * R;
    const int token = q0 + rg * R + row;
    if (token >= L || c >= E) continue;
    float x0 = 0.f, x1 = 0.f;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float* sw = sums + ((rg * KW + w) * R + row) * CS;
      x0 += sw[c];
      x1 += sw[c + 1];
    }
    *reinterpret_cast<uint32_t*>(o + (size_t)token * HE + h * E + c) = dpn::mma::pack_bf16x2(x0, x1);
  }
}

template <int EP>
__global__ void __launch_bounds__(THREADS, 1) encoder_tc(const EncoderArgs a) {
  extern __shared__ __align__(128) unsigned char smem_tc_raw[];
  __shared__ __align__(8) uint64_t bars[NS + 1];  // the ring's slots, then the rows' mbarrier
  unsigned char* smem = smem_tc_raw;
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int n_groups = (a.L + RG - 1) / RG, n_q = (a.L + QR - 1) / QR;
  const int cid = blockIdx.x / CL, n_clusters = gridDim.x / CL;
  const RowSmem S = row_smem(a.D, a.H * a.E, a.F, a.C);
  if (threadIdx.x == 0) {
    for (int i = 0; i <= NS; ++i) bar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // The ring's first tiles of a stage C go out before the stage's grid barrier where the attention
  // stage's shared memory ends below the ring's (at flagship width: 48 KB against 61 KB).
  const bool early = attn_smem(a.L, EP) <= S.ring && cid < n_groups && DPN_ENCODER_SKIP != 3 && DPN_ENCODER_SKIP != 4;
  Plan plan;
  long long off[6];
  Plan::fetch(a, -1, rank, off);
  plan.make(a, -1, rank, off);
  Ring ring{smem + S.ring, bars, &plan, 0, 0u, 0u};
  uint32_t rows_phase = 0;
  bool started = false;
  // Phases: 0 stage A; 2 l + 1 the attention of layer l; 2 l + 2 stage C of layer l.  One loop, so
  // that the code of each stage is in the kernel once (the instruction cache holds less of it twice).
  for (int phase = 0; phase <= 2 * a.NL; ++phase) {
    if (phase & 1) {
      const int layer = (phase - 1) / 2;
      Plan::fetch(a, layer, rank, off);  // stage C's tiles, ahead of the attention
      for (int u = blockIdx.x; u < a.H * n_q; u += gridDim.x) {
        __syncthreads();  // the previous unit's readers of shared memory are done
        if (DPN_ENCODER_SKIP != 2 && DPN_ENCODER_SKIP != 4) attention_unit_tc<EP>(a, u / n_q, (u % n_q) * QR, smem);
      }
      plan.make(a, layer, rank, off);
      started = early;
      if (started) {
        __syncthreads();  // every warp is done with the slots
        ring.start();
      }
    } else {
      const int layer = phase / 2 - 1;  // -1: stage A
      const bool skip = layer < 0 ? DPN_ENCODER_SKIP == 1 || DPN_ENCODER_SKIP == 4
                                  : DPN_ENCODER_SKIP == 3 || DPN_ENCODER_SKIP == 4;
      // a cluster's later units wait until its blocks are done with the buffers of the one before
      for (int u = cid; u < n_groups; u += n_clusters) {
        if (u != cid) cluster.sync();
        if (!skip) row_unit(a, layer, u, smem, ring, started && u == cid, bars + NS, rows_phase);
      }
    }
    if (phase < 2 * a.NL) grid.sync();
  }
}

// The padded head width the tensor-core body takes at these sizes, or 0 (the CUDA-core body):
// E up to 64, D, F, C and H E up to MAX_WIDTH, shared memory within smem_max.
int head_width(int L, int D, int H, int E, int F, int C, int smem_max) {
  const int EP = E <= 16 ? 16 : E <= 32 ? 32 : E <= 64 ? 64 : 0;
  const int widest = std::max(std::max(D, F), std::max(C, H * E));
  if (EP == 0 || widest > MAX_WIDTH) return 0;
  return smem_tc(L, D, H, E, F, C, EP) <= (size_t)smem_max ? EP : 0;
}

template <int EP>
int launch(const EncoderArgs& a, cudaStream_t stream) {
  const size_t smem = smem_tc(a.L, a.D, a.H, a.E, a.F, a.C, EP);
  cudaError_t err = cudaFuncSetAttribute(encoder_tc<EP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeCooperative;
  attrs[0].val.cooperative = 1;
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = CL;
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  int max_clusters = 0;
  if ((err = cudaOccupancyMaxActiveClusters(&max_clusters, encoder_tc<EP>, &cfg)) != cudaSuccess) return (int)err;
  if (max_clusters < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // a cluster a row group, or enough blocks for the attention units where those are more
  const int n_groups = (a.L + RG - 1) / RG, n_units = a.H * ((a.L + QR - 1) / QR);
  const int clusters = std::min(std::max(n_groups, (n_units + CL - 1) / CL), max_clusters);
  cfg.gridDim = dim3(clusters * CL);
  const EncoderArgs args = a;
  if ((err = cudaLaunchKernelEx(&cfg, encoder_tc<EP>, args)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tce


// The tensor-core body's padded head width for this launch, 0 for the CUDA-core body.
int route(int is_bf16, int L, int D, int H, int E, int F, int C) {
  int dev = 0, smem_max = 0;
  if (!is_bf16 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 0;
  return tce::head_width(L, D, H, E, F, C, smem_max);
}

}  // namespace

extern "C" {

// Shared memory one block needs at these sizes, on the body dpn_encoder takes (the wrapper raises
// above a block's limit).
long long dpn_encoder_shared_bytes(int is_bf16, int L, int D, int H, int E, int F, int C) {
  const int ep = route(is_bf16, L, D, H, E, F, C);
  return (long long)(ep ? tce::smem_tc(L, D, H, E, F, C, ep) : smem_bytes(L, D, H, E, F, C));
}

// The body dpn_encoder takes at these sizes: the tensor-core body's padded head width (16, 32 or
// 64), or 0 for the CUDA-core body (float; bf16 past the tensor-core body's limits).
int dpn_encoder_route(int is_bf16, int L, int D, int H, int E, int F, int C) { return route(is_bf16, L, D, H, E, F, C); }

// is_bf16: 1 for __nv_bfloat16 matrices (wq, wk, wv, wo, w1, w2, wproj), 0 for float;
// every other array float.  The scratch arrays need no initial values; out [L, C] is
// written in full.  Returns the launch's error code (0 on success).
int dpn_encoder(int is_bf16, const EncoderArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch<float>(*args, s);
  const EncoderArgs& a = *args;
  switch (route(is_bf16, a.L, a.D, a.H, a.E, a.F, a.C)) {
    case 16: return tce::launch<16>(a, s);
    case 32: return tce::launch<32>(a, s);
    case 64: return tce::launch<64>(a, s);
    default: return launch<__nv_bfloat16>(a, s);
  }
}

}  // extern "C"
