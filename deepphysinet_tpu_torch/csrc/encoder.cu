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
// by grid-wide barriers: a cooperative launch (cudaLaunchCooperativeKernel, every
// block resident, cooperative_groups' grid sync).  Per layer three stages, three
// barriers (the last layer's final barrier is not needed):
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
// The activations live in device-memory scratch that the wrapper allocates (at
// 288 x 256 f32 per buffer they stay in L2); a block reads what other blocks wrote
// with __ldcg (L2, not the SM's own L1, which is not coherent across SMs), in 16-byte
// loads, several a thread in flight before the first is used.  The products run on the CUDA cores (FMA): each thread owns output columns of
// the unit's rows and reads their weights straight from L2, several rows ahead.  Correct
// and simple first: tensor cores and a finer split of stage 3 are later work.

#include <cooperative_groups.h>

#include <algorithm>

#include "decode_common.cuh"

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

}  // namespace

extern "C" {

// Shared memory one block needs at these sizes (the wrapper raises above a block's limit).
long long dpn_encoder_shared_bytes(int L, int D, int H, int E, int F, int C) {
  return (long long)smem_bytes(L, D, H, E, F, C);
}

// is_bf16: 1 for __nv_bfloat16 matrices (wq, wk, wv, wo, w1, w2, wproj), 0 for float;
// every other array float.  The scratch arrays need no initial values; out [L, C] is
// written in full.  Returns the launch's error code (0 on success).
int dpn_encoder(int is_bf16, const EncoderArgs* args, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(*args, s) : launch<float>(*args, s);
}

}  // extern "C"
