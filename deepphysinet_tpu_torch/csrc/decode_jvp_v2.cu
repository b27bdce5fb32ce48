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
// the collapsed v4 decode.  This first version runs the products on the CUDA cores (FMA).
// Design, as for the v4 forward: a block owns NB = 64 points and ONE variable, weights
// stream through shared memory in KT-row tiles (decode_common.cuh's block_gemm), and the
// relu masks are bits of the thread's register tile.  The uncollapsed chain needs four
// row sets of [NB, HID] (p, c, relu r and one tangent's), 256 KB in f32, over a block's
// 227 KB; every one of them is the operand of exactly one product, so a single [NB, HID]
// buffer of T holds whichever is next, and shared memory is 96 KB in bf16, 192 KB in f32.

#include "decode_common.cuh"
#include "decode_pe.cuh"

namespace {

using namespace dpn;

constexpr int TM = 8;            // accumulator rows per thread
constexpr int NB = WARPS * TM;   // points per block

// The decode weights of all variables, as the wrapper lays them out: the matrices and wo in
// T (w1 [V, in_ch, HID], w1c [V, 3, ch, HID] or null, w2 / f1 / f2 [V, HID, HID],
// wd [V, in_ch, HID], wo [V, HID]), the biases f32 ([V, HID]; bo [V]).
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
};

template <typename T> __device__ __forceinline__ const T* mat(const void* w, size_t offset) {
  return static_cast<const T*>(w) + offset;
}

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
  if (is_bf16) return launch<__nv_bfloat16, PE>(in, w, primal, tang, n, in_ch, n_vars, s);
  return launch<float, PE>(in, w, primal, tang, n, in_ch, n_vars, s);
}

}  // namespace

extern "C" {

// Hidden width the kernels were built for; shared memory one block needs at this input width.
int dpn_decode_jvp_v2_hid() { return dpn::HID; }
int dpn_decode_jvp_v2_shared_bytes(int is_bf16, int in_ch) {
  return (int)(is_bf16 ? shared_bytes<__nv_bfloat16>(in_ch) : shared_bytes<float>(in_ch));
}

// v2.  is_bf16: 1 for __nv_bfloat16 inputs, 0 for float.  pe and cd [n, in_ch], dpe
// [3, n, in_ch / 3] of T, ref [n, n_vars] f32; primal [n, n_vars] and tang [3, n, n_vars]
// are written in full.  flag must be 0.  Returns cudaGetLastError() after the launch.
int dpn_decode_jvp_v2(int is_bf16, const void* pe, const void* dpe, const void* cd,
                      const float* ref, const void* w1, const void* w1c, const float* b1,
                      const void* w2, const float* b2, const void* wd, const float* bd,
                      const float* fh, const void* f1, const float* g1, const void* f2,
                      const float* g2, const void* wo, const float* bo, float* primal,
                      float* tang, int64_t n, int in_ch, int n_vars, int flag, void* stream) {
  if (flag != 0) return (int)cudaErrorInvalidValue;
  const PointInputs in{pe, dpe, cd, ref, nullptr, nullptr, nullptr, nullptr, nullptr};
  const V2Weights w{w1, w1c, b1, w2, b2, wd, bd, fh, f1, g1, f2, g2, wo, bo};
  return dispatch<false>(is_bf16, in, w, primal, tang, n, in_ch, n_vars, stream);
}

// v3.  coords [n, 3] and cdata [n, 6] f32 (cdata is also the reference value), scales [3],
// fb [in_ch / 6], fb2 [in_ch / 12] f32; w1 and wd with their rows channel-major; n_vars is 6.
int dpn_decode_jvp_v3(int is_bf16, const float* coords, const float* cdata,
                      const float* scales, const float* fb, const float* fb2, const void* w1,
                      const float* b1, const void* w2, const float* b2, const void* wd,
                      const float* bd, const float* fh, const void* f1, const float* g1,
                      const void* f2, const float* g2, const void* wo, const float* bo,
                      float* primal, float* tang, int64_t n, int in_ch, int n_vars, int flag,
                      void* stream) {
  if (flag != 0) return (int)cudaErrorInvalidValue;
  const PointInputs in{nullptr, nullptr, nullptr, cdata, coords, cdata, scales, fb, fb2};
  const V2Weights w{w1, nullptr, b1, w2, b2, wd, bd, fh, f1, g1, f2, g2, wo, bo};
  return dispatch<true>(is_bf16, in, w, primal, tang, n, in_ch, n_vars, stream);
}

}  // extern "C"
