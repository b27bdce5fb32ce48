// Multi-head softmax attention for Hopper (sm_90a): the single-tile kernel and the
// flash kernel of deepphysinet_tpu/ops/attention.py.
//
// Replaces two TPU kernels:
//
// * _attn_kernel / _attention_pallas (:48-92), FLASH = false: exact softmax over all
//   L keys, a = T(e / sum(e)), out = T(sum a v).  On the TPU one (batch, head) tile
//   holds the whole [L, L] score matrix in VMEM.  Here the kernel takes two passes
//   over the keys: the first keeps each row's running max and sum (the sum rescaled
//   when the max grows), the second recomputes the scores, normalises them with the
//   final max and sum and adds a . v.  Any L runs.
// * _flash_kernel / _attention_flash (:95-167), FLASH = true: online softmax.  The
//   TPU grid's sequential key axis becomes a loop inside the block.  Per key block
//   p = exp(s - m_cur), with m_cur the running max after the WHOLE block, is rounded
//   to T for the product while l sums the unrounded p, as on the TPU; so the key
//   block is the TPU kernel's block_k, 256, and its max is taken over all 256 keys
//   before any p of it is formed.
//
// Rounding: q, k, v, out in T (bf16 or float); products of two T values summed in
// f32 (exact products for bf16); scores (q . k) * scale, softmax and the output sums
// in f32; the divisions are IEEE.  float: exp is expf, as in the plain versions.  bf16:
// exp(x scale - m) is 2^(x sl2 - m sl2) on the special-function unit (ex2.approx, log2 e
// folded into sl2) and the second pass multiplies by 1 / l.  On an H100 at 287 tokens
// (chip_smoke.py) about 0.04% (single-tile) and 0.07% (flash) of the bf16 outputs differ
// from the plain version's, each by one step.
//
// What bounds it, per (batch, head): 4 L^2 E flops, L^2 exponentials and 8 L E bytes
// (bf16).  At E = 32 an exponential weighs more than the 128 flops of its score: the
// special-function unit issues 16 a clock per SM against about 4,096 bf16 tensor-core
// flops, so at long L the exponentials bound it on paper; at the flagship's L = 287
// latency and how many SMs are busy do.
//
// bf16 design (attention_bf16): both products on the tensor cores (mma.sync m16n8k16,
// mma_bf16.cuh).  Four warps share a row group's keys, each taking a 64-key slice of
// every 256-key block; a warp holds one or two m16 row tiles, whose Q fragments stay in
// registers for the whole key loop, and a block one or more row groups (chosen at launch
// from the size: enough blocks to cover the SMs, enough rows to share each K/V tile).
// K and V tiles of 256 keys stay bf16 in shared memory (rows padded to E + 8 elements, so
// ldmatrix hits no bank conflicts), filled by cp.async with the next tile's copy in
// flight during the current tile's products; rows past L are zero-filled (a NaN pattern
// in V would survive p = 0).  The scores of a slice stay in registers: row maxima by
// quad shuffles, exchanged between the four warps through shared memory so that p is
// formed with the max over the whole 256-key block, then p rounded to bf16 in pairs
// straight into the A fragment of P . V (ldmatrix.trans on key-major V); the output
// sums stay in registers and the four warps' sums are added at the end.  When a head's
// K and V take no more room than the ring (L <= 512), they are loaded once, and the
// single-tile kernel's two passes read device memory once.
//
// float design (attention_f32, the parity configuration, no TF32): products on the
// CUDA cores.  A block of 256 threads owns 64 query rows; its q rows, one key block
// of k and v and the [64, 256] f32 score tile live in shared memory (rows padded by
// one float); each thread holds a 4 x 16 tile of the scores and a 4 x E/16 tile of
// the output.

#include "attention_tc.cuh"
#include "decode_common.cuh"

namespace {

namespace attn = dpn::attn;
constexpr int MAX_DEVICES = 64;

// The device's SM count and opt-in shared memory per block, queried once per device.
cudaError_t device_limits(int& sms, int& smem_max) {
  static int cached[MAX_DEVICES][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= MAX_DEVICES) return err == cudaSuccess ? cudaErrorInvalidDevice : err;
  if (!cached[dev][0]) {
    err = cudaDeviceGetAttribute(&cached[dev][0], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&cached[dev][1], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) {
      cached[dev][0] = 0;
      return err;
    }
  }
  sms = cached[dev][0];
  smem_max = cached[dev][1];
  return cudaSuccess;
}

// ---- bf16: tensor cores ------------------------------------------------------------

using attn::BK;
using attn::KW;
using attn::LOG2E;
using attn::NT8;
using attn::SLICE;
using attn::exp_slice;
using attn::pv_slice;
using attn::score_slice;
using attn::slice_max;

// Shared memory of a block of W warps of R = 16 MT rows each: the row maxima of the key
// slices [2][W][R] f32 and the single-tile kernel's partial sums [W][R] f32, then K and V
// (each `rows` rows of E + 8 bf16; resident: rows = L rounded up to 16, key block kb at
// row 256 kb, loaded once; else rows = 512, a ring of two 256-key tiles), whose place the
// warps' output sums and l, [W][R][E + 1] f32, take after the key loop.
__host__ __device__ constexpr size_t kv_offset(int warps, int mt) {
  return (size_t)3 * warps * 16 * mt * sizeof(float);
}

template <int E> constexpr size_t smem_bytes(int rows, int warps, int mt) {
  const size_t kv = (size_t)2 * rows * (E + 8) * sizeof(__nv_bfloat16);
  const size_t sums = (size_t)warps * 16 * mt * (E + 1) * sizeof(float);
  return kv_offset(warps, mt) + (kv > sums ? kv : sums);
}

// Grid (ceil(L / (16 MT RW)), B * H), blockDim.x = 32 RW KW.  Warp (rw, kw) owns the
// 16 MT query rows from 16 MT (blockIdx.x RW + rw) and keys 64 kw .. 64 kw + 63 of every
// 256-key block.  The KW warps of a row group exchange their row maxima through shared
// memory, so that each forms p with the running max over the WHOLE key block, and add
// their output sums (and the flash kernel's l) at the end.
template <int E, bool FLASH, int MT>
__global__ void __launch_bounds__(MT == 1 ? 512 : 256)
attention_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int L, int H,
               float scale, int resident) {
  constexpr int LD = E + 8, KS = E / 16, ET = E / 8, CH = E / 8;  // CH: 16-byte chunks a row
  constexpr int R = 16 * MT, CS = E + 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = blockDim.x >> 5, RW = W / KW;
  float* red = reinterpret_cast<float*>(smem_raw);  // [2][W][R]
  float* lsum = red + 2 * W * R;                     // [W][R]
  unsigned char* uni = smem_raw + kv_offset(W, MT);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(uni);
  const int rows = resident ? (L + 15) / 16 * 16 : 2 * BK;
  __nv_bfloat16* Vs = Ks + (size_t)rows * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t2 = 2 * (lane & 3);
  const int rw = warp / KW, kw = warp - rw * KW;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int row0 = (blockIdx.x * RW + rw) * R;
  const bool active = row0 < L;  // a warp past the last row still copies and synchronises
  const size_t rs = (size_t)H * E;  // elements between tokens
  const size_t head = ((size_t)b * L * H + h) * E;
  const __nv_bfloat16* kh = k + head;
  const __nv_bfloat16* vh = v + head;
  const int n_kb = (L + BK - 1) / BK;
  const int steps = FLASH ? n_kb : 2 * n_kb;  // the single-tile kernel walks the keys twice
  const float sl2 = scale * LOG2E;            // exp(x scale) = 2^(x sl2)

  // Step t's key block into its buffer: K always, V unless this is the single-tile
  // kernel's first pass over a ring.  Rows from the block's end up to a multiple of 16
  // are zeros.
  auto load = [&](int t) {
    const int kb = t % n_kb, k0 = kb * BK;
    const int n = min(BK, (L - k0 + 15) / 16 * 16);
    const int buf = resident ? kb : (t & 1);
    const bool with_v = FLASH || resident || t >= n_kb;
    const uint32_t kd = dpn::mma::smem_addr(Ks + (size_t)buf * BK * LD);
    const uint32_t vd = dpn::mma::smem_addr(Vs + (size_t)buf * BK * LD);
    for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
      const int r = i / CH, c = (i - r * CH) * 8, s = k0 + r;
      const bool valid = s < L;
      const size_t src = (valid ? (size_t)s * rs : 0) + c;
      const uint32_t off = (uint32_t)(r * LD + c) * sizeof(__nv_bfloat16);
      dpn::mma::cp_async16(kd + off, kh + src, valid);
      if (with_v) dpn::mma::cp_async16(vd + off, vh + src, valid);
    }
  };

  load(0);
  dpn::mma::cp_async_commit();

  // the warp's Q fragments (rows past L are zeros; their outputs are not stored)
  uint32_t qa[MT][KS][4];
  {
    const __nv_bfloat16* qh = q + head;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = row0 + 16 * mt + g + (i & 1) * 8, c = ks * 16 + t2 + (i >> 1) * 8;
          qa[mt][ks][i] = r < L ? *reinterpret_cast<const uint32_t*>(qh + (size_t)r * rs + c) : 0u;
        }
  }

  // per row (row tile mt, rows g and g + 8): m, the running max of the unscaled scores
  // over the row group's keys so far; l, this warp's sum of p relative to it; nm = -m sl2;
  // rl = 1 / (the row group's sum), the single-tile kernel's second pass
  float m[MT][2], l[MT][2], nm[MT][2], rl[MT][2];
  float acc[MT][ET][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mt][r] = -INFINITY;
      l[mt][r] = nm[mt][r] = rl[mt][r] = 0.f;
    }
#pragma unroll
    for (int n8 = 0; n8 < ET; ++n8)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][n8][i] = 0.f;
  }

  for (int t = 0; t < steps; ++t) {
    dpn::mma::cp_async_wait<0>();
    __syncthreads();  // step t's tile is visible, and every warp is done with step t - 1's
    if (t + 1 < steps && (!resident || t + 1 < n_kb)) load(t + 1);
    dpn::mma::cp_async_commit();

    const int kb = t % n_kb;
    const int n = min(SLICE, max(0, min(BK, L - kb * BK) - kw * SLICE));  // keys in the slice
    const size_t slice = ((size_t)(resident ? kb : (t & 1)) * BK + kw * SLICE) * LD;
    const bool stats = FLASH || t < n_kb;  // the single-tile kernel's first pass, or flash
    if (!FLASH && t == n_kb && active) {   // its second pass begins: the row group's sums
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float lt = 0.f;
#pragma unroll
          for (int w = 0; w < KW; ++w) lt += lsum[(rw * KW + w) * R + 16 * mt + g + 8 * r];
          rl[mt][r] = 1.f / lt;
          nm[mt][r] = -m[mt][r] * sl2;
        }
    }
    float s[MT][NT8][4], mx[MT][2];
    if (active) {
      score_slice<E, MT>(s, qa, Ks + slice, n, lane);
      if (stats) {
        slice_max<MT>(s, mx);
        if ((lane & 3) == 0)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            red[((t & 1) * W + warp) * R + 16 * mt + g] = mx[mt][0];
            red[((t & 1) * W + warp) * R + 16 * mt + g + 8] = mx[mt][1];
          }
      }
    }
    if (stats) __syncthreads();  // the slices' maxima are visible
    if (!active) continue;

    if (stats) {
      float alpha[MT][2], sum[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mn = m[mt][r];
#pragma unroll
          for (int w = 0; w < KW; ++w)
            mn = fmaxf(mn, red[((t & 1) * W + rw * KW + w) * R + 16 * mt + g + 8 * r]);
          // mn is finite: every key block has a key
          alpha[mt][r] = dpn::mma::ex2((m[mt][r] - mn) * sl2);
          nm[mt][r] = -mn * sl2;
          m[mt][r] = mn;
          sum[mt][r] = 0.f;
        }
      if (n == SLICE)
        exp_slice<MT, true, false>(s, sl2, nm, rl, n, sum);
      else
        exp_slice<MT, false, false>(s, sl2, nm, rl, n, sum);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) l[mt][r] = alpha[mt][r] * l[mt][r] + dpn::mma::quad_sum(sum[mt][r]);
      if (!FLASH) {
        if (t == n_kb - 1 && (lane & 3) == 0)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            lsum[warp * R + 16 * mt + g] = l[mt][0];
            lsum[warp * R + 16 * mt + g + 8] = l[mt][1];
          }
        continue;
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n8 = 0; n8 < ET; ++n8) {
          acc[mt][n8][0] *= alpha[mt][0];
          acc[mt][n8][1] *= alpha[mt][0];
          acc[mt][n8][2] *= alpha[mt][1];
          acc[mt][n8][3] *= alpha[mt][1];
        }
    } else {  // a = exp(s - m) / l with the final m and l
      float unused[MT][2] = {};
      if (n == SLICE)
        exp_slice<MT, true, true>(s, sl2, nm, rl, n, unused);
      else
        exp_slice<MT, false, true>(s, sl2, nm, rl, n, unused);
    }
    pv_slice<E, MT>(acc, s, Vs + slice, n, lane);
  }

  // the row group's output: the sum of its warps' sums (flash: over the sum of their l)
  dpn::mma::cp_async_wait<0>();
  __syncthreads();  // K and V are no longer read: their place takes the warps' sums
  float* sums = reinterpret_cast<float*>(uni);  // [W][R][CS]: E output sums, then l
  if (active) {
    float* sw = sums + warp * R * CS;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float* s0 = sw + (16 * mt + g) * CS;
      float* s1 = s0 + 8 * CS;
#pragma unroll
      for (int n8 = 0; n8 < ET; ++n8) {
        s0[n8 * 8 + t2] = acc[mt][n8][0];
        s0[n8 * 8 + t2 + 1] = acc[mt][n8][1];
        s1[n8 * 8 + t2] = acc[mt][n8][2];
        s1[n8 * 8 + t2 + 1] = acc[mt][n8][3];
      }
      if ((lane & 3) == 0) {
        s0[E] = l[mt][0];
        s1[E] = l[mt][1];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < RW * R * (E / 2); i += blockDim.x) {  // two columns a thread
    const int c = 2 * (i % (E / 2)), rr = i / (E / 2), rg = rr / R, row = rr - rg * R;
    const int token = (blockIdx.x * RW + rg) * R + row;
    if (token >= L) continue;
    float x0 = 0.f, x1 = 0.f, lt = 0.f;
#pragma unroll
    for (int w = 0; w < KW; ++w) {
      const float* sw = sums + ((rg * KW + w) * R + row) * CS;
      x0 += sw[c];
      x1 += sw[c + 1];
      lt += sw[E];
    }
    if (FLASH) {
      x0 /= lt;
      x1 /= lt;
    }
    *reinterpret_cast<uint32_t*>(out + head + (size_t)token * rs + c) = dpn::mma::pack_bf16x2(x0, x1);
  }
}

// A launch's shape: RW row groups of KW warps a block, MT row tiles a warp, blocks along
// the query rows, dynamic shared memory, and whether all of a head's K and V stay in it.
struct Plan {
  int rw, mt, row_blocks, resident;
  size_t smem;
};

// Fill the plan's row blocks, residency and shared memory for its rw and mt.
template <int E> cudaError_t shape_plan(int L, Plan& p) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(sms, smem_max);
  if (err != cudaSuccess) return err;
  // whole residency only when it takes no more room than the ring
  p.resident = (L + BK - 1) / BK <= 2;
  p.smem = smem_bytes<E>(p.resident ? (L + 15) / 16 * 16 : 2 * BK, p.rw * KW, p.mt);
  p.row_blocks = (L + 16 * p.mt * p.rw - 1) / (16 * p.mt * p.rw);
  return p.smem <= (size_t)smem_max ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int E> cudaError_t plan_bf16(int B, int L, int H, Plan& p) {
  int sms = 0, smem_max = 0;
  cudaError_t err = device_limits(sms, smem_max);
  if (err != cudaSuccess) return err;
  // 16-row tiles over the card: where they are few, a block takes one (four warps, one
  // per key slice); where they are many, more rows share each K/V tile, whose reads from
  // L2 otherwise bound the kernel.  Measured on an H100 (PERF.md): at 4,096 tokens
  // and 8 heads, 32 rows a block at E <= 32 (two row tiles a warp), 64 at E = 64, whose
  // 147 KB ring leaves room for one block an SM.
  const long long tiles = (long long)((L + 15) / 16) * B * H;
  if (tiles < 2LL * sms) {
    p.rw = 1;
    p.mt = 1;
  } else if (tiles < 4LL * sms) {
    p.rw = 4;
    p.mt = 1;
  } else {
    p.rw = E == 64 ? 2 : 1;
    p.mt = 2;
  }
  return shape_plan<E>(L, p);
}

template <int E, bool FLASH, int MT>
int launch_mt(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
              float scale, const Plan& p, cudaStream_t stream) {
  static size_t smem_set[MAX_DEVICES];  // the dynamic shared memory the kernel may take
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && p.smem > smem_set[dev]) {
    err = cudaFuncSetAttribute(attention_bf16<E, FLASH, MT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err == cudaSuccess) smem_set[dev] = p.smem;
  }
  if (err != cudaSuccess) return (int)err;
  attention_bf16<E, FLASH, MT><<<dim3(p.row_blocks, B * H), 32 * p.rw * KW, p.smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), L, H, scale,
      p.resident);
  return (int)cudaGetLastError();
}

template <int E, bool FLASH>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
                float scale, const Plan& p, cudaStream_t stream) {
  switch (p.mt) {
    case 1: return launch_mt<E, FLASH, 1>(q, k, v, out, B, L, H, scale, p, stream);
    case 2: return launch_mt<E, FLASH, 2>(q, k, v, out, B, L, H, scale, p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- float: CUDA cores --------------------------------------------------------------

constexpr int BQ = 64;       // query rows per block
constexpr int THREADS = 256; // 16 x 16 thread grid over the score tile
constexpr int SK = BK + 1;   // row stride of the score tile

template <int E> constexpr size_t f32_smem_bytes() {
  // q [BQ, E+1], k [BK, E+1], v [BK, E], scores [BQ, SK], m, l and alpha [BQ]
  return sizeof(float) * ((size_t)BQ * (E + 1) + (size_t)BK * (E + 1) + (size_t)BK * E +
                          (size_t)BQ * SK + 3 * BQ);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Rows r0 .. r0 + n - 1 of head h of batch item b, [B, L, H, E] in global memory,
// into dst (row stride ld); rows past L are zeros.  16-byte loads, eight a thread in flight.
template <int E>
__device__ __forceinline__ void load_rows(const float* __restrict__ src, float* dst, int ld, int b,
                                          int h, int r0, int n, int L, int H) {
  constexpr int PER_ROW = E / 4;
  dpn::copy_vectors<8>(
      n * PER_ROW,
      [&](int i) {
        const int s = r0 + i / PER_ROW;
        return s < L ? *reinterpret_cast<const uint4*>(src + (((size_t)b * L + s) * H + h) * E +
                                                        (i % PER_ROW) * 4)
                     : make_uint4(0u, 0u, 0u, 0u);
      },
      [&](int i, const uint4& v) {
        const float* f = reinterpret_cast<const float*>(&v);
        float* d = dst + (i / PER_ROW) * ld + (i % PER_ROW) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = f[j];
      });
}

// S[r][c] = (q[r] . k[c]) * scale for the block's rows and the key block's keys;
// -inf for keys at or past nkeys.  Thread (tx, ty) owns rows ty + 16 i, keys tx + 16 j.
template <int E>
__device__ __forceinline__ void score_tile(const float* Qs, const float* Ks, float* S, float scale,
                                           int nkeys) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float acc[4][BK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int e = 0; e < E; ++e) {
    float qv[4], kv[BK / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (E + 1) + e];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) kv[j] = Ks[(tx + 16 * j) * (E + 1) + e];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      const int c = tx + 16 * j;
      S[(ty + 16 * i) * SK + c] = c < nkeys ? acc[i][j] * scale : -INFINITY;
    }
}

// One warp per row of S: the running max m and sum l over the keys so far, the sum
// rescaled by alpha = exp(m_old - m_new).  With keep_p, S holds p = exp(s - m_new)
// afterwards and alpha goes to a_s (the flash kernel's step).
__device__ __forceinline__ void update_rows(float* S, float* m_s, float* l_s, float* a_s,
                                            bool keep_p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* row = S + r * SK;
    float mx = -INFINITY;
    for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, row[c]);
    const float m_old = m_s[r];
    const float m_new = fmaxf(m_old, warp_max(mx));
    float sum = 0.0f;
    for (int c = lane; c < BK; c += 32) {
      const float p = expf(row[c] - m_new);
      if (keep_p) row[c] = p;
      sum += p;
    }
    sum = dpn::warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      l_s[r] = alpha * l_s[r] + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
  }
}

// The single-tile kernel's second pass: S holds a = exp(s - m) / l with the final m, l.
__device__ __forceinline__ void normalise_rows(float* S, const float* m_s, const float* l_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    float* row = S + r * SK;
    const float m = m_s[r], l = l_s[r];
    for (int c = lane; c < BK; c += 32) row[c] = expf(row[c] - m) / l;
  }
}

template <int E, bool FLASH>
__global__ void __launch_bounds__(THREADS, 1)
attention_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              float* __restrict__ out, int L, int H, float scale) {
  constexpr int EJ = E / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ, E + 1]
  float* Ks = Qs + BQ * (E + 1);    // [BK, E + 1]
  float* Vs = Ks + BK * (E + 1);    // [BK, E]
  float* S = Vs + BK * E;           // [BQ, SK]
  float* m_s = S + BQ * SK;         // [BQ]
  float* l_s = m_s + BQ;            // [BQ]
  float* a_s = l_s + BQ;            // [BQ]

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.y / H, h = blockIdx.y - b * H;
  const int q0 = blockIdx.x * BQ;
  const int n_kb = (L + BK - 1) / BK;

  load_rows<E>(q, Qs, E + 1, b, h, q0, BQ, L, H);
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.0f;
  }

  if (!FLASH) {  // pass 1: each row's max and sum over all keys
    for (int kb = 0; kb < n_kb; ++kb) {
      const int k0 = kb * BK, nkeys = min(BK, L - k0);
      __syncthreads();
      load_rows<E>(k, Ks, E + 1, b, h, k0, BK, L, H);
      __syncthreads();
      score_tile<E>(Qs, Ks, S, scale, nkeys);
      __syncthreads();
      update_rows(S, m_s, l_s, a_s, false);
    }
  }

  float acc[4][EJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < EJ; ++j) acc[i][j] = 0.0f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK, nkeys = min(BK, L - k0);
    __syncthreads();
    load_rows<E>(k, Ks, E + 1, b, h, k0, BK, L, H);
    load_rows<E>(v, Vs, E, b, h, k0, nkeys, L, H);
    __syncthreads();
    score_tile<E>(Qs, Ks, S, scale, nkeys);
    __syncthreads();
    if (FLASH)
      update_rows(S, m_s, l_s, a_s, true);
    else
      normalise_rows(S, m_s, l_s);
    __syncthreads();
    // this key block's p . v, summed on its own and then combined (acc * alpha + pv)
    float pv[4][EJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < EJ; ++j) pv[i][j] = 0.0f;
    for (int c = 0; c < nkeys; ++c) {
      float pp[4], vv[EJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pp[i] = S[(ty + 16 * i) * SK + c];
#pragma unroll
      for (int j = 0; j < EJ; ++j) vv[j] = Vs[c * E + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < EJ; ++j) pv[i][j] = fmaf(pp[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = FLASH ? a_s[ty + 16 * i] : 1.0f;
#pragma unroll
      for (int j = 0; j < EJ; ++j) acc[i][j] = FLASH ? acc[i][j] * alpha + pv[i][j] : acc[i][j] + pv[i][j];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, s = q0 + r;
    if (s >= L) continue;
    const float l = FLASH ? l_s[r] : 1.0f;
#pragma unroll
    for (int j = 0; j < EJ; ++j)
      out[(((size_t)b * L + s) * H + h) * E + tx + 16 * j] = FLASH ? acc[i][j] / l : acc[i][j];
  }
}

template <int E, bool FLASH>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B, int L, int H,
               float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<E>();
  cudaError_t err = cudaFuncSetAttribute(attention_f32<E, FLASH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((L + BQ - 1) / BQ, B * H);
  attention_f32<E, FLASH><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), L, H, scale);
  return (int)cudaGetLastError();
}

template <int E>
cudaError_t plan_e(int is_bf16, int B, int L, int H, Plan& p) {
  if (is_bf16) return plan_bf16<E>(B, L, H, p);
  p = Plan{THREADS / 32 / KW, 1, (L + BQ - 1) / BQ, 0, f32_smem_bytes<E>()};
  return cudaSuccess;
}

template <int E>
int launch_e(int is_bf16, const void* q, const void* k, const void* v, void* out, int B, int L,
             int H, float scale, int flash, cudaStream_t stream) {
  if (is_bf16) {
    Plan p;
    const cudaError_t err = plan_bf16<E>(B, L, H, p);
    if (err != cudaSuccess) return (int)err;
    return flash ? launch_bf16<E, true>(q, k, v, out, B, L, H, scale, p, stream)
                 : launch_bf16<E, false>(q, k, v, out, B, L, H, scale, p, stream);
  }
  return flash ? launch_f32<E, true>(q, k, v, out, B, L, H, scale, stream)
               : launch_f32<E, false>(q, k, v, out, B, L, H, scale, stream);
}

}  // namespace

extern "C" {

int dpn_attention_supports_head_dim(int e) { return e == 16 || e == 32 || e == 64; }

// The launch dpn_attention would make: out = {warps a block, blocks, dynamic shared memory
// bytes, 1 if all of a head's K and V stay in shared memory}.  Returns a CUDA error (0: none).
int dpn_attention_plan(int is_bf16, int B, int L, int H, int E, int flash, long long* out) {
  Plan p;
  cudaError_t err;
  switch (E) {
    case 16: err = plan_e<16>(is_bf16, B, L, H, p); break;
    case 32: err = plan_e<32>(is_bf16, B, L, H, p); break;
    case 64: err = plan_e<64>(is_bf16, B, L, H, p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  out[0] = p.rw * KW;
  out[1] = (long long)p.row_blocks * B * H;
  out[2] = (long long)p.smem;
  out[3] = p.resident;
  return 0;
}

// is_bf16: 1 for __nv_bfloat16 q, k, v, out, 0 for float; all [B, L, H, E] contiguous.
// flash: 1 for the flash kernel, 0 for the single-tile kernel.  Returns
// cudaGetLastError() after the launch (0 on success).
int dpn_attention(int is_bf16, const void* q, const void* k, const void* v, void* out, int B,
                  int L, int H, int E, float scale, int flash, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E) {
    case 16: return launch_e<16>(is_bf16, q, k, v, out, B, L, H, scale, flash, s);
    case 32: return launch_e<32>(is_bf16, q, k, v, out, B, L, H, scale, flash, s);
    case 64: return launch_e<64>(is_bf16, q, k, v, out, B, L, H, scale, flash, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
