// Warp-level bf16 tensor-core helpers for Hopper (sm_90a): the m16n8k16 product with
// f32 accumulation (mma.sync), its operand loads from shared memory (ldmatrix), the
// 16-byte global -> shared copy (cp.async) and the fragment maps.  attention.cu and
// decode_mma.cuh use them; any kernel that multiplies bf16 tiles on the tensor cores can.
//
// Fragments of mma.m16n8k16.row.col (lane = 4 g + t, g = lane >> 2, t = lane & 3):
//   A [16 x 16] row-major, 4 registers of two bf16 each, the lower column in the low half:
//     a0 = (row g,     cols 2t, 2t+1)      a1 = (row g + 8, cols 2t, 2t+1)
//     a2 = (row g,     cols 2t+8, 2t+9)    a3 = (row g + 8, cols 2t+8, 2t+9)
//   B [16 x 8] (k x n), 2 registers: b0 = (k 2t, 2t+1; n g), b1 = (k 2t+8, 2t+9; n g)
//   C, D [16 x 8] f32: c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g + 8, cols 2t, 2t+1)
// So the C fragments of two adjacent n8 tiles, rounded to bf16 in pairs, are the A
// fragment of one k16 step: a product's output feeds the next product from registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpn {
namespace mma {

// d += a . b: one 16 x 8 x 16 product, bf16 operands (exact products), f32 sums.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory.  Lanes 8i .. 8i+7 give the row addresses
// (16 bytes each, 16-byte aligned) of matrix i; r[i] is matrix i's fragment: lane
// 4 g + t holds row g, columns 2t and 2t+1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed: lane 4 g + t holds rows 2t and 2t+1 of column g.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Two 8 x 8 bf16 matrices, each transposed: lanes 0-7 give matrix 0's row addresses, lanes 8-15
// matrix 1's (the other lanes' are not read).  From k rows 0-15 of a [K, N] weight at one n8
// column tile: the B fragment (b0, b1) of that tile.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// 16 bytes global -> shared, asynchronously (L2 only).  With valid false nothing is read
// and the 16 bytes are zeros; src must still be a mapped address.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's committed groups are still in flight.
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Two f32 values rounded to bf16 (round to nearest even, as PyTorch's and XLA's
// conversions) in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (ex2.approx.ftz: relative error about 2^-22, results
// below 2^-126 flushed to zero); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four lanes that share a row of a C fragment.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma
}  // namespace dpn
