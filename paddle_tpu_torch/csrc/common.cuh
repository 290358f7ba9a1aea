// Device helpers shared by the port's kernels: dtype conversion, warp
// reductions, the bf16 tensor-core product mma.sync.m16n8k16, and
// asynchronous (cp.async) tile copies into shared memory.
//
// Fragment layout of mma.m16n8k16 (PTX ISA, "matrix fragments for
// mma.m16n8k16"), with g = lane / 4 and t = lane % 4:
//   A (16x16, row-major), four 32-bit registers of two bf16 each:
//     a0 = A[g][2t..2t+1]    a1 = A[g+8][2t..2t+1]
//     a2 = A[g][2t+8..2t+9]  a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"), two registers:
//     b0 = B[2t..2t+1][g]    b1 = B[2t+8..2t+9][g]
//   C, D (16x8 f32): c0, c1 = C[g][2t..2t+1]; c2, c3 = C[g+8][2t..2t+1]
// The lower half of a register holds the element of lower index.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace pt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// reductions over the lanes whose index differs only in the low bits
template <int WIDTH>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two bf16 at p[0], p[stride] -> one register (for B read down a column)
__device__ __forceinline__ uint32_t pack_col(const bf16* p, int stride) {
  const unsigned short* u = reinterpret_cast<const unsigned short*>(p);
  return (uint32_t)u[0] | ((uint32_t)u[stride] << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += A * B on one 16x16x8 bf16 tile, f32 accumulate
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Start copying rows [row0, row0 + ROWS) x columns [col0, col0 + COLS) of
// a row-major bf16 matrix with `ld` elements per row and `nrows` rows into
// shared memory with LDS elements per row, 16 bytes per cp.async; rows past
// nrows are zero-filled and read nothing.  COLS, ld, col0 and LDS are
// multiples of 8 and the source is 16-byte aligned.  The copies land after
// commit() and wait<N>() (and a barrier, for the other threads' copies).
template <int ROWS, int COLS, int LDS, int NTHREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int nrows,
                                                size_t ld, int col0) {
  constexpr int VPR = COLS / 8;
  for (int e = threadIdx.x; e < ROWS * VPR; e += NTHREADS) {
    const int r = e / VPR, c = (e % VPR) * 8, row = row0 + r;
    const bool ok = row < nrows;
    const bf16* g = ok ? src + (size_t)row * ld + col0 + c : src;
    const unsigned s =
        (unsigned)__cvta_generic_to_shared(dst + r * LDS + c);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(g), "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace pt
