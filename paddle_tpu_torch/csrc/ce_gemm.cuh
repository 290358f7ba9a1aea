// The mainloop of the fused linear + cross-entropy GEMMs (sm_90a): the
// forward's logz pass (csrc/fused_ce_fwd.cu) and the backward's P, dW and
// dh passes (csrc/fused_ce_bwd.cu) share it; each adds its own epilogue.
//
// A block of three warpgroups owns a 128 x 256 output tile; warpgroup 0 is
// the producer (one thread keeps TMA loads of 64-deep K slices in flight
// through a ring of 4 stages of 48 KB, each with a "full" and an "empty"
// mbarrier), warpgroups 1 and 2 each multiply 64 of the rows with
// wgmma.mma_async m64n256k16 (f32 accumulators in registers, 128 a thread)
// and keep one k-slice of products in flight.  TMA zero-fills reads past
// the tensors, so ragged token, vocabulary and hidden extents need no
// padded copies; the epilogues mask what they write.
#pragma once

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace pt {
namespace ce {

namespace sm = pt::sm90;

constexpr int BM = 128;              // output rows a block owns
constexpr int BN = 256;              // output columns a block owns
constexpr int BK = 64;               // K per stage: one 128-byte swizzle span
constexpr int STAGES = 4;
constexpr int GT = 384;              // a producer and two consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;                 // 16 KB
constexpr int B_BYTES = BN * BK * 2;                 // 32 KB
constexpr int BOX_BYTES = 64 * BK * 2;               // one MN-major box
constexpr size_t GEMM_SMEM =
    STAGES * (A_BYTES + B_BYTES) + 2 * STAGES * sizeof(uint64_t) + 1024;

// LOGZ_PASS (the forward): s = h.W^T, operands as in the P pass
enum Pass { P_PASS, DW_PASS, DH_PASS, LOGZ_PASS };

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The producer's loads of k-slice kb into stage (a, b); v0 is the first
// vocabulary row of the backward's chunk (0 in the forward).  Operand
// majors:
//   P and LOGZ passes: A = h (K-major), B = W (K-major)
//   dW pass: A = P^T (P read MN-major), B = h (MN-major)
//   dh pass: A = P (K-major), B = W_c (MN-major)
template <int PASS>
__device__ __forceinline__ void load_slice(unsigned char* a, unsigned char* b,
                                           const CUtensorMap* ta,
                                           const CUtensorMap* tb,
                                           uint64_t* bar, int v0, int m0,
                                           int n0, int k0) {
  if (PASS == P_PASS || PASS == LOGZ_PASS) {
    sm::tma_load_2d(a, ta, bar, k0, m0);
    sm::tma_load_2d(b, tb, bar, k0, v0 + n0);
  } else if (PASS == DW_PASS) {
#pragma unroll
    for (int i = 0; i < BM / 64; ++i)
      sm::tma_load_2d(a + i * BOX_BYTES, ta, bar, m0 + 64 * i, k0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      sm::tma_load_2d(b + j * BOX_BYTES, tb, bar, n0 + 64 * j, k0);
  } else {
    sm::tma_load_2d(a, ta, bar, k0, m0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      sm::tma_load_2d(b + j * BOX_BYTES, tb, bar, n0 + 64 * j, v0 + k0);
  }
}

// acc += this warpgroup's 64 rows of A . B over one k-slice in stage (a, b)
template <int PASS>
__device__ __forceinline__ void mma_slice(float (&acc)[128],
                                          const unsigned char* a,
                                          const unsigned char* b, int cw) {
  constexpr int TA = PASS == DW_PASS;          // A MN-major
  constexpr int TB = PASS == DW_PASS || PASS == DH_PASS;   // B MN-major
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // K-major: the warpgroup's 64 rows start 64 x 128 bytes in, each 16
    // of K 32 bytes on; MN-major: its 64 columns are box cw, each 16 of
    // K 16 rows of 128 bytes on
    const uint64_t da =
        TA ? sm::desc_sw128(a + cw * BOX_BYTES + kk * 2048, BOX_BYTES, 1024)
           : sm::desc_sw128(a + cw * 64 * 128 + kk * 32, 16, 1024);
    const uint64_t db =
        TB ? sm::desc_sw128(b + kk * 2048, BOX_BYTES, 1024)
           : sm::desc_sw128(b + kk * 32, 16, 1024);
    sm::wgmma_m64n256k16<TA, TB>(acc, da, db);
  }
}

// A block's shared memory: the A and B stages (the 128-byte swizzle
// repeats every 1024 bytes, so they are aligned to it), then the full and
// empty mbarriers of each stage
struct Smem {
  unsigned char* as;
  unsigned char* bs;
  uint64_t* full;
  uint64_t* empty;
};

__device__ __forceinline__ Smem smem_layout(unsigned char* raw) {
  Smem s;
  s.as = raw + ((1024 - (sm::smem_u32(raw) & 1023)) & 1023);
  s.bs = s.as + STAGES * A_BYTES;
  s.full = reinterpret_cast<uint64_t*>(s.bs + STAGES * B_BYTES);
  s.empty = s.full + STAGES;
  return s;
}

// The tile (m0, n0) over nk k-slices: the producer warpgroup returns false;
// a consumer thread returns true with its 128 accumulators, rows r0 and
// r0 + 8 of the tile (r0 = cw 64 + (t / 32) 16 + lane / 4), columns
// 8 j + 2 (lane % 4) + {0, 1} for j < 32, as sm::wgmma_m64n256k16 lays
// them out.
template <int PASS>
__device__ __forceinline__ bool mainloop(float (&acc)[128], const Smem& sh,
                                         const CUtensorMap* ta,
                                         const CUtensorMap* tb, int v0,
                                         int m0, int n0, int nk) {
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm::mbar_init(&sh.full[s], 1);
      sm::mbar_init(&sh.empty[s], 2);   // one arrival per consumer warpgroup
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int kb = 0; kb < nk; ++kb) {
        const int s = kb % STAGES;
        sm::mbar_wait(&sh.empty[s], ((kb / STAGES) & 1) ^ 1);
        sm::mbar_expect_tx(&sh.full[s], A_BYTES + B_BYTES);
        load_slice<PASS>(sh.as + s * A_BYTES, sh.bs + s * B_BYTES, ta, tb,
                         &sh.full[s], v0, m0, n0, kb * BK);
      }
    }
    return false;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, t = threadIdx.x % 128;
  // the products start from 0: registers loaded from memory here would
  // serialise the products in flight (ptxas C7515, and 7 % of the dh
  // pass); the dh pass adds the earlier chunks' sum in its epilogue
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int kb = 0; kb < nk; ++kb) {
    const int s = kb % STAGES;
    sm::mbar_wait(&sh.full[s], (kb / STAGES) & 1);
    sm::fence_acc(acc);
    sm::wgmma_fence();
    mma_slice<PASS>(acc, sh.as + s * A_BYTES, sh.bs + s * B_BYTES, cw);
    sm::wgmma_commit();
    // the previous slice's products are done: its stage may refill
    sm::wgmma_wait<1>();
    sm::fence_acc(acc);
    if (kb > 0 && t == 0) sm::mbar_arrive(&sh.empty[(kb - 1) % STAGES]);
  }
  sm::wgmma_wait<0>();
  sm::fence_acc(acc);
  return true;
}

}  // namespace ce
}  // namespace pt
