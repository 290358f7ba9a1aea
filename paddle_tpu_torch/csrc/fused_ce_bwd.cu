// Fused linear + cross-entropy backward for Hopper (sm_90a): dh and dW,
// bound through a plain C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/fused_ce.py `_dh_kernel` (:138) and
// `_dw_kernel` (:161), called through `_ce_bwd_kernels` (:186).  Same
// function: with s = h.W^T (f32 accumulate) and p = exp(s - logz) * g,
// rounded to the input dtype before the second product,
//    dh = p.W      (N x H, written in h's dtype)
//    dW = p^T.h    (V x H, written in W's dtype)
// both accumulated in f32.  Vocabulary rows past V and token rows past N
// give p = 0.  The gold-label terms stay outside, in PyTorch, as in the
// reference.
//
// Design (bf16, the model's path).  Three GEMMs over chunks of the
// vocabulary: the (N, V) scores never reach device memory, only the
// (N, V_c) probabilities of one chunk, in a bf16 scratch buffer the caller
// allocates (P, its row length V_c a multiple of 128).  For the chunk
// W_c = W[v0 : v0 + nv], in order:
//  1. P pass:  P = bf16(g * 2^(s log2e - logz log2e)), s = h.W_c^T, an
//     N x V_c GEMM over K = H; the exponential, g and the mask past V
//     are its epilogue, which stages the bf16 tile in shared memory (the
//     128-byte swizzle of P's tensor map) for one TMA store.
//  2. dW pass: dW[v0 : v0 + nv] = P^T.h, M = V_c, N = H, K = tokens; A is
//     P read MN-major, B is h read MN-major.
//  3. dh pass: acc += P.W_c, M = tokens, N = H, K = V_c; B is W_c read
//     MN-major.  acc is an f32 (N, H) buffer: the first chunk writes its
//     product there, a later one adds the buffer to its product in the
//     epilogue, the last writes dh in bf16 (one chunk touches no buffer).
// Each output tile is owned by one block and written once per pass, and
// the chunks run in a fixed order: no atomics, the result is deterministic.
// One mainloop (csrc/ce_gemm.cuh, shared with the forward's logz pass)
// serves the three passes: a block of three warpgroups owns a 128 x 256
// output tile, a producer warpgroup keeps TMA loads of 64-deep K slices in
// a 4-stage ring and two consumer warpgroups multiply on wgmma m64n256k16.
// TMA zero-fills reads past the tensors and clips stores, so ragged N, V,
// V_c and H need no padded copies; the dW and dh epilogues mask their
// stores.
//
// What bounds it.  At N = 8192, H = 1024, V = 50304 the three products
// are 3 x 2 N V H = 2.53 TFLOP, 2.56 ms at the card's 989 TFLOP/s bf16
// peak; P's round trip (write once, read twice, 2.5 GB) and the f32
// accumulator's read-modify-writes (0.4 GB) take about 0.9 ms at 3.35
// TB/s where L2 does not hold them.  Building the scores once saves a
// fourth product; keeping dh's sum in device memory leaves the tile
// (128 x 256, 128 FLOP per byte read) and H free of any register cap.
//
// f32 (tests and the small reference model): two kernels on the FMA
// units, each rebuilding the scores: 16 owned rows and 256 columns per
// block (a wider H takes more blocks), exp() as in the reference.
#include "ce_gemm.cuh"
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

using pt::bf16;
namespace sm = pt::sm90;
using namespace pt::ce;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: three wgmma GEMMs a chunk
// ---------------------------------------------------------------------------

// One chunk of the vocabulary and the tensors its passes touch.
struct Chunk {
  int n, hd;            // tokens, hidden width
  int v0, nv;           // the chunk's first vocabulary row, its rows
  int ld;               // P's row length (V_c)
  int first, last;      // the chunk's place in the loop (dh pass)
  const float* logz;    // (n,) f32
  const float* g;       // (n,) f32
  bf16* p;              // P scratch (n, ld)
  bf16* dw;             // (V, hd)
  float* acc;           // (n, hd) f32 between chunks, or null
  bf16* dh;             // (n, hd)
};

template <int PASS>
__device__ __forceinline__ void gemm_body(const CUtensorMap* ta,
                                          const CUtensorMap* tb,
                                          const CUtensorMap* tp,
                                          const Chunk& c) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sh = smem_layout(smem_raw);
  unsigned char* as = sh.as;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = cdiv(PASS == P_PASS ? c.hd : PASS == DW_PASS ? c.n : c.nv,
                      BK);
  float acc[128];
  if (!mainloop<PASS>(acc, sh, ta, tb, c.v0, m0, n0, nk)) return;

  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  const int lane = t % 32;
  // this thread's first row in the block and its column in each 8-block
  const int r0 = cw * 64 + (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);

  if (PASS == P_PASS) {
    // p goes out through shared memory: the A stages (both warpgroups'
    // products are done with them) hold the tile as 4 boxes of 128 rows
    // x 64 columns in the 128-byte swizzle of P's map, and one thread
    // stores them with TMA, which clips rows past N and columns past V_c
    sm::named_barrier(1, 256);
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int tr = r0 + 8 * hi, row = m0 + tr;
      const float lz = row < c.n ? c.logz[row] * LOG2E : 0.f;
      const float gg = row < c.n ? c.g[row] : 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + cq;
        const float p0 =
            col < c.nv ? gg * pt::ex2(acc[4 * j + 2 * hi] * LOG2E - lz)
                       : 0.f;
        const float p1 =
            col + 1 < c.nv
                ? gg * pt::ex2(acc[4 * j + 2 * hi + 1] * LOG2E - lz)
                : 0.f;
        // box j / 8; the 16-byte chunk j % 8 of row tr, swizzled by tr % 8
        *reinterpret_cast<uint32_t*>(
            as + (j / 8) * BOX_BYTES * 2 + tr * 128 +
            (((j % 8) ^ (tr % 8)) * 16) + cq * 2) = pt::pack_bf16(p0, p1);
      }
    }
    sm::fence_proxy_async();
    sm::named_barrier(1, 256);
    if (threadIdx.x == 128) {
#pragma unroll
      for (int b = 0; b < BN / 64; ++b)
        if (n0 + 64 * b < c.ld)
          sm::tma_store_2d(tp, as + b * BOX_BYTES * 2, n0 + 64 * b, m0);
      sm::bulk_commit_and_wait_read();
    }
    return;
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = m0 + r0 + 8 * hi;
    if (PASS == DW_PASS) {
      if (row >= c.nv) continue;
      bf16* out = c.dw + (size_t)(c.v0 + row) * c.hd;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = n0 + 8 * j + cq;   // even, and hd is a multiple of 64
        if (col < c.hd)
          *reinterpret_cast<uint32_t*>(out + col) =
              pt::pack_bf16(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
      }
    } else {
      if (row >= c.n) continue;
      const float* sum = c.acc + (size_t)row * c.hd;
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += 8) {
        // the earlier chunks' sums of 8 column pairs, loaded together
        float2 e[8];
#pragma unroll
        for (int j = j0; j < j0 + 8; ++j) {
          const int col = n0 + 8 * j + cq;
          e[j - j0] = !c.first && col < c.hd
                          ? *reinterpret_cast<const float2*>(sum + col)
                          : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = j0; j < j0 + 8; ++j) {
          const int col = n0 + 8 * j + cq;
          if (col >= c.hd) continue;
          const float x = acc[4 * j + 2 * hi] + e[j - j0].x;
          const float y = acc[4 * j + 2 * hi + 1] + e[j - j0].y;
          if (c.last)
            *reinterpret_cast<uint32_t*>(c.dh + (size_t)row * c.hd + col) =
                pt::pack_bf16(x, y);
          else
            *reinterpret_cast<float2*>(c.acc + (size_t)row * c.hd + col) =
                make_float2(x, y);
        }
      }
    }
  }
}

// ta, tb: the operands' maps; tp: P's map (the P pass stores through it)
__global__ void __launch_bounds__(GT, 1)
    ce_bwd_p_pass(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb,
                  const __grid_constant__ CUtensorMap tp, const Chunk c) {
  gemm_body<P_PASS>(&ta, &tb, &tp, c);
}

__global__ void __launch_bounds__(GT, 1)
    ce_bwd_dw_pass(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tp, const Chunk c) {
  gemm_body<DW_PASS>(&ta, &tb, &tp, c);
}

__global__ void __launch_bounds__(GT, 1)
    ce_bwd_dh_pass(const __grid_constant__ CUtensorMap ta,
                   const __grid_constant__ CUtensorMap tb,
                   const __grid_constant__ CUtensorMap tp, const Chunk c) {
  gemm_body<DH_PASS>(&ta, &tb, &tp, c);
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int FR = 16;     // owned rows per block
constexpr int FY = 32;     // streamed rows per tile
constexpr int FC = 256;    // output columns per block, one a thread
constexpr int FK = 32;     // columns of H per step of the scores
constexpr int FT = 256;

template <bool TOKEN_OWNER>
__global__ void __launch_bounds__(FT)
    ce_bwd_fma_kernel(const float* __restrict__ x, int nx,
                      const float* __restrict__ y, int ny,
                      const float* __restrict__ logz,
                      const float* __restrict__ gvec,
                      float* __restrict__ out, int hd) {
  __shared__ float Xk[FR][FK + 1];
  __shared__ float Yk[FY][FK + 1];
  __shared__ float Ps[FR][FY];
  __shared__ float Yc[FY][FC];
  __shared__ float Lg[2][FY];        // logz and g, as in the bf16 kernel
  const int r0 = blockIdx.x * FR, c0 = blockIdx.y * FC;
  const int tid = threadIdx.x;
  const int sr = tid >> 4, sc = (tid & 15) * 2;   // scores (sr, sc..sc+1)
  const int col = c0 + tid;

  if (TOKEN_OWNER && tid < FR) {
    const int row = r0 + tid;
    Lg[0][tid] = row < nx ? logz[row] : CUDART_INF_F;
    Lg[1][tid] = row < nx ? gvec[row] : 0.f;
  }
  float acc[FR];
#pragma unroll
  for (int r = 0; r < FR; ++r) acc[r] = 0.f;

  for (int m0 = 0; m0 < ny; m0 += FY) {
    __syncthreads();                 // the last tile's reads are done
    if (!TOKEN_OWNER && tid < FY) {
      const int row = m0 + tid;
      Lg[0][tid] = row < ny ? logz[row] : CUDART_INF_F;
      Lg[1][tid] = row < ny ? gvec[row] : 0.f;
    }
    float s0 = 0.f, s1 = 0.f;
    for (int k0 = 0; k0 < hd; k0 += FK) {
      for (int e = tid; e < FR * FK; e += FT) {
        const int r = e / FK, c = e % FK, row = r0 + r;
        Xk[r][c] = row < nx && k0 + c < hd ? x[(size_t)row * hd + k0 + c]
                                            : 0.f;
      }
      for (int e = tid; e < FY * FK; e += FT) {
        const int r = e / FK, c = e % FK, row = m0 + r;
        Yk[r][c] = row < ny && k0 + c < hd ? y[(size_t)row * hd + k0 + c]
                                            : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < FK; ++d) {
        const float xv = Xk[sr][d];
        s0 = fmaf(xv, Yk[sc][d], s0);
        s1 = fmaf(xv, Yk[sc + 1][d], s1);
      }
      __syncthreads();
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int li = TOKEN_OWNER ? sr : sc + e;
      Ps[sr][sc + e] = m0 + sc + e < ny
                           ? expf((e ? s1 : s0) - Lg[0][li]) * Lg[1][li]
                           : 0.f;
    }
    for (int e = tid; e < FY * FC; e += FT) {
      const int r = e / FC, c = e % FC, row = m0 + r;
      Yc[r][c] = row < ny && c0 + c < hd ? y[(size_t)row * hd + c0 + c]
                                          : 0.f;
    }
    __syncthreads();
    for (int m = 0; m < FY; ++m) {
      const float yv = Yc[m][tid];
#pragma unroll
      for (int r = 0; r < FR; ++r) acc[r] = fmaf(Ps[r][m], yv, acc[r]);
    }
  }
  if (col < hd) {
#pragma unroll
    for (int r = 0; r < FR; ++r)
      if (r0 + r < nx) out[(size_t)(r0 + r) * hd + col] = acc[r];
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <int PASS>
cudaError_t launch_pass(dim3 grid, const CUtensorMap& ta,
                        const CUtensorMap& tb, const CUtensorMap& tp,
                        const Chunk& c, cudaStream_t s) {
  const void* fn = PASS == P_PASS    ? (const void*)ce_bwd_p_pass
                   : PASS == DW_PASS ? (const void*)ce_bwd_dw_pass
                                     : (const void*)ce_bwd_dh_pass;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM);
  if (err != cudaSuccess) return err;
  if (PASS == P_PASS)
    ce_bwd_p_pass<<<grid, GT, GEMM_SMEM, s>>>(ta, tb, tp, c);
  else if (PASS == DW_PASS)
    ce_bwd_dw_pass<<<grid, GT, GEMM_SMEM, s>>>(ta, tb, tp, c);
  else
    ce_bwd_dh_pass<<<grid, GT, GEMM_SMEM, s>>>(ta, tb, tp, c);
  return cudaGetLastError();
}

int cdiv_h(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// bf16 dh (n, hd) and dW (v, hd) from h (n, hd), w (v, hd), logz and g (n,)
// f32, over the vocabulary in chunks of vc rows (a multiple of 128).  p is
// an (n, vc) bf16 scratch buffer; acc an (n, hd) f32 one, needed when
// there is more than one chunk (else it may be null).  hd is a multiple of
// 64; pointers are 16-byte aligned.  Launches 3 kernels a chunk on
// `stream`; returns a cudaError_t as int (cudaErrorInvalidValue for
// arguments it does not take or a tensor map that cannot be encoded).
extern "C" int pt_ce_bwd_bf16(const void* h, const void* w, const float* logz,
                              const float* g, void* dh, void* dw, void* p,
                              float* acc, int n, int hd, int v, int vc,
                              void* stream) {
  const int chunks = vc > 0 ? cdiv_h(v, vc) : 0;
  if (n <= 0 || v <= 0 || hd <= 0 || hd % 64 || vc <= 0 || vc % 128 ||
      (chunks > 1 && acc == nullptr) || cdiv_h(n, BM) > 65535 ||
      cdiv_h(vc, BM) > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap h_k, h_mn, w_k, w_mn, p_k, p_mn;
  if (!pt::sm90::bf16_map(&h_k, h, n, hd, BM) ||
      !pt::sm90::bf16_map(&h_mn, h, n, hd, BK) ||
      !pt::sm90::bf16_map(&w_k, w, v, hd, BN) ||
      !pt::sm90::bf16_map(&w_mn, w, v, hd, BK) ||
      !pt::sm90::bf16_map(&p_k, p, n, vc, BM) ||
      !pt::sm90::bf16_map(&p_mn, p, n, vc, BK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < chunks; ++i) {
    Chunk c;
    c.n = n;
    c.hd = hd;
    c.v0 = i * vc;
    c.nv = v - c.v0 < vc ? v - c.v0 : vc;
    c.ld = vc;
    c.first = i == 0;
    c.last = i == chunks - 1;
    c.logz = logz;
    c.g = g;
    c.p = static_cast<bf16*>(p);
    c.dw = static_cast<bf16*>(dw);
    c.acc = acc;
    c.dh = static_cast<bf16*>(dh);
    cudaError_t err;
    err = launch_pass<P_PASS>(dim3(cdiv_h(c.nv, BN), cdiv_h(n, BM)), h_k,
                              w_k, p_k, c, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_pass<DW_PASS>(dim3(cdiv_h(hd, BN), cdiv_h(c.nv, BM)), p_mn,
                               h_mn, p_k, c, s);
    if (err != cudaSuccess) return (int)err;
    err = launch_pass<DH_PASS>(dim3(cdiv_h(hd, BN), cdiv_h(n, BM)), p_k,
                               w_mn, p_k, c, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// f32 dh (n, hd) and dW (v, hd): the FMA kernels, two launches.  Returns a
// cudaError_t as int.
extern "C" int pt_ce_bwd_f32(const float* h, const float* w,
                             const float* logz, const float* g, float* dh,
                             float* dw, int n, int hd, int v, void* stream) {
  if (n <= 0 || v <= 0 || hd <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ce_bwd_fma_kernel<true><<<dim3(cdiv_h(n, FR), cdiv_h(hd, FC)), FT, 0, s>>>(
      h, n, w, v, logz, g, dh, hd);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_bwd_fma_kernel<false><<<dim3(cdiv_h(v, FR), cdiv_h(hd, FC)), FT, 0, s>>>(
      w, v, h, n, logz, g, dw, hd);
  return (int)cudaGetLastError();
}
