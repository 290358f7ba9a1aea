// Fused linear + cross-entropy forward (the logz pass) for Hopper (sm_90a),
// bound through a plain C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/fused_ce.py `_fwd_kernel` (:79), called
// through `_ce_logz` (:105).  Same function: logz[n] = logsumexp_v(h[n].W[v])
// over the V real vocabulary rows, so the (N, V) logits never reach device
// memory.  Vocab columns past V score -inf, as the TPU kernel's iota mask
// does on its padded W; token rows past N are neither read into nor
// written.  The gold logit h.W[label] stays outside, in PyTorch, as it
// does in the JAX package.
//
// Design (bf16, the model's path).  The logits are the backward's P-pass
// product s = h.W^T over K = H, so the forward runs on the same mainloop
// (csrc/ce_gemm.cuh: a 128 x 256 tile a block, TMA into a 4-stage ring,
// two consumer warpgroups on wgmma m64n256k16) with its own epilogue, the
// LOGZ pass: columns past V become -inf, and each row's 256 scores reduce
// to one (max, sum of exp(s - max)) pair, within a thread and then across
// the quad that shares the row by shuffles, in a fixed order.  One pair
// per (row, vocabulary tile) goes to an (N, ceil(V / 256)) scratch buffer
// the caller allocates (12.9 MB at GPT-2 345M's head); the merge kernel
// folds a row's pairs in a fixed order.  The grid walks the token tiles
// fastest, so the blocks in flight share a tile of W, read once from
// device memory, and h stays in L2.  TMA zero-fills reads past N and V.
// No atomics: two calls are bitwise equal.
//
// f32 (tests): 64 x 64 tiles, 256 threads with 4x4 patches on the f32 FMA
// units; each block walks a run of vocab tiles with a running (max, sum)
// per token in registers and writes one pair per token and run.
//
// What bounds it.  At N = 8192, H = 1024, V = 50304 it does 2*N*V*H =
// 844 GFLOP: 0.85 ms at the card's 989 TFLOP/s bf16 tensor-core peak,
// against 0.12 ms for its bytes (h and W in bf16 read once, logz written),
// so operations bound it.
#include "ce_gemm.cuh"
#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

using pt::bf16;
namespace sm = pt::sm90;
using namespace pt::ce;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// bf16: the LOGZ pass on the shared wgmma mainloop
// ---------------------------------------------------------------------------

struct Logz {
  int n, hd, v;
  int n_vt;             // vocabulary tiles of BN rows
  float2* part;         // (n, n_vt) (max, sum of exp(s - max)) pairs
};

__global__ void __launch_bounds__(GT, 1)
    ce_logz_pass(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tb, const Logz z) {
  extern __shared__ unsigned char smem_raw[];
  const Smem sh = smem_layout(smem_raw);
  // token tiles fastest: the blocks in flight share vocabulary tile vt
  const int m0 = blockIdx.x * BM, vt = blockIdx.y, n0 = vt * BN;
  float acc[128];
  if (!mainloop<LOGZ_PASS>(acc, sh, &ta, &tb, 0, m0, n0, cdiv(z.hd, BK)))
    return;

  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  const int lane = t % 32;
  const int r0 = cw * 64 + (t / 32) * 16 + lane / 4;
  const int cq = 2 * (lane % 4);
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    float mx = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = n0 + 8 * j + cq;
      float& a0 = acc[4 * j + 2 * hi];
      float& a1 = acc[4 * j + 2 * hi + 1];
      if (col >= z.v) a0 = -CUDART_INF_F;
      if (col + 1 >= z.v) a1 = -CUDART_INF_F;
      mx = fmaxf(mx, fmaxf(a0, a1));
    }
    mx = pt::group_max<4>(mx);          // the quad shares the row
    float sum = 0.f;
    if (mx != -CUDART_INF_F) {
      const float m2 = mx * LOG2E;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        sum += pt::ex2(fmaf(acc[4 * j + 2 * hi], LOG2E, -m2));
        sum += pt::ex2(fmaf(acc[4 * j + 2 * hi + 1], LOG2E, -m2));
      }
    }
    sum = pt::group_sum<4>(sum);
    const int row = m0 + r0 + 8 * hi;
    if (lane % 4 == 0 && row < z.n)
      z.part[(size_t)row * z.n_vt + vt] = make_float2(mx, sum);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int FB_N = 64;     // tokens per block
constexpr int FB_V = 64;     // vocab rows per tile
constexpr int FB_H = 32;     // hidden columns per shared-memory stage
constexpr int FB_T = 256;

__global__ void __launch_bounds__(FB_T)
    ce_partial_fma_kernel(const float* __restrict__ h,
                          const float* __restrict__ w,
                          float2* __restrict__ part, int n, int hd, int v,
                          int tiles_per_split) {
  __shared__ float Hs[FB_N][FB_H + 1];
  __shared__ float Ws[FB_V][FB_H + 1];
  const int n0 = blockIdx.x * FB_N;
  const int split = blockIdx.y, n_split = gridDim.y;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int n_vt = (v + FB_V - 1) / FB_V;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, n_vt);

  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
  }

  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * FB_V;
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;

    for (int h0 = 0; h0 < hd; h0 += FB_H) {
      __syncthreads();
      for (int e = tid; e < FB_N * FB_H; e += FB_T) {
        const int r = e / FB_H, c = e % FB_H, col = h0 + c;
        const int row = n0 + r, vrow = v0 + r;
        Hs[r][c] = (row < n && col < hd) ? h[(size_t)row * hd + col] : 0.f;
        Ws[r][c] = (vrow < v && col < hd) ? w[(size_t)vrow * hd + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < FB_H; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Hs[ty + 16 * i][d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Ws[tx + 16 * j][d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (v0 + tx + 16 * j >= v) s[i][j] = -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], pt::group_max<16>(mx));
      const bool live = m_new != -CUDART_INF_F;
      const float alpha = m[i] != -CUDART_INF_F ? expf(m[i] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rs += live ? expf(s[i][j] - m_new) : 0.f;
      l[i] = alpha * l[i] + pt::group_sum<16>(rs);
      m[i] = m_new;
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = n0 + ty + 16 * i;
      if (row < n)
        part[(size_t)row * n_split + split] = make_float2(m[i], l[i]);
    }
  }
}

// ---------------------------------------------------------------------------
// merge of the partial pairs
// ---------------------------------------------------------------------------

// (m, l) <- the pair of the union of the scores of (m, l) and (qm, ql)
__device__ __forceinline__ void fold(float& m, float& l, float qm, float ql) {
  const float mn = fmaxf(m, qm);
  l = mn == -CUDART_INF_F ? 0.f
                          : l * expf(m - mn) + ql * expf(qm - mn);
  m = mn;
}

// logz of a row from its n_split pairs: one warp a row; lane L folds the
// pairs L, L + 32, ... in order, then the lanes fold in a fixed tree
constexpr int MERGE_T = 256;

__global__ void __launch_bounds__(MERGE_T)
    ce_merge_kernel(const float2* __restrict__ part,
                    float* __restrict__ logz, int n, int n_split) {
  const int row = blockIdx.x * (MERGE_T / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n) return;                 // the whole warp
  const float2* p = part + (size_t)row * n_split;
  float m = -CUDART_INF_F, l = 0.f;
  for (int s = lane; s < n_split; s += 32) {
    const float2 q = p[s];
    fold(m, l, q.x, q.y);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float qm = __shfl_xor_sync(0xffffffffu, m, o);
    const float ql = __shfl_xor_sync(0xffffffffu, l, o);
    fold(m, l, qm, ql);
  }
  if (lane == 0) logz[row] = m + logf(fmaxf(l, 1e-30f));
}

}  // namespace

// part: (n, n_split) pairs of f32 scratch.  dtype: 0 = float32 (64 x 64
// tiles, vocab tiles in n_split runs), 1 = bfloat16 (128 x 256 tiles, one
// pair per vocab tile: n_split = ceil(v / 256); hd a multiple of 64,
// pointers 16-byte aligned).  Returns a cudaError_t as int
// (cudaErrorInvalidValue for arguments it does not take or a tensor map
// that cannot be encoded).
extern "C" int pt_ce_logz_fwd(const void* h, const void* w, float* logz,
                              float* part, int n, int hd, int v, int n_split,
                              int dtype, void* stream) {
  if (n <= 0 || hd <= 0 || v <= 0 || n_split <= 0 || n_split > 65535 ||
      (dtype != 0 && dtype != 1) ||
      (dtype == 1 && (hd % 64 || n_split != (v + BN - 1) / BN)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* pairs = reinterpret_cast<float2*>(part);
  cudaError_t err;
  if (dtype == 1) {
    CUtensorMap th, tw;
    if (!sm::bf16_map(&th, h, n, hd, BM) || !sm::bf16_map(&tw, w, v, hd, BN))
      return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(ce_logz_pass,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)GEMM_SMEM);
    if (err != cudaSuccess) return (int)err;
    ce_logz_pass<<<dim3((n + BM - 1) / BM, n_split), GT, GEMM_SMEM, s>>>(
        th, tw, Logz{n, hd, v, n_split, pairs});
  } else {
    const int n_vt = (v + FB_V - 1) / FB_V;
    const int per = (n_vt + n_split - 1) / n_split;
    ce_partial_fma_kernel<<<dim3((n + FB_N - 1) / FB_N, n_split), FB_T, 0,
                            s>>>(static_cast<const float*>(h),
                                 static_cast<const float*>(w), pairs, n, hd,
                                 v, per);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_merge_kernel<<<(n + MERGE_T / 32 - 1) / (MERGE_T / 32), MERGE_T, 0, s>>>(
      pairs, logz, n, n_split);
  return (int)cudaGetLastError();
}
