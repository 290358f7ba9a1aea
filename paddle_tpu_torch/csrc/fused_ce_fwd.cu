// Fused linear + cross-entropy forward (the logz pass) for Hopper (sm_90a),
// bound through a plain C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/fused_ce.py `_fwd_kernel` (:79), called
// through `_ce_logz` (:105).  Same function: logz[n] = logsumexp_v(h[n].W[v])
// over the V real vocabulary rows, by an online max / sum-exp over vocab
// tiles, so the (N, V) logits never reach device memory.  Vocab columns
// past V score -inf, as the TPU kernel's iota mask does on its padded W;
// here the tile loads mask both the token and the vocab edge, so neither
// h nor W is copied into a padded buffer.  The gold logit h.W[label]
// stays outside, in PyTorch, as it does in the JAX package.
//
// Design.  N / BN token tiles alone (64 blocks at N = 8192) cannot fill
// the card's 132 SMs, and one block per token tile would walk all of W
// alone, so the vocabulary is split as well: grid (token tile, vocab
// split); each block walks its run of vocab tiles with a running (max,
// sum) per token in registers and writes one partial (m, l) pair per token
// and split.  A second small kernel merges the splits into logz.
//  - bf16 (the model's path): 128 x 128 logit tiles, 8 warps of 16 tokens
//    each; the product runs on the tensor cores as mma.sync m16n8k16 (bf16
//    in, f32 accumulate) over 64-wide slices of the hidden dim, staged in
//    shared memory by cp.async in two stages so that the next slice's
//    copies overlap the current slice's products.
//  - f32 (tests): 64 x 64 tiles, 256 threads with 4x4 patches on the f32
//    FMA units.
//
// What bounds it.  At N = 8192, H = 1024, V = 50304 it does 2*N*V*H =
// 844 GFLOP: 0.85 ms at the card's 989 TFLOP/s bf16 tensor-core peak,
// against 0.12 ms for its bytes (h and W in bf16 read once, logz written),
// so operations bound it.  A 128 x 128 tile rereads its slices of h and W
// from L2 at 64 FLOP per byte; wgmma with a TMA-fed ring, larger tiles and
// a persistent grid are the next steps.
#include "common.cuh"

namespace {

using pt::bf16;

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MB_N = 128;    // tokens per block (8 warps x 16)
constexpr int MB_V = 128;    // vocab rows per tile
constexpr int MB_H = 64;     // hidden columns per shared-memory stage
constexpr int MB_T = 256;
constexpr int MB_LD = MB_H + 8;                   // padded row
constexpr int MB_STAGE = (MB_N + MB_V) * MB_LD;   // one (h, W) slice pair
constexpr size_t MB_SMEM = 2 * MB_STAGE * sizeof(bf16);

__global__ void __launch_bounds__(MB_T)
    ce_partial_mma_kernel(const bf16* __restrict__ h,
                          const bf16* __restrict__ w,
                          float* __restrict__ part_m,
                          float* __restrict__ part_l, int n, int hd, int v,
                          int tiles_per_split) {
  constexpr int LD = MB_LD;
  constexpr int NV = MB_V / 8;          // n8 tiles over a vocab tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* buf = reinterpret_cast<bf16*>(smem_raw);   // two stages
  const int n0 = blockIdx.x * MB_N;
  const int split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_vt = (v + MB_V - 1) / MB_V;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(vt0 + tiles_per_split, n_vt);
  // one step = one hidden slice of one vocab tile; the next step's copies
  // run while the current step's products do
  const int kc = hd / MB_H;
  const int steps = vt1 > vt0 ? (vt1 - vt0) * kc : 0;
  auto fetch = [&](int i) {
    bf16* st = buf + (i & 1) * MB_STAGE;
    const int v0 = (vt0 + i / kc) * MB_V, h0 = (i % kc) * MB_H;
    pt::load_tile_async<MB_N, MB_H, LD, MB_T>(st, h, n0, n, hd, h0);
    pt::load_tile_async<MB_V, MB_H, LD, MB_T>(st + MB_N * LD, w, v0, v, hd,
                                              h0);
  };

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows g, g + 8
  float l[2] = {0.f, 0.f};
  float s[NV][4];
#pragma unroll
  for (int nt = 0; nt < NV; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;

  if (steps > 0) fetch(0);
  pt::commit();
  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) fetch(i + 1);
    pt::commit();
    pt::wait<1>();                     // step i has landed
    __syncthreads();
    const bf16* Hs = buf + (i & 1) * MB_STAGE;
    const bf16* Ws = Hs + MB_N * LD;
#pragma unroll
    for (int kk = 0; kk < MB_H / 16; ++kk) {
      uint32_t a[4];
      const bf16* p = Hs + (warp * 16 + g) * LD + kk * 16 + 2 * t;
      a[0] = pt::ld32(p);
      a[1] = pt::ld32(p + 8 * LD);
      a[2] = pt::ld32(p + 8);
      a[3] = pt::ld32(p + 8 * LD + 8);
#pragma unroll
      for (int nt = 0; nt < NV; ++nt) {
        const bf16* b = Ws + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        pt::mma_bf16(s[nt], a, pt::ld32(b), pt::ld32(b + 8));
      }
    }
    __syncthreads();                   // stage i & 1 free for step i + 2
    if (i % kc != kc - 1) continue;

    // the vocab tile is complete: fold it into the running (m, l)
    const int v0 = (vt0 + i / kc) * MB_V;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NV; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (v0 + nt * 8 + 2 * t + (e & 1) >= v) s[nt][e] = -CUDART_INF_F;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float alpha[2];
    bool live[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float m_new = fmaxf(m[hi], pt::group_max<4>(mx[hi]));
      live[hi] = m_new != -CUDART_INF_F;
      alpha[hi] = m[hi] != -CUDART_INF_F ? expf(m[hi] - m_new) : 0.f;
      m[hi] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NV; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        rs[hi] += live[hi] ? expf(s[nt][e] - m[hi]) : 0.f;
        s[nt][e] = 0.f;
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      l[hi] = alpha[hi] * l[hi] + pt::group_sum<4>(rs[hi]);
  }

  if (t == 0) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = n0 + warp * 16 + g + 8 * hi;
      if (row < n) {
        part_m[(size_t)split * n + row] = m[hi];
        part_l[(size_t)split * n + row] = l[hi];
      }
    }
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
                          float* __restrict__ part_m,
                          float* __restrict__ part_l, int n, int hd, int v,
                          int tiles_per_split) {
  __shared__ float Hs[FB_N][FB_H + 1];
  __shared__ float Ws[FB_V][FB_H + 1];
  const int n0 = blockIdx.x * FB_N;
  const int split = blockIdx.y;
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
      if (row < n) {
        part_m[(size_t)split * n + row] = m[i];
        part_l[(size_t)split * n + row] = l[i];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// merge of the vocab splits
// ---------------------------------------------------------------------------

__global__ void ce_merge_kernel(const float* __restrict__ part_m,
                                const float* __restrict__ part_l,
                                float* __restrict__ logz, int n,
                                int n_split) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float mx = -CUDART_INF_F;
  for (int s = 0; s < n_split; ++s)
    mx = fmaxf(mx, part_m[(size_t)s * n + row]);
  float sum = 0.f;
  if (mx != -CUDART_INF_F) {
    for (int s = 0; s < n_split; ++s) {
      const float ms = part_m[(size_t)s * n + row];
      if (ms != -CUDART_INF_F)
        sum += part_l[(size_t)s * n + row] * expf(ms - mx);
    }
  }
  logz[row] = mx + logf(fmaxf(sum, 1e-30f));
}

}  // namespace

// part_m / part_l: (n_split, n) f32 scratch.  dtype: 0 = float32 (64 x 64
// tiles), 1 = bfloat16 (128 x 128 tiles; hd a multiple of 32, pointers
// 16-byte aligned).  Returns a cudaError_t as int.
extern "C" int pt_ce_logz_fwd(const void* h, const void* w, float* logz,
                              float* part_m, float* part_l, int n, int hd,
                              int v, int n_split, int dtype, void* stream) {
  if (n <= 0 || hd <= 0 || v <= 0 || n_split <= 0 || n_split > 65535 ||
      (dtype != 0 && dtype != 1) || (dtype == 1 && hd % MB_H != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bv = dtype == 1 ? MB_V : FB_V;
  const int bn = dtype == 1 ? MB_N : FB_N;
  const int n_vt = (v + bv - 1) / bv;
  const int per = (n_vt + n_split - 1) / n_split;
  dim3 grid((n + bn - 1) / bn, n_split);
  if (dtype == 1) {
    cudaError_t err = cudaFuncSetAttribute(
        ce_partial_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)MB_SMEM);
    if (err != cudaSuccess) return (int)err;
    ce_partial_mma_kernel<<<grid, MB_T, MB_SMEM, s>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w), part_m,
        part_l, n, hd, v, per);
  } else {
    ce_partial_fma_kernel<<<grid, FB_T, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(w), part_m,
        part_l, n, hd, v, per);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_merge_kernel<<<(n + 255) / 256, 256, 0, s>>>(part_m, part_l, logz, n,
                                                  n_split);
  return (int)cudaGetLastError();
}
