// Flash-attention bias gradient for Hopper (sm_90a), bound through a plain
// C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd_dbias_kernel`
// (:560), called through `_dbias_call` (:698, the pallas_call at :743).
// Same function: d(bias) = ds = p * (dp - delta), with p rebuilt from the
// forward's lse and the masked score (s * scale + bias, -inf where the
// segment ids differ, then the causal mask; pt::SliceMask::apply), dp =
// do.v^T and delta = rowsum(do * o) from the backward, summed in f32 over
// the bias's broadcast extent: the folded (b, h) slices that read one bias
// slice g (bh = g * mg + r * mr for r < n_r, as `_dbias_call` :707-714 maps
// them) and, when the bias has one query row (Sqb = 1), the query rows as
// well.  Output (Bb*Hb, Sqb, Sk) in the bias's dtype, f32 or bf16.  A row
// with lse = -inf (no visible key) contributes 0.
//
// Design.  One block per output tile: a (64 query x 64 key) tile of slice
// g when Sqb = Sq, a 64-key row segment of slice g when Sqb = 1.  The TPU
// grid's two reduction axes (r and, for Sqb = 1, the query tiles) become
// one loop inside the block; the (q, do, k, v) tiles of each step are
// double-buffered with cp.async, and ds accumulates in f32 registers.
// Each output entry is written once, by one block, after the loop: no
// atomics, the result is deterministic.  For Sqb = 1 each thread first sums
// its rows, then the lanes of a warp meet in a fixed shuffle tree and the
// four warps in shared memory, in order.
//  - bf16 q, k, v (the model's path): 4 warps, each owning 16 query rows of
//    the tile; s = q.k^T and dp = do.v^T run on the tensor cores as
//    mma.sync m16n8k16 (bf16 in, f32 accumulate), the exponential in base 2
//    on ex2.approx.  ds stays in f32: the reference sums unrounded ds.
//  - f32: 256 threads, each a 4x4 patch of the tile, products on the FMA
//    units.
//
// What bounds it.  At the learned-bias encoder's shape (a (1, 12, 128, 128)
// bias, B = 128, H = 12, S = 128, D = 64, bf16) it reads q, k, v and do
// once (101 MB: 30 us at 3.35 TB/s) and does two products over every
// (query, key) pair, 6.4 GFLOP (6.5 us at 989 TFLOP/s): bytes bound it.
// The grid has only Bb*Hb*(Sqb/64)*(Sk/64) blocks (48 there), each looping
// over 128 slices, so it runs far from that bound; splitting the reduced
// extent over more blocks, with a second deterministic pass to sum the
// parts, is the next step.
#include "common.cuh"

namespace {

using pt::bf16;

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr float LOG2E = 1.4426950408889634f;

// lse of a row in the exponent's units, +inf for a row with no visible key
// (exp(s - inf) = 0, as the reference's row guard gives)
__device__ __forceinline__ float lse_or_inf(const float* lse, int row,
                                            float unit) {
  const float l = lse[row];
  return l == -CUDART_INF_F ? CUDART_INF_F : l * unit;
}

__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld,
                                       int r0, int c0, int g, int t) {
  const bf16* p = s + (r0 + g) * ld + c0 + 2 * t;
  a[0] = pt::ld32(p);
  a[1] = pt::ld32(p + 8 * ld);
  a[2] = pt::ld32(p + 8);
  a[3] = pt::ld32(p + 8 * ld + 8);
}

__device__ __forceinline__ void put(void* db, int out_bf16, size_t i,
                                    float x) {
  if (out_bf16)
    pt::store(static_cast<bf16*>(db) + i, x);
  else
    pt::store(static_cast<float*>(db) + i, x);
}

// the folded (b, h) slices reduced into bias slice g: bh = g * mg + r * mr
struct Reduce {
  int mg, mr, n_r;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem() {      // two stages of (q, do, k, v)
  return sizeof(bf16) * (size_t)2 * (2 * BQ + 2 * BK) * (D + 8);
}

template <int D, bool SQ_FULL>
__global__ void __launch_bounds__(MMA_THREADS)
    dbias_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, pt::AttnMask mask,
                     void* __restrict__ db, int out_bf16, Reduce red, int sq,
                     int sk, int causal, float scale) {
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;         // k16 steps over the head dim
  constexpr int NK = BK / 8;         // n8 tiles over a key tile
  constexpr int STAGE = (2 * BQ + 2 * BK) * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* st0 = reinterpret_cast<bf16*>(smem_raw);
  __shared__ float part[4][BK];      // Sqb = 1: the warps' column sums

  const int g_out = blockIdx.z;
  const int k0 = blockIdx.y * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const int n_qt = SQ_FULL ? 1 : sq / BQ;
  const int n_it = red.n_r * n_qt;
  const float scale2 = scale * LOG2E;

  // step it: slice r = it / n_qt, query tile it % n_qt (or the block's own)
  auto q_tile = [&](int it) {
    return SQ_FULL ? (int)blockIdx.x : it % n_qt;
  };
  auto slice = [&](int it) { return g_out * red.mg + (it / n_qt) * red.mr; };
  auto fetch = [&](int it) {
    bf16* st = st0 + (it & 1) * STAGE;
    const int bh = slice(it), q0 = q_tile(it) * BQ;
    const size_t qb = (size_t)bh * sq * D, kb = (size_t)bh * sk * D;
    pt::load_tile_async<BQ, D, LD, MMA_THREADS>(st, q + qb, q0, sq, D, 0);
    pt::load_tile_async<BQ, D, LD, MMA_THREADS>(st + BQ * LD, dout + qb, q0,
                                                sq, D, 0);
    pt::load_tile_async<BK, D, LD, MMA_THREADS>(st + 2 * BQ * LD, k + kb, k0,
                                                sk, D, 0);
    pt::load_tile_async<BK, D, LD, MMA_THREADS>(st + (2 * BQ + BK) * LD,
                                                v + kb, k0, sk, D, 0);
  };

  float acc[NK][4];
#pragma unroll
  for (int nt = 0; nt < NK; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  const int r0 = warp * 16;
  fetch(0);
  pt::commit();
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) fetch(it + 1);
    pt::commit();
    pt::wait<1>();                   // step it has landed
    __syncthreads();
    const bf16* Qs = st0 + (it & 1) * STAGE;
    const bf16* Os = Qs + BQ * LD;
    const bf16* Ks = Os + BQ * LD;
    const bf16* Vs = Ks + BK * LD;
    const int bh = slice(it), q0 = q_tile(it) * BQ;
    const pt::SliceMask sm = pt::slice_mask(mask, bh, sq, sk);
    const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
    float lse2[2], dl[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      lse2[hi] = lse_or_inf(lse + (size_t)bh * sq, qrow[hi], LOG2E);
      dl[hi] = delta[(size_t)bh * sq + qrow[hi]];
    }

    // s = q.k^T and dp = do.v^T, 16 x 64 per warp
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[4], oa[4];
      load_a(qa, Qs, LD, r0, kk * 16, g, t);
      load_a(oa, Os, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NK; ++nt) {
        const bf16* pk = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        pt::mma_bf16(s[nt], qa, pt::ld32(pk), pt::ld32(pk + 8));
        const bf16* pv = Vs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        pt::mma_bf16(dp[nt], oa, pt::ld32(pv), pt::ld32(pv + 8));
      }
    }

    // acc += ds = p * (dp - delta)
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        const float x = sm.apply(s[nt][e] * scale2, qrow[hi], key, LOG2E);
        const bool keep = !(causal && qrow[hi] + off < key);
        const float p = keep ? pt::ex2(x - lse2[hi]) : 0.f;
        acc[nt][e] += p * (dp[nt][e] - dl[hi]);
      }
    __syncthreads();                 // stage it & 1 free for step it + 2
  }
  pt::wait<0>();

  if (SQ_FULL) {
    const int q0 = blockIdx.x * BQ;
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = q0 + r0 + g + 8 * (e >> 1);
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        put(db, out_bf16, ((size_t)g_out * sq + row) * sk + key, acc[nt][e]);
      }
    return;
  }
  // Sqb = 1: sum the rows.  Lanes (g, t) share columns with the other seven
  // g of their t: a fixed shuffle tree over lane bits 2-4, then the warps
  // in order.
#pragma unroll
  for (int nt = 0; nt < NK; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float x = acc[nt][c] + acc[nt][2 + c];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (g == 0) part[warp][nt * 8 + 2 * t + c] = x;
    }
  __syncthreads();
  if (threadIdx.x < BK) {
    const int c = threadIdx.x;
    const float x = ((part[0][c] + part[1][c]) + part[2][c]) + part[3][c];
    put(db, out_bf16, (size_t)g_out * sk + k0 + c, x);
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;   // 16 x 16 threads, 4x4 tile patches

template <int D>
constexpr size_t fma_smem() {      // q, do, k, v
  return sizeof(float) * (size_t)4 * 64 * (D + 1);
}

template <int D, bool SQ_FULL>
__global__ void __launch_bounds__(FMA_THREADS)
    dbias_fma_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, pt::AttnMask mask,
                     void* __restrict__ db, int out_bf16, Reduce red, int sq,
                     int sk, int causal, float scale) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                  // BQ x DP
  float* Os = Qs + BQ * DP;          // BQ x DP (do)
  float* Ks = Os + BQ * DP;          // BK x DP
  float* Vs = Ks + BK * DP;          // BK x DP
  __shared__ float part[16][BK];     // Sqb = 1: the thread rows' sums

  const int g_out = blockIdx.z;
  const int k0 = blockIdx.y * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int off = sk - sq;
  const int n_qt = SQ_FULL ? 1 : sq / BQ;
  const int n_it = red.n_r * n_qt;

  float acc[4][4];                   // rows ty + 16i, keys tx + 16j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int bh = g_out * red.mg + (it / n_qt) * red.mr;
    const int q0 = (SQ_FULL ? (int)blockIdx.x : it % n_qt) * BQ;
    const size_t qb = (size_t)bh * sq * D, kb = (size_t)bh * sk * D;
    __syncthreads();                 // previous step fully consumed
    for (int e = tid; e < BQ * D; e += FMA_THREADS) {
      const int r = e / D, c = e % D;
      Qs[r * DP + c] = q[qb + (size_t)(q0 + r) * D + c];
      Os[r * DP + c] = dout[qb + (size_t)(q0 + r) * D + c];
      Ks[r * DP + c] = k[kb + (size_t)(k0 + r) * D + c];
      Vs[r * DP + c] = v[kb + (size_t)(k0 + r) * D + c];
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], o[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * DP + d];
        o[i] = Os[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Ks[(tx + 16 * j) * DP + d];
        w[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
        }
    }
    const pt::SliceMask sm = pt::slice_mask(mask, bh, sq, sk);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
      const float lr = lse_or_inf(lse + (size_t)bh * sq, qrow, 1.f);
      const float dl = delta[(size_t)bh * sq + qrow];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        const float x = sm.apply(s[i][j] * scale, qrow, key, 1.f);
        const bool keep = !(causal && qrow + off < key);
        const float p = keep ? expf(x - lr) : 0.f;
        acc[i][j] += p * (dp[i][j] - dl);
      }
    }
  }

  if (SQ_FULL) {
    const int q0 = blockIdx.x * BQ;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        put(db, out_bf16,
            ((size_t)g_out * sq + q0 + ty + 16 * i) * sk + k0 + tx + 16 * j,
            acc[i][j]);
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    part[ty][tx + 16 * j] =
        ((acc[0][j] + acc[1][j]) + acc[2][j]) + acc[3][j];
  __syncthreads();
  if (tid < BK) {
    float x = 0.f;
    for (int r = 0; r < 16; ++r) x += part[r][tid];
    put(db, out_bf16, (size_t)g_out * sk + k0 + tid, x);
  }
}

template <int D, bool SQ_FULL>
cudaError_t launch(bool mma, const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const pt::AttnMask& mask, void* db, Reduce red, int n_g,
                   int sq, int sk, int causal, float scale,
                   cudaStream_t stream) {
  const size_t smem = mma ? mma_smem<D>() : fma_smem<D>();
  const void* fn = mma ? (const void*)dbias_mma_kernel<D, SQ_FULL>
                       : (const void*)dbias_fma_kernel<D, SQ_FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(SQ_FULL ? sq / BQ : 1, sk / BK, n_g);
  if (mma)
    dbias_mma_kernel<D, SQ_FULL><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, mask, db, mask.bias_bf16, red, sq, sk, causal, scale);
  else
    dbias_fma_kernel<D, SQ_FULL><<<grid, FMA_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, mask, db, mask.bias_bf16, red, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(bool mma, const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const pt::AttnMask& mask, void* db, Reduce red, int n_g,
                     int sq, int sk, int causal, float scale,
                     cudaStream_t stream) {
  if (mask.sqb > 1)
    return launch<D, true>(mma, q, k, v, dout, lse, delta, mask, db, red,
                           n_g, sq, sk, causal, scale, stream);
  return launch<D, false>(mma, q, k, v, dout, lse, delta, mask, db, red, n_g,
                          sq, sk, causal, scale, stream);
}

}  // namespace

// q, k, v, dout: (bh, s, d) in dtype (0 = float32, 1 = bfloat16); lse and
// delta (bh, sq) f32; bias (bb*hb, sqb, sk) f32 or bf16 (bias_bf16), the
// one the forward added; qseg, kseg int32 segment ids or null; db receives
// (bb*hb, sqb, sk) in the bias's dtype.  sq and sk must be multiples of 64.
// Returns a cudaError_t as int.
extern "C" int pt_flash_attention_dbias(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* bias, const int* qseg,
    const int* kseg, void* db, int bh, int sq, int sk, int d, int dtype,
    int causal, int bias_bf16, int bb, int hb, int sqb, int heads,
    float scale, void* stream) {
  const pt::AttnMask mask =
      pt::make_mask(bias, qseg, kseg, bias_bf16, bb, hb, sqb, heads);
  if (bias == nullptr || bh <= 0 || sq <= 0 || sk <= 0 ||
      (dtype != 0 && dtype != 1) || (d != 64 && d != 128) ||
      pt::bad_mask(mask, bh, sq, sk, BQ) || pt::slice_chunk(mask) <= 0 ||
      (bb == 1 && hb > pt::MAX_GRID_Y) || sk / BK > 65535)
    return (int)cudaErrorInvalidValue;
  // the folded slices one bias slice g sums (reference `_dbias_call`)
  const int b = bh / heads;
  Reduce red;
  if (bb == 1 && hb == 1)
    red = Reduce{0, 1, b * heads};
  else if (bb == 1)
    red = Reduce{1, heads, b};       // g = head, reduce over the batch
  else if (hb == 1)
    red = Reduce{heads, 1, heads};   // g = batch, reduce over the heads
  else
    red = Reduce{1, 0, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = dtype == 1;
  const size_t es = mma ? 2 : 4, bs = bias_bf16 ? 2 : 4;
  // more than MAX_GRID_Y bias slices (grid z) only when each slice is one
  // folded slice (g = bh) or one batch entry (g = b): chunks of them, the
  // first slice a multiple of heads
  const int n_g = bb * hb;
  const int chunk = red.mg == 1 && red.mr == 0 ? pt::slice_chunk(mask)
                                               : pt::MAX_GRID_Y;
  return pt::for_each_chunk(mask, n_g, chunk, red.mg, sq, sk,
                            [&](int g0, int n, const pt::AttnMask& m) {
    const int bh0 = g0 * red.mg;
    const size_t qo = (size_t)bh0 * sq * d, ko = (size_t)bh0 * sk * d;
    const void *qc = pt::advance(q, qo, es), *kc = pt::advance(k, ko, es),
               *vc = pt::advance(v, ko, es), *oc = pt::advance(dout, qo, es);
    const float *lc = lse + (size_t)bh0 * sq, *dc = delta + (size_t)bh0 * sq;
    void* gc = pt::advance(db, (size_t)g0 * sqb * sk, bs);
    return d == 64 ? launch_d<64>(mma, qc, kc, vc, oc, lc, dc, m, gc, red,
                                  n, sq, sk, causal, scale, s)
                   : launch_d<128>(mma, qc, kc, vc, oc, lc, dc, m, gc, red,
                                   n, sq, sk, causal, scale, s);
  });
}
