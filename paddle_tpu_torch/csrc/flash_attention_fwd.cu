// Causal / full flash-attention forward for Hopper (sm_90a), bound through
// a plain C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_fwd_kernel` (:190),
// called through `_flash_fwd_folded` (:324).  Same function: blockwise
// online-softmax attention over the folded (B*H, S, D) layout, end-aligned
// causal mask (query i sees key j iff j <= i + sk - sq), key/value tiles
// past the diagonal skipped, key tails (k_idx >= sk) scored -inf, and a row
// with no visible key written as out = 0, lse = -inf.  Outputs `out`
// (B*H, Sq, D) in the input dtype and `lse` (B*H, Sq) f32.  As in the TPU
// kernel, p is rounded to the value dtype before the p.v product and the
// row sum l adds the unrounded p.
//
// Design.  One block per (bh, 64-row query tile); the TPU kernel's
// sequential kv grid axis becomes a loop inside the block over 64-key
// tiles, with the running (max, sum, acc) of each row in registers.
//  - bf16 (the model's path): 4 warps, each owning 16 query rows.  Both
//    products run on the tensor cores as mma.sync m16n8k16 (bf16 in, f32
//    accumulate).  q's fragments stay in registers for the whole loop; k
//    and v tiles are staged in shared memory by cp.async in two stages, so
//    the next tile's copies overlap the current tile's products.  The
//    score fragment of one tile becomes, rounded to bf16, the A operand of
//    the p.v product without leaving registers (the C layout of two
//    adjacent n8 tiles is the A layout of one k16 step).  Row max and sum
//    reduce over the 4 lanes that share a row.  The softmax runs in base 2
//    on the special-function unit (ex2.approx), as FlashAttention-2 does:
//    with 16 exponentials per thread for every 64 products per warp, the
//    accurate expf would cost about as much as the products.
//  - f32 (tests and the small reference model): 256 threads, tiles staged
//    as f32, each thread a 4x4 patch of the score tile and a 4 x D/16 patch
//    of the output, products on the f32 FMA units.
//
// What bounds it.  The causal work at GPT-2 345M shapes (B*H = 8*16,
// S = 1024, D = 64) is 4*B*H*D*S(S+1)/2 = 17.2 GFLOP per layer: 17 us at
// the card's 989 TFLOP/s bf16 tensor-core peak; its bytes (q, k, v, out in
// bf16 plus lse: 67 MB) take 20 us at 3.35 TB/s, so bytes bound it by a
// hair.  mma.sync reaches only part of the tensor-core peak; wgmma fed by
// TMA, with warp-specialised producers, is the full-rate path and the next
// step.
#include "common.cuh"

namespace {

using pt::bf16;

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per tile

__device__ __forceinline__ int kv_tiles(int q0, int sk, int off,
                                        int causal) {
  int n_kb = (sk + BK - 1) / BK;
  if (causal) {
    // end-aligned diagonal: tile kb is needed iff kb*BK < q0 + BQ + off
    const int lim = q0 + BQ + off;
    const int need = lim <= 0 ? 0 : (lim + BK - 1) / BK;
    n_kb = need < n_kb ? need : n_kb;
  }
  return n_kb;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 query rows

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (size_t)(BQ + 4 * BK) * (D + 8);   // q + 2 x (k, v)
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
    fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int causal,
                      float scale) {
  constexpr int LD = D + 8;          // padded row: conflict-free fragments
  constexpr int KD = D / 16;         // k16 steps over the head dim
  constexpr int ND = D / 8;          // n8 tiles over the head dim
  constexpr int NK = BK / 8;         // n8 tiles over a key tile
  constexpr int STAGE = 2 * BK * LD; // one (k, v) tile pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KV = Qs + BQ * LD;           // two stages of (k, v)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const bf16* qb = q + (size_t)bh * sq * D;
  const bf16* kbp = k + (size_t)bh * sk * D;
  const bf16* vbp = v + (size_t)bh * sk * D;
  const int n_kb = kv_tiles(q0, sk, off, causal);

  // the next tile's copies run while the current tile's products do
  auto fetch = [&](int kb) {
    bf16* st = KV + (kb & 1) * STAGE;
    pt::load_tile_async<BK, D, LD, MMA_THREADS>(st, kbp, kb * BK, sk, D, 0);
    pt::load_tile_async<BK, D, LD, MMA_THREADS>(st + BK * LD, vbp, kb * BK,
                                                sk, D, 0);
  };
  pt::load_tile_async<BQ, D, LD, MMA_THREADS>(Qs, qb, q0, sq, D, 0);
  pt::commit();
  if (n_kb > 0) fetch(0);
  pt::commit();
  pt::wait<1>();                     // q has landed
  __syncthreads();
  const int r0 = warp * 16;
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const bf16* p = Qs + (r0 + g) * LD + kk * 16 + 2 * t;
    qa[kk][0] = pt::ld32(p);
    qa[kk][1] = pt::ld32(p + 8 * LD);
    qa[kk][2] = pt::ld32(p + 8);
    qa[kk][3] = pt::ld32(p + 8 * LD + 8);
  }

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // rows g, g + 8
  float l[2] = {0.f, 0.f};
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  // scores, m and the exponentials in base 2: p = 2^(x log2e - m log2e)
  const float scale2 = scale * 1.4426950408889634f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    if (kb + 1 < n_kb) fetch(kb + 1);
    pt::commit();
    pt::wait<1>();                   // tile kb has landed
    __syncthreads();
    const bf16* Ks = KV + (kb & 1) * STAGE;
    const bf16* Vs = Ks + BK * LD;

    float s[NK][4];
#pragma unroll
    for (int nt = 0; nt < NK; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const bf16* p = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        pt::mma_bf16(s[nt], qa[kk], pt::ld32(p), pt::ld32(p + 8));
      }
    }

    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        float x = s[nt][e] * scale2;
        if (key >= sk || (causal && qrow[hi] + off < key)) x = -CUDART_INF_F;
        s[nt][e] = x;
        mx[hi] = fmaxf(mx[hi], x);
      }
    float alpha[2];
    bool live[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const float m_new = fmaxf(m[hi], pt::group_max<4>(mx[hi]));
      live[hi] = m_new != -CUDART_INF_F;
      alpha[hi] = m[hi] != -CUDART_INF_F ? pt::ex2(m[hi] - m_new) : 0.f;
      m[hi] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1;
        const float p = live[hi] ? pt::ex2(s[nt][e] - m[hi]) : 0.f;
        s[nt][e] = p;
        rs[hi] += p;
      }
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
      l[hi] = alpha[hi] * l[hi] + pt::group_sum<4>(rs[hi]);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      acc[dn][0] *= alpha[0];
      acc[dn][1] *= alpha[0];
      acc[dn][2] *= alpha[1];
      acc[dn][3] *= alpha[1];
    }

#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pt::pack_bf16(s[2 * j][0], s[2 * j][1]);
      pa[1] = pt::pack_bf16(s[2 * j][2], s[2 * j][3]);
      pa[2] = pt::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pt::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const bf16* p = Vs + (j * 16 + 2 * t) * LD + dn * 8 + g;
        pt::mma_bf16(acc[dn], pa, pt::pack_col(p, LD),
                     pt::pack_col(p + 8 * LD, LD));
      }
    }
    __syncthreads();                 // stage kb & 1 free for tile kb + 2
  }

  bf16* ob = o + (size_t)bh * sq * D;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    if (qrow[hi] >= sq) continue;
    const float den = fmaxf(l[hi], 1e-30f);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qrow[hi] * D + dn * 8 +
                                   2 * t) =
          pt::pack_bf16(acc[dn][2 * hi] / den, acc[dn][2 * hi + 1] / den);
    if (t == 0)
      lse[(size_t)bh * sq + qrow[hi]] =
          l[hi] > 0.f ? (m[hi] + log2f(den)) * 0.6931471805599453f
                      : -CUDART_INF_F;
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;   // 16 x 16 threads, 4x4 score patches

template <int D>
constexpr size_t fma_smem_bytes() {
  return sizeof(float) *
         (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
    fa_fwd_fma_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, int sq, int sk, int causal,
                      float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int CD = D / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // BQ x DP
  float* Ks = Qs + BQ * DP;             // BK x DP
  float* Vs = Ks + BK * DP;             // BK x D
  float* Ps = Vs + BK * D;              // BQ x PP

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int off = sk - sq;
  const size_t qbase = (size_t)bh * sq * D;
  const size_t kbase = (size_t)bh * sk * D;

  for (int e = tid; e < BQ * D; e += FMA_THREADS) {
    const int r = e / D, c = e % D, row = q0 + r;
    Qs[r * DP + c] = row < sq ? q[qbase + (size_t)row * D + c] : 0.f;
  }

  float acc[4][CD];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_kb = kv_tiles(q0, sk, off, causal);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                    // previous tile fully consumed
    for (int e = tid; e < BK * D; e += FMA_THREADS) {
      const int r = e / D, c = e % D, row = k0 + r;
      const bool ok = row < sk;
      const size_t gi = kbase + (size_t)row * D + c;
      Ks[r * DP + c] = ok ? k[gi] : 0.f;
      Vs[r * D + c] = ok ? v[gi] : 0.f;   // tail rows never reach p.v
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kc >= sk || (causal && qrow + off < kc)) x = -CUDART_INF_F;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], pt::group_max<16>(mx));
      const bool live = m_new != -CUDART_INF_F;
      const float alpha = m[i] != -CUDART_INF_F ? expf(m[i] - m_new) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
      }
      l[i] = alpha * l[i] + pt::group_sum<16>(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < CD; ++c)
      o[qbase + (size_t)qrow * D + tx + 16 * c] = acc[i][c] / den;
    if (tx == 0)
      lse[(size_t)bh * sq + qrow] =
          l[i] > 0.f ? m[i] + logf(den) : -CUDART_INF_F;
  }
}

template <int D>
cudaError_t launch(bool mma, const void* q, const void* k, const void* v,
                   void* o, float* lse, int bh, int sq, int sk, int causal,
                   float scale, cudaStream_t stream) {
  const size_t smem = mma ? mma_smem_bytes<D>() : fma_smem_bytes<D>();
  const void* fn = mma ? (const void*)fa_fwd_mma_kernel<D>
                       : (const void*)fa_fwd_fma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  if (mma)
    fa_fwd_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk,
        causal, scale);
  else
    fa_fwd_fma_kernel<D><<<grid, FMA_THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk,
        causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bf16 pointers must be 16-byte aligned.
// Returns a cudaError_t as int.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int bh, int sq, int sk, int d,
                                      int dtype, int causal, float scale,
                                      void* stream) {
  if (bh <= 0 || bh > 65535 || sq <= 0 || sk <= 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = dtype == 1;
  if (d == 64)
    return (int)launch<64>(mma, q, k, v, o, lse, bh, sq, sk, causal, scale, s);
  if (d == 128)
    return (int)launch<128>(mma, q, k, v, o, lse, bh, sq, sk, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
