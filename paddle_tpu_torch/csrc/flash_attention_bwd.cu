// Causal / full flash-attention backward for Hopper (sm_90a): the dq kernel
// and the dk/dv kernel, with an optional additive bias and segment ids,
// bound through a plain C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd_dq_kernel`
// (:452) and `_bwd_dkv_kernel` (:498), called through `_flash_bwd_folded`
// (:606-695, without the dbias branch), with `_rebuild_p` (:396) and
// `_tail_zero` (:446) folded into the tile loads and masks.  Same function
// over the folded (B*H, S, D) layout: the probability tile is rebuilt from
// the forward's lse, p = exp(q.k^T * scale - lse), masked as the forward
// masks it (end-aligned causal: query i sees key j iff j <= i + sk - sq;
// keys past sk), a row with lse = -inf gives p = 0 and so zero gradients;
// dp = do.v^T and ds = p * (dp - delta) with delta = rowsum(do * o), which
// the caller computes (an O(S*D) precompute, as the reference does in
// XLA).  Then dq = ds.k * scale, dk = ds^T.q * scale, dv = p^T.do.  As in
// the TPU kernels, p and ds are rounded to the input dtype before the
// products that take them, and every product accumulates in f32.
//
// Masks (the MASKED instantiations): p is rebuilt from the masked score as
// the forward builds it (pt::SliceMask::apply: s * scale + bias, -inf where
// the segment ids differ, then the causal and tail masks), the reference's
// `_rebuild_p` with `_mask_tile`.  The bias's own gradient is the separate
// kernel of csrc/flash_attention_dbias.cu.
//
// Design.  The TPU grid's sequential reduction axis (kv for dq, q for
// dk/dv) becomes a loop inside the block, with the accumulator in
// registers; blocks of one grid run in parallel on the SMs, so nothing is
// carried between them and no atomics are needed: each output tile is
// written once, by one block, and the result is deterministic.
//  - dq: one block per (bh, 64-row query tile).  It loops over 64-key
//    tiles up to the end-aligned causal diagonal; the tile loop is the
//    forward's, k and v double-buffered with cp.async.
//  - dk/dv: one block per (bh, 64-key tile).  It loops over query tiles
//    from the first whose rows see one of its keys to the end, q and do
//    double-buffered with cp.async, lse and delta staged in shared memory.
//  - bf16 (the model's path): 4 warps, each owning 16 rows of the block's
//    tile (queries for dq, keys for dk/dv); every product runs on the
//    tensor cores as mma.sync m16n8k16 (bf16 in, f32 accumulate).  The
//    score and dp fragments become, rounded to bf16, the A operand of the
//    next product without leaving registers (the C layout of two adjacent
//    n8 tiles is the A layout of one k16 step).  The exponentials run in
//    base 2 on ex2.approx.  For D = 128 the dk/dv kernel takes 32-row
//    query tiles, so that the two 16 x 128 f32 accumulators of a warp, and
//    the score and dp tiles, stay in registers without spilling.
//  - f32 (tests and the small reference model): 256 threads, tiles staged
//    as f32, products on the FMA units.
//
// What bounds it.  At GPT-2 345M shapes (B*H = 128, S = 1024, D = 64,
// causal) the backward does five products over the visible (query, key)
// pairs, 2.5 times the forward's 17.2 GFLOP: 43 GFLOP, 43 us at the
// card's 989 TFLOP/s bf16 tensor-core peak; its bytes (q, k, v, o, do,
// dq, dk, dv in bf16 plus lse and delta) take 40 us at 3.35 TB/s, so
// operations bound it by a little.  mma.sync with operands read from
// shared memory reaches only part of that peak; wgmma fed by TMA is the
// next step.
#include "common.cuh"

namespace {

using pt::bf16;

constexpr int BQ = 64;    // query rows per dq block (and per f32 q tile)
constexpr int BK = 64;    // keys per tile (dq loop) and per dk/dv block
constexpr float LOG2E = 1.4426950408889634f;

// key tiles the query tile [q0, q0 + BQ) needs: up to the diagonal
__device__ __forceinline__ int kv_tiles(int q0, int sk, int off,
                                        int causal) {
  int n_kb = (sk + BK - 1) / BK;
  if (causal) {
    const int lim = q0 + BQ + off;   // tile kb is needed iff kb*BK < lim
    const int need = lim <= 0 ? 0 : (lim + BK - 1) / BK;
    n_kb = need < n_kb ? need : n_kb;
  }
  return n_kb;
}

// first query tile of QT rows that sees a key of the tile starting at k0:
// tile i is needed iff k0 < (i + 1) * QT + off
__device__ __forceinline__ int first_q_tile(int k0, int off, int causal,
                                            int qt) {
  if (!causal) return 0;
  const int lim = k0 - off - qt + 1;
  return lim <= 0 ? 0 : (lim + qt - 1) / qt;
}

// lse of a row in the exponent's units, with +inf marking a row that must
// give p = 0 (no visible key, or past sq): exp(s - inf) = 0 without a NaN
__device__ __forceinline__ float lse_or_inf(const float* lse, int row,
                                            int sq, float unit) {
  if (row >= sq) return CUDART_INF_F;
  const float l = lse[row];
  return l == -CUDART_INF_F ? CUDART_INF_F : l * unit;
}

// A fragment of one k16 step from the C fragments of two n8 tiles
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pt::pack_bf16(c0[0], c0[1]);
  a[1] = pt::pack_bf16(c0[2], c0[3]);
  a[2] = pt::pack_bf16(c1[0], c1[1]);
  a[3] = pt::pack_bf16(c1[2], c1[3]);
}

// A fragment of rows [r0, r0 + 16) x columns [c0, c0 + 16) of a bf16 tile
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* s, int ld,
                                       int r0, int c0, int g, int t) {
  const bf16* p = s + (r0 + g) * ld + c0 + 2 * t;
  a[0] = pt::ld32(p);
  a[1] = pt::ld32(p + 8 * ld);
  a[2] = pt::ld32(p + 8);
  a[3] = pt::ld32(p + 8 * ld + 8);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int MMA_THREADS = 128;   // 4 warps x 16 rows

template <int D>
constexpr size_t dq_mma_smem() {
  return sizeof(bf16) * (size_t)(2 * BQ + 4 * BK) * (D + 8);  // q, do, 2x(k, v)
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(MMA_THREADS)
    fa_bwd_dq_mma_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         pt::AttnMask mask, bf16* __restrict__ dq, int sq,
                         int sk, int causal, float scale) {
  constexpr int LD = D + 8;          // padded row: conflict-free fragments
  constexpr int KD = D / 16;         // k16 steps over the head dim
  constexpr int ND = D / 8;          // n8 tiles over the head dim
  constexpr int NK = BK / 8;         // n8 tiles over a key tile
  constexpr int STAGE = 2 * BK * LD; // one (k, v) tile pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Os = Qs + BQ * LD;           // do
  bf16* KV = Os + BQ * LD;           // two stages of (k, v)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const size_t qbase = (size_t)bh * sq * D;
  const bf16* kbp = k + (size_t)bh * sk * D;
  const bf16* vbp = v + (size_t)bh * sk * D;
  const int n_kb = kv_tiles(q0, sk, off, causal);
  const pt::SliceMask sm = pt::slice_mask(mask, bh, sq, sk);

  auto fetch = [&](int kb) {
    bf16* st = KV + (kb & 1) * STAGE;
    pt::load_tile_async<BK, D, LD, MMA_THREADS>(st, kbp, kb * BK, sk, D, 0);
    pt::load_tile_async<BK, D, LD, MMA_THREADS>(st + BK * LD, vbp, kb * BK,
                                                sk, D, 0);
  };
  // query rows past sq arrive as zeros (the reference's _tail_zero)
  pt::load_tile_async<BQ, D, LD, MMA_THREADS>(Qs, q + qbase, q0, sq, D, 0);
  pt::load_tile_async<BQ, D, LD, MMA_THREADS>(Os, dout + qbase, q0, sq, D,
                                              0);
  pt::commit();
  if (n_kb > 0) fetch(0);
  pt::commit();

  const int r0 = warp * 16;
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float lse2[2], dl[2];
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    lse2[hi] = lse_or_inf(lse + (size_t)bh * sq, qrow[hi], sq, LOG2E);
    dl[hi] = qrow[hi] < sq ? delta[(size_t)bh * sq + qrow[hi]] : 0.f;
  }
  const float scale2 = scale * LOG2E;

  float acc[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    if (kb + 1 < n_kb) fetch(kb + 1);
    pt::commit();
    pt::wait<1>();                   // q, do and tile kb have landed
    __syncthreads();
    const bf16* Ks = KV + (kb & 1) * STAGE;
    const bf16* Vs = Ks + BK * LD;

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

    // ds = p * (dp - delta), kept in s
#pragma unroll
    for (int nt = 0; nt < NK; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t + (e & 1);
        const int hi = e >> 1;
        const bool keep = key < sk && !(causal && qrow[hi] + off < key);
        float x = s[nt][e] * scale2;
        if (MASKED) x = sm.apply(x, qrow[hi], key, LOG2E);
        const float p = keep ? pt::ex2(x - lse2[hi]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[hi]);
      }

    // dq += ds.k: ds rounded to bf16 as the A operand, k read down columns
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      uint32_t da[4];
      c_to_a(da, s[2 * j], s[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const bf16* pk = Ks + (j * 16 + 2 * t) * LD + dn * 8 + g;
        pt::mma_bf16(acc[dn], da, pt::pack_col(pk, LD),
                     pt::pack_col(pk + 8 * LD, LD));
      }
    }
    __syncthreads();                 // stage kb & 1 free for tile kb + 2
  }
  pt::wait<0>();

  bf16* ob = dq + qbase;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    if (qrow[hi] >= sq) continue;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<uint32_t*>(ob + (size_t)qrow[hi] * D + dn * 8 +
                                   2 * t) =
          pt::pack_bf16(acc[dn][2 * hi] * scale, acc[dn][2 * hi + 1] * scale);
  }
}

// query rows per tile of the dk/dv loop: 32 at D = 128 keeps the two
// 16 x D accumulators of a warp and its score / dp tiles in registers
template <int D>
constexpr int DKV_QT = D == 64 ? 64 : 32;

template <int D>
constexpr size_t dkv_mma_smem() {
  return sizeof(bf16) * (size_t)(2 * BK + 4 * DKV_QT<D>) * (D + 8) +
         sizeof(float) * 2 * DKV_QT<D>;          // k, v, 2x(q, do), lse, delta
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(MMA_THREADS)
    fa_bwd_dkv_mma_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const bf16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          pt::AttnMask mask, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int sq, int sk, int causal,
                          float scale) {
  constexpr int QT = DKV_QT<D>;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NQ = QT / 8;         // n8 tiles over a query tile
  constexpr int STAGE = 2 * QT * LD; // one (q, do) tile pair
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + BK * LD;
  bf16* QO = Vs + BK * LD;           // two stages of (q, do)
  float* Ls = reinterpret_cast<float*>(QO + 2 * STAGE);   // lse, delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int off = sk - sq;
  const size_t kbase = (size_t)bh * sk * D;
  const bf16* qbp = q + (size_t)bh * sq * D;
  const bf16* obp = dout + (size_t)bh * sq * D;
  const float* lb = lse + (size_t)bh * sq;
  const float* db = delta + (size_t)bh * sq;
  const int first = first_q_tile(k0, off, causal, QT);
  const int n_qb = (sq + QT - 1) / QT;
  const pt::SliceMask sm = pt::slice_mask(mask, bh, sq, sk);

  auto fetch = [&](int qi) {
    bf16* st = QO + (qi & 1) * STAGE;
    pt::load_tile_async<QT, D, LD, MMA_THREADS>(st, qbp, qi * QT, sq, D, 0);
    pt::load_tile_async<QT, D, LD, MMA_THREADS>(st + QT * LD, obp, qi * QT,
                                                sq, D, 0);
  };
  // key rows past sk arrive as zeros (the reference's _tail_zero)
  pt::load_tile_async<BK, D, LD, MMA_THREADS>(Ks, k + kbase, k0, sk, D, 0);
  pt::load_tile_async<BK, D, LD, MMA_THREADS>(Vs, v + kbase, k0, sk, D, 0);
  pt::commit();
  if (first < n_qb) fetch(first);
  pt::commit();

  const int r0 = warp * 16;
  const int krow[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  const float scale2 = scale * LOG2E;
  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[dn][e] = dva[dn][e] = 0.f;

  for (int qi = first; qi < n_qb; ++qi) {
    const int q0 = qi * QT;
    if (qi + 1 < n_qb) fetch(qi + 1);
    pt::commit();
    // every thread passed the previous tile's closing barrier: Ls is free
    for (int i = threadIdx.x; i < QT; i += MMA_THREADS) {
      Ls[i] = lse_or_inf(lb, q0 + i, sq, LOG2E);
      Ls[QT + i] = q0 + i < sq ? db[q0 + i] : 0.f;
    }
    pt::wait<1>();                   // k, v and tile qi have landed
    __syncthreads();
    const bf16* Qs = QO + (qi & 1) * STAGE;
    const bf16* Os = Qs + QT * LD;

    // s^T = k.q^T and dp^T = v.do^T, 16 keys x QT queries per warp
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, Ks, LD, r0, kk * 16, g, t);
      load_a(va, Vs, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const bf16* pq = Qs + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        pt::mma_bf16(s[nt], ka, pt::ld32(pq), pt::ld32(pq + 8));
        const bf16* po = Os + (nt * 8 + g) * LD + kk * 16 + 2 * t;
        pt::mma_bf16(dp[nt], va, pt::ld32(po), pt::ld32(po + 8));
      }
    }

    // p^T into s, ds^T = p^T * (dp^T - delta) into dp
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t + (e & 1);   // query within the tile
        const int key = krow[e >> 1];
        const bool keep = key < sk && !(causal && q0 + c + off < key);
        float x = s[nt][e] * scale2;
        if (MASKED) x = sm.apply(x, q0 + c, key, LOG2E);
        const float p = keep ? pt::ex2(x - Ls[c]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - Ls[QT + c]);
      }

    // dv += p^T.do and dk += ds^T.q over the tile's queries
#pragma unroll
    for (int j = 0; j < QT / 16; ++j) {
      uint32_t pa[4], da[4];
      c_to_a(pa, s[2 * j], s[2 * j + 1]);
      c_to_a(da, dp[2 * j], dp[2 * j + 1]);
#pragma unroll
      for (int dn = 0; dn < ND; ++dn) {
        const bf16* po = Os + (j * 16 + 2 * t) * LD + dn * 8 + g;
        pt::mma_bf16(dva[dn], pa, pt::pack_col(po, LD),
                     pt::pack_col(po + 8 * LD, LD));
        const bf16* pq = Qs + (j * 16 + 2 * t) * LD + dn * 8 + g;
        pt::mma_bf16(dka[dn], da, pt::pack_col(pq, LD),
                     pt::pack_col(pq + 8 * LD, LD));
      }
    }
    __syncthreads();                 // stage qi & 1 and Ls free
  }
  pt::wait<0>();

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    if (krow[hi] >= sk) continue;
    const size_t o = kbase + (size_t)krow[hi] * D + 2 * t;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      *reinterpret_cast<uint32_t*>(dk + o + dn * 8) = pt::pack_bf16(
          dka[dn][2 * hi] * scale, dka[dn][2 * hi + 1] * scale);
      *reinterpret_cast<uint32_t*>(dv + o + dn * 8) =
          pt::pack_bf16(dva[dn][2 * hi], dva[dn][2 * hi + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: FMA units
// ---------------------------------------------------------------------------

constexpr int FMA_THREADS = 256;   // 16 x 16 threads, 4x4 tile patches

template <int D>
constexpr size_t dq_fma_smem() {   // q, do, k, v, ds
  return sizeof(float) * (size_t)(4 * BQ * (D + 1) + BQ * (BK + 1));
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(FMA_THREADS)
    fa_bwd_dq_fma_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         pt::AttnMask mask, float* __restrict__ dq, int sq,
                         int sk, int causal, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int CD = D / 16;            // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // BQ x DP
  float* Os = Qs + BQ * DP;             // BQ x DP (do)
  float* Ks = Os + BQ * DP;             // BK x DP
  float* Vs = Ks + BK * DP;             // BK x DP
  float* Ps = Vs + BK * DP;             // BQ x PP (ds)

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int off = sk - sq;
  const size_t qbase = (size_t)bh * sq * D;
  const size_t kbase = (size_t)bh * sk * D;
  const pt::SliceMask sm = pt::slice_mask(mask, bh, sq, sk);

  for (int e = tid; e < BQ * D; e += FMA_THREADS) {
    const int r = e / D, c = e % D, row = q0 + r;
    const bool ok = row < sq;
    Qs[r * DP + c] = ok ? q[qbase + (size_t)row * D + c] : 0.f;
    Os[r * DP + c] = ok ? dout[qbase + (size_t)row * D + c] : 0.f;
  }
  float lr[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    lr[i] = lse_or_inf(lse + (size_t)bh * sq, row, sq, 1.f);
    dl[i] = row < sq ? delta[(size_t)bh * sq + row] : 0.f;
  }

  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  const int n_kb = kv_tiles(q0, sk, off, causal);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * BK;
    __syncthreads();                    // previous tile fully consumed
    for (int e = tid; e < BK * D; e += FMA_THREADS) {
      const int r = e / D, c = e % D, row = k0 + r;
      const bool ok = row < sk;
      const size_t gi = kbase + (size_t)row * D + c;
      Ks[r * DP + c] = ok ? k[gi] : 0.f;
      Vs[r * DP + c] = ok ? v[gi] : 0.f;
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
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qrow = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool keep = kc < sk && !(causal && qrow + off < kc);
        float x = s[i][j] * scale;
        if (MASKED) x = sm.apply(x, qrow, kc, 1.f);
        const float p = keep ? expf(x - lr[i]) : 0.f;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qrow = q0 + ty + 16 * i;
    if (qrow >= sq) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c)
      dq[qbase + (size_t)qrow * D + tx + 16 * c] = acc[i][c] * scale;
  }
}

template <int D>
constexpr size_t dkv_fma_smem() {  // k, v, q, do, p^T, ds^T, lse, delta
  return sizeof(float) *
         (size_t)(2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BK * (BQ + 1) +
                  2 * BQ);
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(FMA_THREADS)
    fa_bwd_dkv_fma_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v,
                          const float* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          pt::AttnMask mask, float* __restrict__ dk,
                          float* __restrict__ dv, int sq, int sk, int causal,
                          float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BQ + 1;
  constexpr int CD = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                     // BK x DP
  float* Vs = Ks + BK * DP;             // BK x DP
  float* Qs = Vs + BK * DP;             // BQ x DP
  float* Os = Qs + BQ * DP;             // BQ x DP (do)
  float* PT = Os + BQ * DP;             // BK x PP (p^T)
  float* DS = PT + BK * PP;             // BK x PP (ds^T)
  float* Ls = DS + BK * PP;             // BQ lse, then BQ delta

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int off = sk - sq;
  const size_t qbase = (size_t)bh * sq * D;
  const size_t kbase = (size_t)bh * sk * D;
  const pt::SliceMask sm = pt::slice_mask(mask, bh, sq, sk);

  for (int e = tid; e < BK * D; e += FMA_THREADS) {
    const int r = e / D, c = e % D, row = k0 + r;
    const bool ok = row < sk;
    const size_t gi = kbase + (size_t)row * D + c;
    Ks[r * DP + c] = ok ? k[gi] : 0.f;
    Vs[r * DP + c] = ok ? v[gi] : 0.f;
  }

  float dka[4][CD], dva[4][CD];        // keys ty + 16i, columns tx + 16c
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[i][c] = dva[i][c] = 0.f;

  const int n_qb = (sq + BQ - 1) / BQ;
  for (int qi = first_q_tile(k0, off, causal, BQ); qi < n_qb; ++qi) {
    const int q0 = qi * BQ;
    __syncthreads();                    // previous tile fully consumed
    for (int e = tid; e < BQ * D; e += FMA_THREADS) {
      const int r = e / D, c = e % D, row = q0 + r;
      const bool ok = row < sq;
      Qs[r * DP + c] = ok ? q[qbase + (size_t)row * D + c] : 0.f;
      Os[r * DP + c] = ok ? dout[qbase + (size_t)row * D + c] : 0.f;
    }
    for (int i = tid; i < BQ; i += FMA_THREADS) {
      Ls[i] = lse_or_inf(lse + (size_t)bh * sq, q0 + i, sq, 1.f);
      Ls[BQ + i] = q0 + i < sq ? delta[(size_t)bh * sq + q0 + i] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];           // keys ty + 16i, queries tx + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], w[4], b[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Ks[(ty + 16 * i) * DP + d];
        w[i] = Vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = Qs[(tx + 16 * j) * DP + d];
        o[j] = Os[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(w[i], o[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool keep = key < sk && !(causal && q0 + c + off < key);
        float x = s[i][j] * scale;
        if (MASKED) x = sm.apply(x, q0 + c, key, 1.f);
        const float p = keep ? expf(x - Ls[c]) : 0.f;
        PT[(ty + 16 * i) * PP + c] = p;
        DS[(ty + 16 * i) * PP + c] = p * (dp[i][j] - Ls[BQ + c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float ov[CD], qv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        ov[c] = Os[qq * DP + tx + 16 * c];
        qv[c] = Qs[qq * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = PT[(ty + 16 * i) * PP + qq];
        const float ds = DS[(ty + 16 * i) * PP + qq];
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          dva[i][c] = fmaf(p, ov[c], dva[i][c]);
          dka[i][c] = fmaf(ds, qv[c], dka[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[kbase + (size_t)key * D + tx + 16 * c] = dka[i][c] * scale;
      dv[kbase + (size_t)key * D + tx + 16 * c] = dva[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
using cptr = const T*;

template <int D, bool MASKED>
cudaError_t launch_dq(bool mma, const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const pt::AttnMask& mask, void* dq, int bh, int sq,
                      int sk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = mma ? dq_mma_smem<D>() : dq_fma_smem<D>();
  const void* fn = mma ? (const void*)fa_bwd_dq_mma_kernel<D, MASKED>
                       : (const void*)fa_bwd_dq_fma_kernel<D, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  if (mma)
    fa_bwd_dq_mma_kernel<D, MASKED><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<cptr<bf16>>(q), static_cast<cptr<bf16>>(k),
        static_cast<cptr<bf16>>(v), static_cast<cptr<bf16>>(dout), lse,
        delta, mask, static_cast<bf16*>(dq), sq, sk, causal, scale);
  else
    fa_bwd_dq_fma_kernel<D, MASKED><<<grid, FMA_THREADS, smem, stream>>>(
        static_cast<cptr<float>>(q), static_cast<cptr<float>>(k),
        static_cast<cptr<float>>(v), static_cast<cptr<float>>(dout), lse,
        delta, mask, static_cast<float*>(dq), sq, sk, causal, scale);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dkv(bool mma, const void* q, const void* k, const void* v,
                       const void* dout, const float* lse,
                       const float* delta, const pt::AttnMask& mask,
                       void* dk, void* dv, int bh, int sq, int sk,
                       int causal, float scale, cudaStream_t stream) {
  const size_t smem = mma ? dkv_mma_smem<D>() : dkv_fma_smem<D>();
  const void* fn = mma ? (const void*)fa_bwd_dkv_mma_kernel<D, MASKED>
                       : (const void*)fa_bwd_dkv_fma_kernel<D, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + BK - 1) / BK, bh);
  if (mma)
    fa_bwd_dkv_mma_kernel<D, MASKED><<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<cptr<bf16>>(q), static_cast<cptr<bf16>>(k),
        static_cast<cptr<bf16>>(v), static_cast<cptr<bf16>>(dout), lse,
        delta, mask, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq, sk,
        causal, scale);
  else
    fa_bwd_dkv_fma_kernel<D, MASKED><<<grid, FMA_THREADS, smem, stream>>>(
        static_cast<cptr<float>>(q), static_cast<cptr<float>>(k),
        static_cast<cptr<float>>(v), static_cast<cptr<float>>(dout), lse,
        delta, mask, static_cast<float*>(dk), static_cast<float*>(dv), sq,
        sk, causal, scale);
  return cudaGetLastError();
}

bool bad_args(int bh, int sq, int sk, int d, int dtype,
              const pt::AttnMask& mask) {
  return bh <= 0 || sq <= 0 || sk <= 0 || (d != 64 && d != 128) ||
         (dtype != 0 && dtype != 1) || pt::slice_chunk(mask) <= 0 ||
         pt::bad_mask(mask, bh, sq, sk, BQ);
}

bool masked(const pt::AttnMask& m) { return m.bias || m.qseg; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, do and the outputs); lse and
// delta are (bh, sq) f32.  bias, qseg, kseg: the masks (null when absent),
// as pt::AttnMask describes them, with bias_bf16, bb, hb, sqb and heads.
// bf16 pointers must be 16-byte aligned.  Each returns a cudaError_t as int.
extern "C" int pt_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* bias, const int* qseg,
    const int* kseg, void* dq, int bh, int sq, int sk, int d, int dtype,
    int causal, int bias_bf16, int bb, int hb, int sqb, int heads,
    float scale, void* stream) {
  const pt::AttnMask mask =
      pt::make_mask(bias, qseg, kseg, bias_bf16, bb, hb, sqb, heads);
  if (bad_args(bh, sq, sk, d, dtype, mask)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = dtype == 1, msk = masked(mask);
  const size_t es = mma ? 2 : 4;
  // B*H past grid y: chunks
  return pt::for_each_chunk(mask, bh, pt::slice_chunk(mask), 1, sq, sk,
                            [&](int bh0, int n, const pt::AttnMask& m) {
    const size_t qo = (size_t)bh0 * sq * d, ko = (size_t)bh0 * sk * d;
    const void *qc = pt::advance(q, qo, es), *kc = pt::advance(k, ko, es),
               *vc = pt::advance(v, ko, es), *oc = pt::advance(dout, qo, es);
    const float *lc = lse + (size_t)bh0 * sq, *dc = delta + (size_t)bh0 * sq;
    void* gc = pt::advance(dq, qo, es);
    return d == 64
               ? (msk ? launch_dq<64, true> : launch_dq<64, false>)(
                     mma, qc, kc, vc, oc, lc, dc, m, gc, n, sq, sk, causal,
                     scale, s)
               : (msk ? launch_dq<128, true> : launch_dq<128, false>)(
                     mma, qc, kc, vc, oc, lc, dc, m, gc, n, sq, sk, causal,
                     scale, s);
  });
}

extern "C" int pt_flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* bias, const int* qseg,
    const int* kseg, void* dk, void* dv, int bh, int sq, int sk, int d,
    int dtype, int causal, int bias_bf16, int bb, int hb, int sqb, int heads,
    float scale, void* stream) {
  const pt::AttnMask mask =
      pt::make_mask(bias, qseg, kseg, bias_bf16, bb, hb, sqb, heads);
  if (bad_args(bh, sq, sk, d, dtype, mask)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool mma = dtype == 1, msk = masked(mask);
  const size_t es = mma ? 2 : 4;
  // B*H past grid y: chunks
  return pt::for_each_chunk(mask, bh, pt::slice_chunk(mask), 1, sq, sk,
                            [&](int bh0, int n, const pt::AttnMask& m) {
    const size_t qo = (size_t)bh0 * sq * d, ko = (size_t)bh0 * sk * d;
    const void *qc = pt::advance(q, qo, es), *kc = pt::advance(k, ko, es),
               *vc = pt::advance(v, ko, es), *oc = pt::advance(dout, qo, es);
    const float *lc = lse + (size_t)bh0 * sq, *dc = delta + (size_t)bh0 * sq;
    void *kg = pt::advance(dk, ko, es), *vg = pt::advance(dv, ko, es);
    return d == 64
               ? (msk ? launch_dkv<64, true> : launch_dkv<64, false>)(
                     mma, qc, kc, vc, oc, lc, dc, m, kg, vg, n, sq, sk,
                     causal, scale, s)
               : (msk ? launch_dkv<128, true> : launch_dkv<128, false>)(
                     mma, qc, kc, vc, oc, lc, dc, m, kg, vg, n, sq, sk,
                     causal, scale, s);
  });
}
