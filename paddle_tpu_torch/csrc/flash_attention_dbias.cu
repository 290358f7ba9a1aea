// Flash-attention bias gradient for Hopper (sm_90a), bound through a plain
// C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_bwd_dbias_kernel`
// (:560), called through `_dbias_call` (:698, the pallas_call at :743).
// Same function: d(bias) = ds = p * (dp - delta), with p rebuilt from the
// forward's lse and the masked score (s * scale + bias, -inf where the
// segment ids differ, then the causal mask), dp = do.v^T and delta =
// rowsum(do * o) from the backward, summed in f32 over the bias's broadcast
// extent: the folded (b, h) slices that read one bias slice g (bh = g * mg
// + r * mr for r < n_r, as `_dbias_call` :707-714 maps them) and, when the
// bias has one query row (Sqb = 1), the query rows as well.  Output
// (Bb*Hb, Sqb, Sk) in the bias's dtype, f32 or bf16.  ds stays unrounded
// f32, as the reference sums it.  A row with lse = -inf (no visible key)
// contributes 0.
//
// Design (bf16 q, k, v: the model's path).  The grid is (output tile,
// split).  An output tile is TQ query rows x TK keys of bias slice g (128 x
// 128 at D = 64, 64 x 64 at D = 128), or TK keys of slice g when Sqb = 1.
// The n_r reduced slices of a tile run in contiguous runs of `per` slices,
// one a split, per chosen by the wrapper so that about one block an SM is
// resident: the reduced extent is spread over the card instead of looping
// in few blocks.  A block is a producer warpgroup and TQ / 64 consumer
// warpgroups of 64 query rows each.  For each term of its run (a slice r
// and, when Sqb = 1, each query tile that sees the keys) the producer
// thread loads q and do (TQ rows) and k and v (TK keys) by TMA over 3-D
// tensor maps (D, S, B*H), and the rows' lse and delta (and the segment
// ids) by bulk copies, into a ring of stages with a full and an empty
// mbarrier each.  A consumer warpgroup issues s = q.k^T and dp = do.v^T on
// wgmma (both operands in shared memory), waits, and adds ds = p (dp -
// delta) to its f32 accumulators, p = 2^(s scale log2e + bias log2e - lse
// log2e).  The block's bias tile is the same for every term: it is read
// from device memory once, into shared memory in f32 times log2(e), before
// the loop.  Causal tiles wholly above the diagonal are not computed: the
// first split writes their output 0 once.  Only the terms whose rows cross
// the diagonal mask by key (a separate instantiation of the step).  With
// one split the block writes the output in the bias's dtype; with more,
// each split writes its f32 partial tile and a second kernel sums the
// partials in split order.  For Sqb = 1 the tile is summed over its rows
// after the loop (sums are linear): a fixed shuffle tree over a warp's
// lanes, then the warps in order.  No atomics: two calls are bitwise
// equal.
//  - f32 (tests and small models): one block per 64 x 64 output tile, 256
//    threads, each a 4x4 patch, the reduction a loop in the block,
//    products on the FMA units.
//
// What bounds it.  At the learned-bias encoder's shape (a (1, 12, 128, 128)
// bias, B = 128, H = 12, S = 128, D = 64, bf16) it reads q, k, v and do
// once (101 MB: 30 us at 3.35 TB/s) and does two products over every
// (query, key) pair, 6.4 GFLOP (6.5 us at 989 TFLOP/s): bytes bound it.
// There the grid is 12 tiles x 11 splits of 12 slices (the last 8): 132
// blocks, each streaming 64 KB a term.
#include <limits.h>

#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

using pt::bf16;
namespace sm = pt::sm90;

constexpr int BQ = 64;    // f32: query rows per tile
constexpr int BK = 64;    // f32: keys per tile
constexpr float LOG2E = 1.4426950408889634f;

// lse of a row in the exponent's units, +inf for a row with no visible key
// (exp(s - inf) = 0, as the reference's row guard gives)
__device__ __forceinline__ float lse_or_inf(float l, float unit) {
  return l == -CUDART_INF_F ? CUDART_INF_F : l * unit;
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
// bf16: TMA and wgmma
// ---------------------------------------------------------------------------

template <int D>
struct DbCfg {
  static constexpr int TQ = D == 64 ? 128 : 64;   // query rows a tile
  static constexpr int TK = D == 64 ? 128 : 64;   // keys a tile
  static constexpr int ST = D == 64 ? 2 : 3;      // stages in the ring
  static constexpr int NC = TQ / 64;              // consumer warpgroups
  static constexpr int THREADS = 128 * (1 + NC);
  static constexpr int QBOX = TQ * 128;           // a 64-column box of q
  static constexpr int KBOX = TK * 128;           // a 64-column box of k
  static constexpr int Q_BYTES = TQ * D * 2;
  static constexpr int K_BYTES = TK * D * 2;
  static constexpr int STAGE = 2 * Q_BYTES + 2 * K_BYTES;   // q, do, k, v
  // a stage's rows, 4-byte words: lse, delta, query segment ids, key ids
  static constexpr int ROWS = 3 * TQ + TK;
  static constexpr int LDB = TK + 8;              // the shared bias's rows
  static constexpr size_t SMEM = 1024 + (size_t)ST * STAGE +
                                 (size_t)ST * ROWS * 4 +
                                 (size_t)TQ * LDB * 4 +
                                 2 * ST * sizeof(uint64_t);
};

struct DbArgs {
  const float* lse;
  const float* delta;
  pt::AttnMask mask;
  Reduce red;
  void* db;          // (n_g, sqb, sk) in the bias's dtype
  float* part;       // (n_split, n_g, sqb, sk) f32 partials; null: one split
  size_t plane;      // n_g * sqb * sk
  int sq, sk, causal;
  int n_qo, n_kt;    // output query tiles (sq / TQ, or 1 when Sqb = 1), keys
  int per;           // reduced slices a split
  float scale2;      // scale * log2(e)
};

template <int D, bool SQ_FULL, bool SEG>
__global__ void __launch_bounds__(DbCfg<D>::THREADS, 1)
    dbias_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tdo,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const DbArgs a) {
  using C = DbCfg<D>;
  constexpr int TQ = C::TQ, TK = C::TK, ST = C::ST, NC = C::NC;
  constexpr int N2 = TK / 2;       // a thread's entries of a 64 x TK tile
  extern __shared__ unsigned char smem_raw[];
  __shared__ float colsum[4 * NC][TK];   // Sqb = 1: the warps' column sums
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* stages =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  float* rows = reinterpret_cast<float*>(stages + ST * C::STAGE);
  float* bias_s = rows + ST * C::ROWS;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + TQ * C::LDB);
  uint64_t* empty = full + ST;

  const int off = a.sk - a.sq;
  const int kt = blockIdx.x % a.n_kt;
  const int qo = (blockIdx.x / a.n_kt) % a.n_qo;
  const int g = blockIdx.x / a.n_kt / a.n_qo;
  const int k0 = kt * TK, split = blockIdx.y;
  const int r_begin = split * a.per;
  const int n_r = min(a.per, a.red.n_r - r_begin);
  const int sqb = SQ_FULL ? a.sq : 1;

  if (SQ_FULL && a.causal && k0 > qo * TQ + TQ - 1 + off) {
    // no row of the tile sees a key of it: 0, written once
    if (split == 0)
      for (int e = threadIdx.x; e < TQ * TK; e += C::THREADS)
        put(a.db, a.mask.bias_bf16,
            ((size_t)g * a.sq + qo * TQ + e / TK) * a.sk + k0 + e % TK, 0.f);
    return;
  }
  // the block's terms: slice r_begin + i / nq, query tile qt0 + i % nq
  const int qt0 = SQ_FULL ? qo : pt::first_q_tile(k0, off, a.causal, TQ);
  const int nq = SQ_FULL ? 1 : a.sq / TQ - qt0;
  const int n_terms = n_r * nq;
  auto term = [&](int i, int& bh, int& q0) {
    bh = g * a.red.mg + (r_begin + i / nq) * a.red.mr;
    q0 = (qt0 + i % nq) * TQ;
  };

  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], 4 * NC);   // one arrival per consumer warp
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    if constexpr (NC == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    const uint32_t bytes = C::STAGE + 2 * TQ * 4 + (SEG ? (TQ + TK) * 4 : 0);
    for (int i = 0; i < n_terms; ++i) {
      const int s = i % ST;
      int bh, q0;
      term(i, bh, q0);
      unsigned char* sb = stages + s * C::STAGE;
      float* rw = rows + s * C::ROWS;
      sm::mbar_wait(&empty[s], ((i / ST) & 1) ^ 1);
      sm::mbar_expect_tx(&full[s], bytes);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm::tma_load_3d(sb + c * C::QBOX, &tq, &full[s], c * 64, q0, bh);
        sm::tma_load_3d(sb + C::Q_BYTES + c * C::QBOX, &tdo, &full[s],
                        c * 64, q0, bh);
        sm::tma_load_3d(sb + 2 * C::Q_BYTES + c * C::KBOX, &tk, &full[s],
                        c * 64, k0, bh);
        sm::tma_load_3d(sb + 2 * C::Q_BYTES + C::K_BYTES + c * C::KBOX, &tv,
                        &full[s], c * 64, k0, bh);
      }
      const size_t at = (size_t)bh * a.sq + q0;
      sm::bulk_load(rw, a.lse + at, TQ * 4, &full[s]);
      sm::bulk_load(rw + TQ, a.delta + at, TQ * 4, &full[s]);
      if (SEG) {
        const size_t b = (size_t)(bh / a.mask.heads);
        sm::bulk_load(rw + 2 * TQ, a.mask.qseg + b * a.sq + q0, TQ * 4,
                      &full[s]);
        sm::bulk_load(rw + 3 * TQ, a.mask.kseg + b * a.sk + k0, TK * 4,
                      &full[s]);
      }
    }
    return;
  }

  if constexpr (NC == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32, tl = lane % 4;
  // this thread's rows in the warpgroup's 64 (and the row 8 below)
  const int wr = warp * 16 + lane / 4;
  const int tr = cw * 64 + wr;     // ... and in the tile

  // the bias tile, loaded once: this warpgroup's 64 rows (its own copy of
  // the one row when Sqb = 1), in f32 times log2(e)
  float* bw = bias_s + cw * 64 * C::LDB;
  {
    const int nrows = SQ_FULL ? 64 : 1;
    const size_t base = ((size_t)g * sqb + (SQ_FULL ? qo * TQ + cw * 64 : 0))
                        * a.sk + k0;
    for (int e = 4 * t; e < nrows * TK; e += 4 * 128) {
      const int r = e / TK, c = e % TK;
      const size_t at = base + (size_t)r * a.sk + c;
      float4 x;
      if (a.mask.bias_bf16) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            static_cast<const bf16*>(a.mask.bias) + at);
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u.y));
        x = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        x = *reinterpret_cast<const float4*>(
            static_cast<const float*>(a.mask.bias) + at);
      }
      *reinterpret_cast<float4*>(bw + r * C::LDB + c) =
          make_float4(x.x * LOG2E, x.y * LOG2E, x.z * LOG2E, x.w * LOG2E);
    }
    sm::named_barrier(1 + cw, 128);
  }
  const float* brow[2] = {bw + (SQ_FULL ? wr * C::LDB : 0),
                          bw + (SQ_FULL ? (wr + 8) * C::LDB : 0)};

  float s[N2], dp[N2], acc[N2];
#pragma unroll
  for (int e = 0; e < N2; ++e) acc[e] = 0.f;

  // term i: acc += ds of this warpgroup's 64 rows.  EDGE (a
  // std::bool_constant): the rows cross the causal diagonal, and the keys
  // past a row's last visible one give p = 0; the other terms compile
  // without that code.
  auto step = [&](auto edge, int i, int q0) {
    const int st = i % ST;
    const unsigned char* sb = stages + st * C::STAGE;
    const float* rw = rows + st * C::ROWS;
    sm::mbar_wait(&full[st], (i / ST) & 1);
    sm::fence_acc(s);
    sm::fence_acc(dp);
    sm::wgmma_fence();
    sm::issue_scores<D>(s, sb + cw * 64 * 128, C::QBOX, sb + 2 * C::Q_BYTES,
                        C::KBOX);
    sm::issue_scores<D>(dp, sb + C::Q_BYTES + cw * 64 * 128, C::QBOX,
                        sb + 2 * C::Q_BYTES + C::K_BYTES, C::KBOX);
    sm::wgmma_commit();
    sm::wgmma_wait<0>();
    sm::fence_acc(s);
    sm::fence_acc(dp);
    float lse2[2], dl[2];
    int qsg[2] = {0, 0};
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      lse2[hi] = lse_or_inf(rw[tr + 8 * hi], LOG2E);
      dl[hi] = rw[TQ + tr + 8 * hi];
      if (SEG)
        qsg[hi] = reinterpret_cast<const int*>(rw)[2 * TQ + tr + 8 * hi];
    }
    const int* ksg = reinterpret_cast<const int*>(rw) + 3 * TQ;
#pragma unroll
    for (int jn = 0; jn < TK / 8; ++jn) {
      const int c = 8 * jn + 2 * tl;       // the pair's first key in the tile
      const float2 b2[2] = {*reinterpret_cast<const float2*>(brow[0] + c),
                            *reinterpret_cast<const float2*>(brow[1] + c)};
      int2 k2 = make_int2(0, 0);
      if (SEG) k2 = *reinterpret_cast<const int2*>(ksg + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, lo = e & 1;
        float x = fmaf(s[4 * jn + e], a.scale2, lo ? b2[hi].y : b2[hi].x);
        if (SEG && qsg[hi] != (lo ? k2.y : k2.x)) x = -CUDART_INF_F;
        if constexpr (decltype(edge)::value)
          if (k0 + c + lo > q0 + tr + 8 * hi + off) x = -CUDART_INF_F;
        const float p = pt::ex2(x - lse2[hi]);
        acc[4 * jn + e] += p * (dp[4 * jn + e] - dl[hi]);
      }
    }
    __syncwarp();
    if (lane == 0) sm::mbar_arrive(&empty[st]);   // the warp is done with st
  };
  for (int i = 0; i < n_terms; ++i) {
    int bh, q0;
    term(i, bh, q0);
    // this warpgroup's first row sees the tile's last key: no causal mask
    if (a.causal && k0 + TK - 1 > q0 + cw * 64 + off)
      step(std::true_type{}, i, q0);
    else
      step(std::false_type{}, i, q0);
  }

  float* out = a.part ? a.part + (size_t)split * a.plane : nullptr;
  const int f32_out = a.part != nullptr || !a.mask.bias_bf16;
  void* dst = a.part ? static_cast<void*>(out) : a.db;
  if constexpr (SQ_FULL) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const size_t row = (size_t)g * a.sq + qo * TQ + tr + 8 * hi;
#pragma unroll
      for (int jn = 0; jn < TK / 8; ++jn) {
        const size_t at = row * a.sk + k0 + 8 * jn + 2 * tl;
        const float x = acc[4 * jn + 2 * hi], y = acc[4 * jn + 2 * hi + 1];
        if (f32_out)
          *reinterpret_cast<float2*>(static_cast<float*>(dst) + at) =
              make_float2(x, y);
        else
          *reinterpret_cast<uint32_t*>(static_cast<bf16*>(dst) + at) =
              pt::pack_bf16(x, y);
      }
    }
    return;
  }
  // Sqb = 1: sum the rows.  Lanes (g, t) share columns with the other
  // seven g of their t: a fixed shuffle tree over lane bits 2-4, then the
  // warps in order.
#pragma unroll
  for (int jn = 0; jn < TK / 8; ++jn)
#pragma unroll
    for (int lo = 0; lo < 2; ++lo) {
      float x = acc[4 * jn + lo] + acc[4 * jn + 2 + lo];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane < 4) colsum[cw * 4 + warp][8 * jn + 2 * tl + lo] = x;
    }
  sm::named_barrier(3, 128 * NC);
  const int c = cw * 128 + t;
  if (c < TK) {
    float x = colsum[0][c];
#pragma unroll
    for (int w = 1; w < 4 * NC; ++w) x += colsum[w][c];
    put(dst, !f32_out, (size_t)g * a.sk + k0 + c, x);
  }
}

// db = the splits' f32 partials summed in split order, in the bias's
// dtype, four entries a thread.  Causal tiles of TQ x TK wholly above the
// diagonal were written by the first pass (their partials never were).
__global__ void dbias_sum_kernel(const float* __restrict__ part,
                                 void* __restrict__ db, int out_bf16,
                                 size_t plane, int n_split, int sq, int sk,
                                 int full_rows, int causal, int tq, int tk) {
  const size_t i = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= plane) return;
  if (causal && full_rows) {
    const int key = (int)(i % sk), row = (int)(i / sk % sq);
    if (key / tk * tk > row / tq * tq + tq - 1 + sk - sq) return;
  }
  float4 x = *reinterpret_cast<const float4*>(part + i);
  for (int s = 1; s < n_split; ++s) {
    const float4 y =
        *reinterpret_cast<const float4*>(part + (size_t)s * plane + i);
    x.x += y.x;
    x.y += y.y;
    x.z += y.z;
    x.w += y.w;
  }
  put(db, out_bf16, i, x.x);
  put(db, out_bf16, i + 1, x.y);
  put(db, out_bf16, i + 2, x.z);
  put(db, out_bf16, i + 3, x.w);
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
      const float lr = lse_or_inf(lse[(size_t)bh * sq + qrow], 1.f);
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
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       const pt::AttnMask& mask, void* db, Reduce red,
                       int n_g, int sq, int sk, int causal, float scale,
                       cudaStream_t stream) {
  const size_t smem = fma_smem<D>();
  const void* fn = (const void*)dbias_fma_kernel<D, SQ_FULL>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(SQ_FULL ? sq / BQ : 1, sk / BK, n_g);
  dbias_fma_kernel<D, SQ_FULL><<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout), lse,
      delta, mask, db, mask.bias_bf16, red, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fma_d(const void* q, const void* k, const void* v,
                         const void* dout, const float* lse,
                         const float* delta, const pt::AttnMask& mask,
                         void* db, Reduce red, int n_g, int sq, int sk,
                         int causal, float scale, cudaStream_t stream) {
  if (mask.sqb > 1)
    return launch_fma<D, true>(q, k, v, dout, lse, delta, mask, db, red,
                               n_g, sq, sk, causal, scale, stream);
  return launch_fma<D, false>(q, k, v, dout, lse, delta, mask, db, red, n_g,
                              sq, sk, causal, scale, stream);
}

// the bf16 kernel and, with more than one split, the ordered sum
template <int D, bool SQ_FULL, bool SEG>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dout, const DbArgs& a, int bh, int n_g,
                         int n_split, cudaStream_t stream) {
  using C = DbCfg<D>;
  CUtensorMap tq, tdo, tk, tv;
  if (!sm::bf16_map_3d(&tq, q, bh, a.sq, D, C::TQ) ||
      !sm::bf16_map_3d(&tdo, dout, bh, a.sq, D, C::TQ) ||
      !sm::bf16_map_3d(&tk, k, bh, a.sk, D, C::TK) ||
      !sm::bf16_map_3d(&tv, v, bh, a.sk, D, C::TK))
    return cudaErrorInvalidValue;
  const long long tiles = (long long)n_g * a.n_qo * a.n_kt;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)dbias_wgmma_kernel<D, SQ_FULL, SEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  dbias_wgmma_kernel<D, SQ_FULL, SEG>
      <<<dim3((unsigned)tiles, n_split), C::THREADS, C::SMEM, stream>>>(
          tq, tdo, tk, tv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  const size_t quads = a.plane / 4;
  dbias_sum_kernel<<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
      a.part, a.db, a.mask.bias_bf16, a.plane, n_split, a.sq, a.sk, SQ_FULL,
      a.causal, C::TQ, C::TK);
  return cudaGetLastError();
}

template <int D>
cudaError_t wgmma_d(const void* q, const void* k, const void* v,
                    const void* dout, DbArgs a, int bh, int n_g, int n_split,
                    cudaStream_t s) {
  using C = DbCfg<D>;
  if (a.sq % C::TQ || a.sk % C::TK) return cudaErrorInvalidValue;
  const bool full = a.mask.sqb > 1, seg = a.mask.qseg != nullptr;
  a.n_qo = full ? a.sq / C::TQ : 1;
  a.n_kt = a.sk / C::TK;
  if (full)
    return seg ? launch_wgmma<D, true, true>(q, k, v, dout, a, bh, n_g,
                                             n_split, s)
               : launch_wgmma<D, true, false>(q, k, v, dout, a, bh, n_g,
                                              n_split, s);
  return seg ? launch_wgmma<D, false, true>(q, k, v, dout, a, bh, n_g,
                                            n_split, s)
             : launch_wgmma<D, false, false>(q, k, v, dout, a, bh, n_g,
                                             n_split, s);
}

}  // namespace

// q, k, v, dout: (bh, s, d) in dtype (0 = float32, 1 = bfloat16); lse and
// delta (bh, sq) f32; bias (bb*hb, sqb, sk) f32 or bf16 (bias_bf16), the
// one the forward added; qseg, kseg int32 segment ids or null; db receives
// (bb*hb, sqb, sk) in the bias's dtype.  sq and sk must be multiples of 64
// (bf16: of the kernel's tile, 128 at d = 64).  bf16 only: the reduced
// slices of a bias slice run in splits of `per` slices; with more than one
// split, part is an (n_split, bb*hb, sqb, sk) f32 scratch buffer, n_split
// = ceil(n_r / per); every pointer 16-byte aligned.  Returns a cudaError_t
// as int.
extern "C" int pt_flash_attention_dbias(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const void* bias, const int* qseg,
    const int* kseg, void* db, float* part, int bh, int sq, int sk, int d,
    int dtype, int causal, int bias_bf16, int bb, int hb, int sqb,
    int heads, int per, float scale, void* stream) {
  const pt::AttnMask mask =
      pt::make_mask(bias, qseg, kseg, bias_bf16, bb, hb, sqb, heads);
  if (bias == nullptr || bh <= 0 || sq <= 0 || sk <= 0 ||
      (dtype != 0 && dtype != 1) || (d != 64 && d != 128) ||
      pt::bad_mask(mask, bh, sq, sk, BQ) || pt::slice_chunk(mask) <= 0)
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
  const int n_g = bb * hb;
  if (dtype == 1) {
    const int n_split = per > 0 ? (red.n_r + per - 1) / per : 0;
    const void* ptrs[] = {q, k, v, dout, lse, delta, bias, qseg, kseg, db,
                          part};
    for (const void* p : ptrs)
      if (pt::misaligned(p)) return (int)cudaErrorInvalidValue;
    if (n_split <= 0 || n_split > 65535 || (n_split > 1 && part == nullptr))
      return (int)cudaErrorInvalidValue;
    DbArgs a{lse,  delta, mask, red, db, n_split > 1 ? part : nullptr,
             (size_t)n_g * sqb * sk, sq, sk, causal, 0, 0, per,
             scale * LOG2E};
    return (int)(d == 64 ? wgmma_d<64>(q, k, v, dout, a, bh, n_g, n_split, s)
                         : wgmma_d<128>(q, k, v, dout, a, bh, n_g, n_split,
                                        s));
  }
  if ((bb == 1 && hb > pt::MAX_GRID_Y) || sk / BK > 65535)
    return (int)cudaErrorInvalidValue;
  // f32: more than MAX_GRID_Y bias slices (grid z) only when each slice is
  // one folded slice (g = bh) or one batch entry (g = b): chunks of them,
  // the first slice a multiple of heads
  const int chunk = red.mg == 1 && red.mr == 0 ? pt::slice_chunk(mask)
                                               : pt::MAX_GRID_Y;
  return pt::for_each_chunk(mask, n_g, chunk, red.mg, sq, sk,
                            [&](int g0, int n, const pt::AttnMask& m) {
    const int bh0 = g0 * red.mg;
    const size_t qo = (size_t)bh0 * sq * d, ko = (size_t)bh0 * sk * d;
    const void *qc = pt::advance(q, qo, 4), *kc = pt::advance(k, ko, 4),
               *vc = pt::advance(v, ko, 4), *oc = pt::advance(dout, qo, 4);
    const float *lc = lse + (size_t)bh0 * sq, *dc = delta + (size_t)bh0 * sq;
    void* gc = pt::advance(db, (size_t)g0 * sqb * sk, bias_bf16 ? 2 : 4);
    return d == 64 ? launch_fma_d<64>(qc, kc, vc, oc, lc, dc, m, gc, red, n,
                                      sq, sk, causal, scale, s)
                   : launch_fma_d<128>(qc, kc, vc, oc, lc, dc, m, gc, red, n,
                                       sq, sk, causal, scale, s);
  });
}
