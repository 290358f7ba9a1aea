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
// Masks (the masked instantiations): p is rebuilt from the masked score as
// the forward builds it (s * scale + bias, -inf where the segment ids
// differ, then the causal and tail masks), the reference's `_rebuild_p`
// with `_mask_tile`.  The bias's own gradient is the separate kernel of
// csrc/flash_attention_dbias.cu.
//
// Design.  The TPU grid's sequential reduction axis (kv for dq, q for
// dk/dv) becomes a loop inside the block, with the accumulator in
// registers; nothing is carried between blocks and no atomics are needed:
// each output row is written once, by one block, summing in a fixed
// order, so two calls are bitwise equal.  Two kernels, as the reference
// has two pallas_calls: a fused one would add dq across key blocks with
// f32 atomics, which is not repeatable; the price is that both kernels
// rebuild s and dp (seven products where five would do).
//
// bf16 (the model's path): persistent, warp-specialised kernels fed by TMA
// and multiplying on wgmma, built from the forward's pieces
// (csrc/hopper_gemm.cuh).  One block per SM walks work items in pairs,
// heaviest with lightest (sm::walk_item).  A block is three warpgroups:
// a producer thread that loads by TMA over 3-D tensor maps (D, S, B*H),
// so a tile never reads into the next head and stores past S are dropped,
// and two consumer warpgroups of 64 rows each.
//  - dq (#2): items (bh, 128-row query tile).  The producer loads the
//    item's q and do once, then 128-key k and v tiles into a ring of
//    stages (four at D = 64, two at D = 128), with a full and an empty
//    mbarrier a stage; with a mask, the bias row of a one-row bias and the
//    key segment ids ride the stage as bulk copies.  For each key tile a
//    consumer issues S = q.k^T and dP = do.v^T (wgmma, both operands in
//    shared memory, K-major), rebuilds p = 2^(S scale log2e - lse log2e)
//    and dS = p (dP - delta) in registers (lse and delta of its two rows
//    held in registers), then dQ += dS.k with A, bf16 dS, from registers
//    (an accumulator's two n8 blocks are the A fragment of one k16 step)
//    and k read MN-major through the transpose bit.  The epilogue writes
//    dQ scale in bf16 into the item's q buffer in the output map's
//    swizzle, and one TMA store a warpgroup writes it.
//  - dk/dv (#3): items (bh, 128-key tile), key tile 0 first (under the
//    causal mask the most queries see it).  The producer loads the item's
//    k and v once, then query tiles of q and do into a ring of four
//    stages: 128 rows at D = 64, 64 at D = 128, so that S^T, dP^T and the
//    two accumulators fit the registers.  A consumer owns 64 keys; for
//    each query tile it issues S^T = k.q^T and dP^T = v.do^T (shared,
//    K-major), rebuilds P^T and dS^T = P^T (dP^T - delta) with lse and
//    delta a column read from shared memory (the warpgroup stages them a
//    tile ahead, +inf and 0 past sq by index, so rows past Sq give p = 0
//    whatever the next head holds), then dV += P^T.do and dK += dS^T.q
//    with A from registers and do and q MN-major.  The epilogue stages dK
//    scale and dV in the k and v buffers and stores them by TMA.
//  - Each warpgroup runs its products and its elementwise work in turn
//    (one wgmma_wait after each group of products, so no register of an
//    asynchronous product is touched while it runs and ptxas keeps them
//    in flight); the two warpgroups interleave, so one's exponentials run
//    while the other's products keep the tensor cores busy.  The causal
//    and key-end masks cost only the tiles that cross the diagonal or the
//    end (a separate instantiation of the tile step).
//  - Masks are instantiations: none; one f32 bias row a slice and no
//    segment ids (BERT's padding bias, one FFMA a score: per key in dk/dv,
//    where it is loaded once an item, and staged with each key tile in
//    dq); any other mask, read by kind at run time (a full bias from
//    device memory).
//  - f32 (tests and the small reference model): 256 threads, tiles staged
//    as f32, products on the FMA units.
//
// What bounds it.  At GPT-2 345M shapes (B*H = 128, S = 1024, D = 64,
// causal) the backward does five products over the visible (query, key)
// pairs, 2.5 times the forward's 17.2 GFLOP: 43 GFLOP, 43 us at the
// card's 989 TFLOP/s bf16 tensor-core peak (the two kernels' seven
// products 61 us); its bytes (q, k, v, o, do, dq, dk, dv in bf16 plus lse
// and delta) take 40 us at 3.35 TB/s, so operations bound it by a little.
// BERT-base's layer (S = 128) has one tile an item and is bound by its
// bytes: the persistent loop loads the next item while this one computes.
#include <limits.h>

#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

using pt::bf16;
namespace sm = pt::sm90;

constexpr int BQ = 64;    // f32: query rows per dq block (and per q tile)
constexpr int BK = 64;    // f32: keys per tile (dq loop) and per dk/dv block
constexpr float LOG2E = 1.4426950408889634f;

// lse of a row in the exponent's units, with +inf marking a row that must
// give p = 0 (no visible key, or past sq): exp(s - inf) = 0 without a NaN
__device__ __forceinline__ float lse_or_inf(const float* lse, int row,
                                            int sq, float unit) {
  if (row >= sq) return CUDART_INF_F;
  const float l = lse[row];
  return l == -CUDART_INF_F ? CUDART_INF_F : l * unit;
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised, TMA and wgmma
// ---------------------------------------------------------------------------

constexpr int WT = 384;          // a producer and two consumer warpgroups
constexpr int TILE = 128;        // dq: query rows an item, keys a tile;
                                 // dk/dv: keys an item
constexpr int BOX = TILE * 128;  // one 64-column box of a 128-row tile
using pt::MASK_BYTES;            // dq: a stage's bias row and key ids
using pt::MK_ANY;
using pt::MK_NONE;
using pt::MK_ROW;
using pt::ROW_BF16;
using pt::ROW_F32;
using pt::FULL_BF16;
using pt::FULL_F32;

struct BwdArgs {
  const float* lse;
  const float* delta;
  pt::AttnMask mask;
  int bias_kind;     // pt::BiasKind
  int bh, sq, sk, causal;
  int n_t;           // tiles a slice: query tiles (dq), key tiles (dk/dv)
  int items;         // bh * n_t
  float scale;
  float scale2;      // scale * log2(e)
};

template <int D>
struct DqCfg {
  static constexpr int QBUF = D == 64 ? 2 : 1;    // (q, do) buffers
  static constexpr int ST = D == 64 ? 4 : 2;      // (k, v) tiles in flight
  static constexpr int T_BYTES = TILE * D * 2;    // one 128-row tile
  static constexpr size_t SMEM = 1024 + QBUF * 2 * T_BYTES +
                                 ST * (2 * T_BYTES + MASK_BYTES) +
                                 (2 * QBUF + 2 * ST) * sizeof(uint64_t);
};

template <int D>
struct DkvCfg {
  static constexpr int TQ = D == 64 ? 128 : 64;   // query rows a tile
  static constexpr int KVBUF = D == 64 ? 2 : 1;   // (k, v) buffers
  static constexpr int ST = 4;                    // (q, do) tiles in flight
  static constexpr int K_BYTES = TILE * D * 2;
  static constexpr int QBOX = TQ * 128;           // one 64-column box of q
  static constexpr int Q_BYTES = TQ * D * 2;
  // per consumer warpgroup: two tiles' lse and delta
  static constexpr int LSE_FLOATS = 2 * 2 * TQ;
  static constexpr size_t SMEM = 1024 + KVBUF * 2 * K_BYTES +
                                 ST * 2 * Q_BYTES +
                                 2 * LSE_FLOATS * sizeof(float) +
                                 (2 * KVBUF + 2 * ST) * sizeof(uint64_t);
};

// d (64 x N) += A . B over one k16 step, A from registers, N = 64 or 128
// by d's size
template <int N2>
__device__ __forceinline__ void mma_rs(float (&d)[N2], const uint32_t (&a)[4],
                                       uint64_t db) {
  if constexpr (N2 == 32)
    sm::wgmma_m64n64k16_rs<1>(d, a, db, 1);
  else
    sm::wgmma_m64n128k16_rs<1>(d, a, db, 1);
}

using sm::issue_scores;

// d (64 x D) += A . B over K rows: A in bf16 fragments (one a k16 step),
// B (K x D) at b MN-major (D contiguous), 16 rows 2048 bytes on, the
// second 64 columns of D a box (bbox bytes) on
template <int K, int N2>
__device__ __forceinline__ void issue_grad(float (&d)[N2],
                                           const uint32_t (&a)[K / 16][4],
                                           const unsigned char* b,
                                           int bbox) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_rs(d, a[kk], sm::desc_sw128(b + kk * 2048, bbox, 1024));
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

template <int D, int MK>
__global__ void __launch_bounds__(WT, 1)
    fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdq,
                           const BwdArgs a) {
  using C = DqCfg<D>;
  constexpr int ST = C::ST, QB = C::QBUF, TB = C::T_BYTES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* qs =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + QB * 2 * TB;      // buffer b: q, then do
  unsigned char* vs = ks + ST * TB;
  unsigned char* ms = vs + ST * TB;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ms + ST * MASK_BYTES);
  uint64_t* q_empty = q_full + QB;
  uint64_t* full = q_empty + QB;
  uint64_t* empty = full + ST;

  const int off = a.sk - a.sq;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int b = 0; b < QB; ++b) {
      sm::mbar_init(&q_full[b], 1);
      sm::mbar_init(&q_empty[b], 2);   // one arrival per consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], 2);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the q buffers and the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    const int es = a.bias_kind == ROW_F32 ? 4 : 2;
    int kc = 0, it = 0;
    for (int i = 2 * blockIdx.x; i < a.items; i = sm::walk_next(i), ++it) {
      int bh, qt;
      sm::walk_item(i, a.n_t, true, bh, qt);
      const int q0 = qt * TILE;
      const int n_kb = pt::kv_tiles<TILE, TILE>(q0, a.sk, off, a.causal);
      const int b = it % QB;
      unsigned char* qb = qs + b * 2 * TB;
      sm::mbar_wait(&q_empty[b], ((it / QB) & 1) ^ 1);
      sm::mbar_expect_tx(&q_full[b], 2 * TB);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm::tma_load_3d(qb + c * BOX, &tq, &q_full[b], c * 64, q0, bh);
        sm::tma_load_3d(qb + TB + c * BOX, &tdo, &q_full[b], c * 64, q0,
                        bh);
      }
      const char* brow = nullptr;
      const int* kseg = nullptr;
      if (MK != MK_NONE) {
        if (a.bias_kind == ROW_F32 || a.bias_kind == ROW_BF16)
          brow = static_cast<const char*>(a.mask.bias) +
                 (size_t)pt::bias_slice(a.mask, bh) * a.sk * es;
        if (a.mask.kseg)
          kseg = a.mask.kseg + (size_t)(bh / a.mask.heads) * a.sk;
      }
      const uint32_t bytes = 2 * TB + (brow ? TILE * es : 0) +
                             (kseg ? TILE * 4 : 0);
      for (int kb = 0; kb < n_kb; ++kb, ++kc) {
        const int s = kc % ST;
        sm::mbar_wait(&empty[s], ((kc / ST) & 1) ^ 1);
        sm::mbar_expect_tx(&full[s], bytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm::tma_load_3d(ks + s * TB + c * BOX, &tk, &full[s], c * 64,
                          kb * TILE, bh);
          sm::tma_load_3d(vs + s * TB + c * BOX, &tv, &full[s], c * 64,
                          kb * TILE, bh);
        }
        if (brow)
          sm::bulk_load(ms + s * MASK_BYTES, brow + (size_t)kb * TILE * es,
                        TILE * es, &full[s]);
        if (kseg)
          sm::bulk_load(ms + s * MASK_BYTES + pt::KSEG_AT, kseg + kb * TILE,
                        TILE * 4, &full[s]);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, t = threadIdx.x % 128;
  const int lane = t % 32, g = lane / 4, tl = lane % 4;
  // this thread's first row in the item's 128 (and the row 8 below)
  const int r0 = cw * 64 + (t / 32) * 16 + g;

  float s[TILE / 2];               // S, then dS: 64 x 128 f32
  float dp[TILE / 2];              // dP
  float acc[D / 2];                // dQ: 64 x D f32
  uint32_t da[TILE / 16][4];       // dS in bf16: the A operand of dS . k

  int kc = 0, it = 0;
  int pending = -1;                // the q buffer whose dQ store is in flight
  // the previous item's store has read its q buffer: it may take a new q
  auto release_q = [&]() {
    if (pending >= 0 && t == 0) {
      sm::bulk_wait_read();
      sm::mbar_arrive(&q_empty[pending]);
    }
    pending = -1;
  };
  for (int i = 2 * blockIdx.x; i < a.items; i = sm::walk_next(i), ++it) {
    int bh, qt;
    sm::walk_item(i, a.n_t, true, bh, qt);
    const int q0 = qt * TILE;
    const int n_kb = pt::kv_tiles<TILE, TILE>(q0, a.sk, off, a.causal);
    const int b = it % QB;
    const int row[2] = {q0 + r0, q0 + r0 + 8};
    float lse2[2], dl[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      lse2[hi] = lse_or_inf(a.lse + (size_t)bh * a.sq, row[hi], a.sq, LOG2E);
      dl[hi] = row[hi] < a.sq ? a.delta[(size_t)bh * a.sq + row[hi]] : 0.f;
    }
    // masks: this thread's rows' segment ids, a full bias's rows
    int qseg[2] = {0, 0};
    const float* bf_rows[2] = {nullptr, nullptr};
    const bf16* bh_rows[2] = {nullptr, nullptr};
    if (MK == MK_ANY) {
      const size_t batch = (size_t)(bh / a.mask.heads);
      if (a.mask.qseg) {
        qseg[0] = a.mask.qseg[batch * a.sq + row[0]];
        qseg[1] = a.mask.qseg[batch * a.sq + row[1]];
      }
      if (a.bias_kind == FULL_F32 || a.bias_kind == FULL_BF16) {
        const size_t sl = (size_t)pt::bias_slice(a.mask, bh) * a.sq;
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const size_t at = (sl + row[hi]) * a.sk;
          if (a.bias_kind == FULL_F32)
            bf_rows[hi] = static_cast<const float*>(a.mask.bias) + at;
          else
            bh_rows[hi] = static_cast<const bf16*>(a.mask.bias) + at;
        }
      }
    }
    zero(acc);
    release_q();
    unsigned char* qb = qs + b * 2 * TB;
    const unsigned char* qa = qb + cw * 64 * 128;        // this warpgroup's
    const unsigned char* oa = qb + TB + cw * 64 * 128;   // rows of q and do
    sm::mbar_wait(&q_full[b], (it / QB) & 1);

    // dS = p (dP - delta) into s, from S and dP of key tile j in
    // registers: p = 2^(x - lse log2e) with x = s scale log2e (+ bias
    // log2e).  EDGE (a std::bool_constant): the tile crosses the diagonal
    // or the end of the keys, and the keys past a row's last visible one
    // give p = 0; the other tiles compile without that code.
    auto grads = [&](auto edge, int j, int st) {
      const int k0 = j * TILE;
      pt::mask_tile<MK>(s, ms + st * MASK_BYTES, a.mask, a.bias_kind,
                        a.scale2, k0, tl, qseg, bf_rows, bh_rows);
      // without a mask s stays in its own units (-inf is -inf in both)
      if constexpr (decltype(edge)::value) {
        // row hi sees the keys below min(sk, row + off + 1): counted from
        // this thread's first key of the tile, k0 + 2 tl
        int vis[2];
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int end = a.causal ? min(a.sk, row[hi] + off + 1) : a.sk;
          vis[hi] = end - k0 - 2 * tl;
        }
#pragma unroll
        for (int e = 0; e < TILE / 2; ++e)
          if (8 * (e >> 2) + (e & 1) >= vis[(e >> 1) & 1])
            s[e] = -CUDART_INF_F;
      }
#pragma unroll
      for (int e = 0; e < TILE / 2; ++e) {
        const int hi = (e >> 1) & 1;
        const float p =
            pt::ex2(MK == MK_NONE ? fmaf(s[e], a.scale2, -lse2[hi])
                                  : s[e] - lse2[hi]);
        s[e] = p * (dp[e] - dl[hi]);
      }
    };
    auto tile = [&](auto edge, int j) {
      const int st = kc % ST;
      const unsigned char* kt = ks + st * TB;
      sm::mbar_wait(&full[st], (kc / ST) & 1);
      sm::fence_acc(s);
      sm::fence_acc(dp);
      sm::wgmma_fence();
      issue_scores<D>(s, qa, BOX, kt, BOX);
      issue_scores<D>(dp, oa, BOX, vs + st * TB, BOX);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_acc(s);
      sm::fence_acc(dp);
      grads(edge, j, st);
      sm::pack_a<TILE>(da, s);
      sm::fence_acc(acc);
#pragma unroll
      for (int kk = 0; kk < TILE / 16; ++kk) sm::fence_acc(da[kk]);
      sm::wgmma_fence();
      issue_grad<TILE>(acc, da, kt, BOX);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_acc(acc);
      if (t == 0) sm::mbar_arrive(&empty[st]);
      ++kc;
    };
    // the tiles crossing the diagonal or the key end are a suffix: from
    // the first whose last key is past the first row's (or the keys') end
    int edge0 = (a.sk - TILE) / TILE + 1;    // the first tile past sk - TILE
    if (a.sk < TILE) edge0 = 0;
    if (a.causal) {
      // the first row of this warpgroup sees keys up to q0 + cw 64 + off
      const int lim = q0 + cw * 64 + off + 1 - TILE;
      const int first = lim < 0 ? 0 : lim / TILE + 1;
      edge0 = min(edge0, first);
    }
    int j = 0;
    for (; j < min(edge0, n_kb); ++j) tile(std::false_type{}, j);
    for (; j < n_kb; ++j) tile(std::true_type{}, j);

    // epilogue: dQ scale in bf16 into this warpgroup's 64 rows of the q
    // buffer (its q is no longer read), then one TMA store per 64
    // columns, which drops rows past Sq
    sm::stage_rows<D>(qb, BOX, acc, {a.scale, a.scale}, r0, tl);
    sm::fence_proxy_async();
    sm::named_barrier(1 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        sm::tma_store_3d(&tdq, qa + c * BOX, c * 64, q0 + cw * 64, bh);
      sm::bulk_commit();
    }
    pending = b;
  }
  release_q();
}

template <int D, int MK>
__global__ void __launch_bounds__(WT, 1)
    fa_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdk,
                            const __grid_constant__ CUtensorMap tdv,
                            const BwdArgs a) {
  using C = DkvCfg<D>;
  constexpr int ST = C::ST, KB = C::KVBUF, TQ = C::TQ;
  constexpr int KBY = C::K_BYTES, QBY = C::Q_BYTES, QBOX = C::QBOX;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* kvs =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* qs = kvs + KB * 2 * KBY;    // buffer b: k, then v
  unsigned char* os = qs + ST * QBY;         // do
  float* ls = reinterpret_cast<float*>(os + ST * QBY);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ls + 2 * C::LSE_FLOATS);
  uint64_t* kv_empty = kv_full + KB;
  uint64_t* full = kv_empty + KB;
  uint64_t* empty = full + ST;

  const int off = a.sk - a.sq;
  const int n_qt = (a.sq + TQ - 1) / TQ;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int b = 0; b < KB; ++b) {
      sm::mbar_init(&kv_full[b], 1);
      sm::mbar_init(&kv_empty[b], 2);
    }
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(&full[s], 1);
      sm::mbar_init(&empty[s], 2);
    }
    sm::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the k / v buffers and the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x != 0) return;
    int qc = 0, it = 0;
    for (int i = 2 * blockIdx.x; i < a.items; i = sm::walk_next(i), ++it) {
      int bh, kt;
      sm::walk_item(i, a.n_t, false, bh, kt);
      const int k0 = kt * TILE;
      const int b = it % KB;
      unsigned char* kb = kvs + b * 2 * KBY;
      sm::mbar_wait(&kv_empty[b], ((it / KB) & 1) ^ 1);
      sm::mbar_expect_tx(&kv_full[b], 2 * KBY);
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm::tma_load_3d(kb + c * BOX, &tk, &kv_full[b], c * 64, k0, bh);
        sm::tma_load_3d(kb + KBY + c * BOX, &tv, &kv_full[b], c * 64, k0,
                        bh);
      }
      for (int qi = pt::first_q_tile(k0, off, a.causal, TQ); qi < n_qt;
           ++qi, ++qc) {
        const int s = qc % ST;
        sm::mbar_wait(&empty[s], ((qc / ST) & 1) ^ 1);
        sm::mbar_expect_tx(&full[s], 2 * QBY);
#pragma unroll
        for (int c = 0; c < D / 64; ++c) {
          sm::tma_load_3d(qs + s * QBY + c * QBOX, &tq, &full[s], c * 64,
                          qi * TQ, bh);
          sm::tma_load_3d(os + s * QBY + c * QBOX, &tdo, &full[s], c * 64,
                          qi * TQ, bh);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, t = threadIdx.x % 128;
  const int lane = t % 32, g = lane / 4, tl = lane % 4;
  // this thread's first key row in the item's 128 (and the row 8 below)
  const int r0 = cw * 64 + (t / 32) * 16 + g;
  // this warpgroup's lse and delta of two query tiles, in turn
  float* lw = ls + cw * C::LSE_FLOATS;

  float s[TQ / 2];                 // S^T, then P^T: 64 keys x TQ
  float dp[TQ / 2];                // dP^T, then dS^T
  float dka[D / 2], dva[D / 2];    // dK, dV: 64 x D f32
  uint32_t pa[TQ / 16][4];         // P^T in bf16: the A operand of P^T . do
  uint32_t da[TQ / 16][4];         // dS^T in bf16: of dS^T . q

  int qc = 0, it = 0;
  int pending = -1;                // the k / v buffer being stored
  auto release_kv = [&]() {
    if (pending >= 0 && t == 0) {
      sm::bulk_wait_read();
      sm::mbar_arrive(&kv_empty[pending]);
    }
    pending = -1;
  };
  for (int i = 2 * blockIdx.x; i < a.items; i = sm::walk_next(i), ++it) {
    int bh, kt;
    sm::walk_item(i, a.n_t, false, bh, kt);
    const int k0 = kt * TILE;
    const int first = pt::first_q_tile(k0, off, a.causal, TQ);
    const int b = it % KB;
    const int krow[2] = {k0 + r0, k0 + r0 + 8};
    const float* lse = a.lse + (size_t)bh * a.sq;
    const float* delta = a.delta + (size_t)bh * a.sq;
    // masks: this thread's keys' bias (in log2 units) and segment ids;
    // the slice's full bias and query segment ids
    float kb2[2] = {0.f, 0.f};
    int kseg[2] = {0, 0};
    const int* qseg = nullptr;
    const float* bf_full = nullptr;
    const bf16* bh_full = nullptr;
    if (MK != MK_NONE) {
      const size_t sl = (size_t)pt::bias_slice(a.mask, bh);
      const size_t batch = (size_t)(bh / a.mask.heads);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        if (a.bias_kind == ROW_F32)
          kb2[hi] = static_cast<const float*>(a.mask.bias)[sl * a.sk +
                                                           krow[hi]] * LOG2E;
        else if (a.bias_kind == ROW_BF16)
          kb2[hi] = __bfloat162float(static_cast<const bf16*>(
                        a.mask.bias)[sl * a.sk + krow[hi]]) * LOG2E;
        if (MK == MK_ANY && a.mask.qseg)
          kseg[hi] = a.mask.kseg[batch * a.sk + krow[hi]];
      }
      if (MK == MK_ANY) {
        if (a.mask.qseg) qseg = a.mask.qseg + batch * a.sq;
        if (a.bias_kind == FULL_F32)
          bf_full = static_cast<const float*>(a.mask.bias) + sl * a.sq * a.sk;
        else if (a.bias_kind == FULL_BF16)
          bh_full = static_cast<const bf16*>(a.mask.bias) + sl * a.sq * a.sk;
      }
    }
    zero(dka);
    zero(dva);
    release_kv();
    unsigned char* kb = kvs + b * 2 * KBY;
    const unsigned char* ka = kb + cw * 64 * 128;         // this warpgroup's
    const unsigned char* va = kb + KBY + cw * 64 * 128;   // rows of k and v
    sm::mbar_wait(&kv_full[b], (it / KB) & 1);

    // lse (log2 units, +inf past sq or on a row with no key) and delta (0
    // past sq) of query tile qi, thread t < TQ holding column t; read a
    // tile ahead, so the load is in flight while a tile computes
    float nl = 0.f, nd = 0.f;
    auto fetch = [&](int qi) {
      const int q = qi * TQ + t;
      if (t < TQ) {
        nl = lse_or_inf(lse, q, a.sq, LOG2E);
        nd = q < a.sq ? delta[q] : 0.f;
      }
    };
    if (first < n_qt) fetch(first);

    // P^T and dS^T = P^T (dP^T - delta) of query tile qi, in s and dp.
    // EDGE: the tile crosses the diagonal, and the queries before a key's
    // first viewer give p = 0.
    auto grads = [&](auto edge, int qi, const float* lb) {
      const int q0 = qi * TQ;
      int lim[2] = {0, 0};
      if constexpr (decltype(edge)::value) {
        // key kr is hidden from query q0 + c iff c < kr - off - q0:
        // counted from this thread's first column, 2 tl
#pragma unroll
        for (int hi = 0; hi < 2; ++hi)
          lim[hi] = krow[hi] - off - q0 - 2 * tl;
      }
#pragma unroll
      for (int jn = 0; jn < TQ / 8; ++jn) {
        const int c = 8 * jn + 2 * tl;             // the pair's first query
        const float2 l2 = *reinterpret_cast<const float2*>(lb + c);
        const float2 d2 = *reinterpret_cast<const float2*>(lb + TQ + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hi = e >> 1, lo = e & 1;
          const int x_i = 4 * jn + e;
          float x;
          if constexpr (MK == MK_NONE) {
            x = s[x_i] * a.scale2;
          } else if constexpr (MK == MK_ROW) {
            x = fmaf(s[x_i], a.scale2, kb2[hi]);
          } else {
            const int q = q0 + c + lo;
            x = s[x_i] * a.scale2;
            if (bf_full)
              x += bf_full[(size_t)q * a.sk + krow[hi]] * LOG2E;
            else if (bh_full)
              x += __bfloat162float(bh_full[(size_t)q * a.sk + krow[hi]]) *
                   LOG2E;
            else
              x += kb2[hi];
            if (qseg && qseg[q] != kseg[hi]) x = -CUDART_INF_F;
          }
          if constexpr (decltype(edge)::value)
            if (8 * jn + lo < lim[hi]) x = -CUDART_INF_F;
          const float p = pt::ex2(x - (lo ? l2.y : l2.x));
          s[x_i] = p;
          dp[x_i] = p * (dp[x_i] - (lo ? d2.y : d2.x));
        }
      }
    };
    auto tile = [&](auto edge, int qi) {
      const int st = qc % ST;
      float* lb = lw + (qc & 1) * 2 * TQ;
      if (t < TQ) {
        lb[t] = nl;
        lb[TQ + t] = nd;
      }
      if (qi + 1 < n_qt) fetch(qi + 1);
      // the warpgroup's lse / delta are in place (and the tile two back's
      // have been read)
      sm::named_barrier(1 + cw, 128);
      const unsigned char* qt = qs + st * QBY;
      const unsigned char* ot = os + st * QBY;
      sm::mbar_wait(&full[st], (qc / ST) & 1);
      sm::fence_acc(s);
      sm::fence_acc(dp);
      sm::wgmma_fence();
      issue_scores<D>(s, ka, BOX, qt, QBOX);
      issue_scores<D>(dp, va, BOX, ot, QBOX);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_acc(s);
      sm::fence_acc(dp);
      grads(edge, qi, lb);
      sm::pack_a<TQ>(pa, s);
      sm::pack_a<TQ>(da, dp);
      sm::fence_acc(dka);
      sm::fence_acc(dva);
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        sm::fence_acc(pa[kk]);
        sm::fence_acc(da[kk]);
      }
      sm::wgmma_fence();
      issue_grad<TQ>(dva, pa, ot, QBOX);
      issue_grad<TQ>(dka, da, qt, QBOX);
      sm::wgmma_commit();
      sm::wgmma_wait<0>();
      sm::fence_acc(dka);
      sm::fence_acc(dva);
      if (t == 0) sm::mbar_arrive(&empty[st]);
      ++qc;
    };
    // the tiles crossing the diagonal are a prefix: up to the first whose
    // first query sees this warpgroup's last key, k0 + cw 64 + 63
    int edge_end = first;
    if (a.causal) {
      const int lim = k0 + cw * 64 + 63 - off;   // tile qi crosses iff
      edge_end = lim <= 0 ? 0 : (lim + TQ - 1) / TQ;   // qi TQ < lim
    }
    int qi = first;
    for (; qi < min(edge_end, n_qt); ++qi) tile(std::true_type{}, qi);
    for (; qi < n_qt; ++qi) tile(std::false_type{}, qi);

    // epilogue: dK scale and dV in bf16 into this warpgroup's 64 rows of
    // the k and v buffers (no longer read), then TMA stores, which drop
    // rows past Sk
    sm::stage_rows<D>(kb, BOX, dka, {a.scale, a.scale}, r0, tl);
    sm::stage_rows<D>(kb + KBY, BOX, dva, {1.f, 1.f}, r0, tl);
    sm::fence_proxy_async();
    sm::named_barrier(1 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        sm::tma_store_3d(&tdk, ka + c * BOX, c * 64, k0 + cw * 64, bh);
        sm::tma_store_3d(&tdv, va + c * BOX, c * 64, k0 + cw * 64, bh);
      }
      sm::bulk_commit();
    }
    pending = b;
  }
  release_kv();
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

  const int n_kb = pt::kv_tiles<BQ, BK>(q0, sk, off, causal);
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
  for (int qi = pt::first_q_tile(k0, off, causal, BQ); qi < n_qb; ++qi) {
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

// the arguments of a bf16 launch over n_t tiles a slice, and its grid:
// one block per SM (or per pair of items, when there are fewer)
cudaError_t wgmma_args(const float* lse, const float* delta,
                       const pt::AttnMask& mask, int bh, int sq, int sk,
                       int causal, float scale, int n_t, BwdArgs* a,
                       int* grid) {
  const long long items = (long long)bh * n_t;
  if (items > INT_MAX / 2) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *a = BwdArgs{lse, delta,  mask, pt::bias_kind(mask), bh,    sq,
               sk,  causal, n_t,  (int)items,          scale, scale * LOG2E};
  const long long pairs = (items + 1) / 2;
  *grid = pairs < sms ? (int)pairs : sms;
  return cudaSuccess;
}

template <int D, int MK>
cudaError_t launch_dq_wgmma(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const pt::AttnMask& mask,
                            void* dq, int bh, int sq, int sk, int causal,
                            float scale, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap tq, tdo, tk, tv, tdq;
  if (!sm::bf16_map_3d(&tq, q, bh, sq, D, TILE) ||
      !sm::bf16_map_3d(&tdo, dout, bh, sq, D, TILE) ||
      !sm::bf16_map_3d(&tk, k, bh, sk, D, TILE) ||
      !sm::bf16_map_3d(&tv, v, bh, sk, D, TILE) ||
      !sm::bf16_map_3d(&tdq, dq, bh, sq, D, 64))
    return cudaErrorInvalidValue;
  BwdArgs a;
  int grid = 0;
  cudaError_t err = wgmma_args(lse, delta, mask, bh, sq, sk, causal, scale,
                               (sq + TILE - 1) / TILE, &a, &grid);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute((const void*)fa_bwd_dq_wgmma_kernel<D, MK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_wgmma_kernel<D, MK><<<grid, WT, C::SMEM, stream>>>(
      tq, tdo, tk, tv, tdq, a);
  return cudaGetLastError();
}

template <int D, int MK>
cudaError_t launch_dkv_wgmma(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, const pt::AttnMask& mask,
                             void* dk, void* dv, int bh, int sq, int sk,
                             int causal, float scale, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  if (!sm::bf16_map_3d(&tq, q, bh, sq, D, C::TQ) ||
      !sm::bf16_map_3d(&tdo, dout, bh, sq, D, C::TQ) ||
      !sm::bf16_map_3d(&tk, k, bh, sk, D, TILE) ||
      !sm::bf16_map_3d(&tv, v, bh, sk, D, TILE) ||
      !sm::bf16_map_3d(&tdk, dk, bh, sk, D, 64) ||
      !sm::bf16_map_3d(&tdv, dv, bh, sk, D, 64))
    return cudaErrorInvalidValue;
  BwdArgs a;
  int grid = 0;
  cudaError_t err = wgmma_args(lse, delta, mask, bh, sq, sk, causal, scale,
                               (sk + TILE - 1) / TILE, &a, &grid);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute((const void*)fa_bwd_dkv_wgmma_kernel<D, MK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  fa_bwd_dkv_wgmma_kernel<D, MK><<<grid, WT, C::SMEM, stream>>>(
      tq, tdo, tk, tv, tdk, tdv, a);
  return cudaGetLastError();
}

// the bf16 instantiation of a call: D and the mask kind
template <int D>
cudaError_t dq_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const pt::AttnMask& mask, void* dq, int bh, int sq,
                     int sk, int causal, float scale, cudaStream_t s) {
  switch (pt::mask_kind(mask)) {
    case MK_NONE:
      return launch_dq_wgmma<D, MK_NONE>(q, k, v, dout, lse, delta, mask, dq,
                                         bh, sq, sk, causal, scale, s);
    case MK_ROW:
      return launch_dq_wgmma<D, MK_ROW>(q, k, v, dout, lse, delta, mask, dq,
                                        bh, sq, sk, causal, scale, s);
    default:
      return launch_dq_wgmma<D, MK_ANY>(q, k, v, dout, lse, delta, mask, dq,
                                        bh, sq, sk, causal, scale, s);
  }
}

template <int D>
cudaError_t dkv_wgmma(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const pt::AttnMask& mask, void* dk, void* dv, int bh,
                      int sq, int sk, int causal, float scale,
                      cudaStream_t s) {
  switch (pt::mask_kind(mask)) {
    case MK_NONE:
      return launch_dkv_wgmma<D, MK_NONE>(q, k, v, dout, lse, delta, mask, dk,
                                          dv, bh, sq, sk, causal, scale, s);
    case MK_ROW:
      return launch_dkv_wgmma<D, MK_ROW>(q, k, v, dout, lse, delta, mask, dk,
                                         dv, bh, sq, sk, causal, scale, s);
    default:
      return launch_dkv_wgmma<D, MK_ANY>(q, k, v, dout, lse, delta, mask, dk,
                                         dv, bh, sq, sk, causal, scale, s);
  }
}

template <int D, bool MASKED>
cudaError_t launch_dq_fma(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse,
                          const float* delta, const pt::AttnMask& mask,
                          void* dq, int bh, int sq, int sk, int causal,
                          float scale, cudaStream_t stream) {
  const size_t smem = dq_fma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fa_bwd_dq_fma_kernel<D, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_bwd_dq_fma_kernel<D, MASKED><<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<cptr<float>>(q), static_cast<cptr<float>>(k),
      static_cast<cptr<float>>(v), static_cast<cptr<float>>(dout), lse,
      delta, mask, static_cast<float*>(dq), sq, sk, causal, scale);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dkv_fma(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse,
                           const float* delta, const pt::AttnMask& mask,
                           void* dk, void* dv, int bh, int sq, int sk,
                           int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_fma_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fa_bwd_dkv_fma_kernel<D, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sk + BK - 1) / BK, bh);
  fa_bwd_dkv_fma_kernel<D, MASKED><<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<cptr<float>>(q), static_cast<cptr<float>>(k),
      static_cast<cptr<float>>(v), static_cast<cptr<float>>(dout), lse,
      delta, mask, static_cast<float*>(dk), static_cast<float*>(dv), sq, sk,
      causal, scale);
  return cudaGetLastError();
}

// what neither kernel takes; bf16 pointers (the masks' included, which the
// dq kernel copies in 16-byte units) must be 16-byte aligned
bool bad_args(const void* const* ptrs, int n, int bh, int sq, int sk, int d,
              int dtype, const pt::AttnMask& mask) {
  if (bh <= 0 || sq <= 0 || sk <= 0 || (d != 64 && d != 128) ||
      (dtype != 0 && dtype != 1) || pt::slice_chunk(mask) <= 0 ||
      pt::bad_mask(mask, bh, sq, sk, TILE))
    return true;
  if (dtype == 1) {
    for (int i = 0; i < n; ++i)
      if (pt::misaligned(ptrs[i])) return true;
    if (pt::misaligned(mask.bias) || pt::misaligned(mask.qseg) ||
        pt::misaligned(mask.kseg))
      return true;
  }
  return false;
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
  const void* ptrs[] = {q, k, v, dout, dq};
  if (bad_args(ptrs, 5, bh, sq, sk, d, dtype, mask))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)   // the persistent kernel walks any B*H in one launch
    return d == 64 ? dq_wgmma<64>(q, k, v, dout, lse, delta, mask, dq, bh,
                                  sq, sk, causal, scale, s)
                   : dq_wgmma<128>(q, k, v, dout, lse, delta, mask, dq, bh,
                                   sq, sk, causal, scale, s);
  const bool msk = masked(mask);
  // f32: B*H past grid y runs in chunks
  return pt::for_each_chunk(mask, bh, pt::slice_chunk(mask), 1, sq, sk,
                            [&](int bh0, int n, const pt::AttnMask& m) {
    const size_t qo = (size_t)bh0 * sq * d, ko = (size_t)bh0 * sk * d;
    const void *qc = pt::advance(q, qo, 4), *kc = pt::advance(k, ko, 4),
               *vc = pt::advance(v, ko, 4), *oc = pt::advance(dout, qo, 4);
    const float *lc = lse + (size_t)bh0 * sq, *dc = delta + (size_t)bh0 * sq;
    void* gc = pt::advance(dq, qo, 4);
    return d == 64
               ? (msk ? launch_dq_fma<64, true> : launch_dq_fma<64, false>)(
                     qc, kc, vc, oc, lc, dc, m, gc, n, sq, sk, causal, scale,
                     s)
               : (msk ? launch_dq_fma<128, true> : launch_dq_fma<128, false>)(
                     qc, kc, vc, oc, lc, dc, m, gc, n, sq, sk, causal, scale,
                     s);
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
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  if (bad_args(ptrs, 6, bh, sq, sk, d, dtype, mask))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)   // the persistent kernel walks any B*H in one launch
    return d == 64 ? dkv_wgmma<64>(q, k, v, dout, lse, delta, mask, dk, dv,
                                   bh, sq, sk, causal, scale, s)
                   : dkv_wgmma<128>(q, k, v, dout, lse, delta, mask, dk, dv,
                                    bh, sq, sk, causal, scale, s);
  const bool msk = masked(mask);
  // f32: B*H past grid y runs in chunks
  return pt::for_each_chunk(mask, bh, pt::slice_chunk(mask), 1, sq, sk,
                            [&](int bh0, int n, const pt::AttnMask& m) {
    const size_t qo = (size_t)bh0 * sq * d, ko = (size_t)bh0 * sk * d;
    const void *qc = pt::advance(q, qo, 4), *kc = pt::advance(k, ko, 4),
               *vc = pt::advance(v, ko, 4), *oc = pt::advance(dout, qo, 4);
    const float *lc = lse + (size_t)bh0 * sq, *dc = delta + (size_t)bh0 * sq;
    void *kg = pt::advance(dk, ko, 4), *vg = pt::advance(dv, ko, 4);
    return d == 64
               ? (msk ? launch_dkv_fma<64, true> : launch_dkv_fma<64, false>)(
                     qc, kc, vc, oc, lc, dc, m, kg, vg, n, sq, sk, causal,
                     scale, s)
               : (msk ? launch_dkv_fma<128, true>
                      : launch_dkv_fma<128, false>)(
                     qc, kc, vc, oc, lc, dc, m, kg, vg, n, sq, sk, causal,
                     scale, s);
  });
}
