// Causal / full flash-attention forward for Hopper (sm_90a), with an
// optional additive bias and segment ids, bound through a plain C interface
// (ctypes).
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
// Masks (the MASKED instantiations; reference `_mask_tile` :176): slice bh
// reads bias slice g(bh) of the folded (Bb*Hb, Sqb, Sk) bias, at row q when
// Sqb = Sq and row 0 when Sqb = 1, and the segment ids of batch bh / H.
// The score becomes s * scale + bias in f32, then -inf where the segment
// ids differ, then the causal and tail masks, as in the reference.  A bool
// mask arrives as a 0 / -inf bias; a finite bias such as BERT's -1e30
// stays finite.  Masked calls take no sequence tails (both lengths are
// multiples of 128).
//
// Design (bf16, the model's path): a persistent, warp-specialised kernel
// fed by TMA and multiplying on wgmma.  One block per SM walks work items
// (bh, 128-row query tile).  A block takes two items at a time, a slice's
// query tiles paired heaviest with lightest (n_qt - 1 with 0, ...), so
// under the causal mask every pair costs the same, and the blocks walk
// the slices together, which keeps the k and v of the slices in flight in
// L2.  A block is three warpgroups:
//  - the producer (one thread) loads an item's q once into one of two q
//    buffers, then its k and v tiles of 128 keys into a ring of stages
//    (four at D = 64, two at D = 128), with a "full" and an "empty"
//    mbarrier for each of k and v; it runs ahead into the next item while
//    the consumers finish this one.  The tensor maps are 3-D over
//    (D, S, B*H), so a tile never reads into the next head: rows past S
//    read 0 and stores past Sq are dropped.  With a mask, the bias row of
//    a one-row bias (BERT's padding) and the key segment ids of each key
//    tile ride the k stage as bulk copies;
//  - two consumer warpgroups own 64 query rows each and take turns to
//    issue their products (named barriers), so that one's softmax runs
//    while the other's products keep the tensor cores busy.  S_j = q.k_j^T
//    is wgmma m64n128k16 with both operands in shared memory (K-major: D
//    contiguous), issued beside O += p_{j-1}.v_{j-1}, wgmma m64nDk16 with
//    A, the bf16 p, taken from registers (the f32 accumulator of two n8
//    blocks is the A fragment of one k16 step) and v read MN-major through
//    the transpose bit.  The softmax of tile j runs on S_j in registers
//    while p_{j-1}.v_{j-1} is in flight, in base 2 on ex2.approx; O is
//    rescaled before the next products are issued.  The causal and key-end
//    masks cost only the tiles that cross the diagonal or the end (a
//    separate instantiation of the tile step).  The epilogue writes O / l
//    in bf16 into the item's q buffer (its q is no longer read) in the
//    swizzle of the output's map, and one thread a warpgroup stores it
//    with TMA; lse is written by row.
//  - masks are instantiations: none; one f32 bias row a slice and no
//    segment ids (BERT's padding bias, one FFMA a score); any other bias
//    class or segment ids, read by kind at run time (a full bias from
//    device memory).
// Each row of an item is computed by one block in a fixed key order, no
// atomics: two calls are bitwise equal.
//
// f32 (tests and the small reference model): one block per (bh, 64-row
// query tile), 256 threads, tiles staged as f32, each thread a 4x4 patch
// of the score tile and a 4 x D/16 patch of the output, products on the
// f32 FMA units.
//
// What bounds it.  The causal work at GPT-2 345M shapes (B*H = 8*16,
// S = 1024, D = 64) is 4*B*H*D*S(S+1)/2 = 17.2 GFLOP per layer: 17 us at
// the card's 989 TFLOP/s bf16 tensor-core peak; its bytes (q, k, v, out in
// bf16 plus lse: 67 MB) take 20 us at 3.35 TB/s, so bytes bound it by a
// hair.  128 x 128 tiles compute the diagonal tiles whole (19.3 GFLOP),
// and a tile's 64 exponentials a thread take the special-function units
// (16 a cycle an SM) as long as its products take the tensor cores; at
// D = 64 the softmax's instruction latency, more than those units, keeps
// a warpgroup from its next products (PERF.md, Findings).  BERT-base's
// layer (S = 128) has one key tile an item and is bound by its bytes: the
// persistent loop loads the next item while this one computes.
#include <limits.h>

#include <type_traits>

#include "common.cuh"
#include "hopper_gemm.cuh"

namespace {

using pt::bf16;
namespace sm = pt::sm90;

constexpr int BQ = 64;    // f32: query rows per block
constexpr int BK = 64;    // f32: keys per tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// bf16: warp-specialised, TMA and wgmma
// ---------------------------------------------------------------------------

constexpr int WQ = 128;          // query rows per work item
constexpr int WK = 128;          // keys per tile
constexpr int WT = 384;          // a producer and two consumer warpgroups
constexpr int QBUF = 2;          // q buffers: the next item's q loads early
using pt::MASK_BYTES;            // a stage's bias row and key ids
using pt::MK_ANY;
using pt::MK_NONE;
using pt::MK_ROW;
using pt::ROW_BF16;
using pt::ROW_F32;
using pt::FULL_BF16;
using pt::FULL_F32;

template <int D>
struct Cfg {
  static constexpr int STAGES = D == 64 ? 4 : 2;   // (k, v) tiles in flight
  static constexpr int QBOX = WQ * 128;      // one 64-column box of q
  static constexpr int Q_BYTES = WQ * D * 2;
  static constexpr int KBOX = WK * 128;      // one 64-column box of k or v
  static constexpr int KV_BYTES = WK * D * 2;
  static constexpr size_t SMEM =
      1024 + QBUF * Q_BYTES + STAGES * (2 * KV_BYTES + MASK_BYTES) +
      (2 * QBUF + 4 * STAGES) * sizeof(uint64_t);
};

struct FwdArgs {
  float* lse;
  pt::AttnMask mask;
  int bias_kind;     // pt::BiasKind
  int bh, sq, sk, causal;
  int n_qt;          // query tiles of WQ rows a slice
  int items;         // bh * n_qt
  float scale2;      // scale * log2(e)
};

template <int D, int MK>
__global__ void __launch_bounds__(WT, 1)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap to,
                        const FwdArgs a) {
  using C = Cfg<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* qs =
      smem_raw + ((1024 - (sm::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ks = qs + QBUF * C::Q_BYTES;
  unsigned char* vs = ks + ST * C::KV_BYTES;
  unsigned char* ms = vs + ST * C::KV_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ms + ST * MASK_BYTES);
  uint64_t* q_empty = q_full + QBUF;
  uint64_t* k_full = q_empty + QBUF;
  uint64_t* v_full = k_full + ST;
  uint64_t* k_empty = v_full + ST;
  uint64_t* v_empty = k_empty + ST;

  const int off = a.sk - a.sq;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int b = 0; b < QBUF; ++b) {
      sm::mbar_init(&q_full[b], 1);
      sm::mbar_init(&q_empty[b], 2);   // one arrival per consumer warpgroup
    }
    for (int s = 0; s < ST; ++s) {
      sm::mbar_init(&k_full[s], 1);
      sm::mbar_init(&v_full[s], 1);
      sm::mbar_init(&k_empty[s], 2);
      sm::mbar_init(&v_empty[s], 2);
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
      sm::walk_item(i, a.n_qt, true, bh, qt);
      const int q0 = qt * WQ;
      const int n_kb = pt::kv_tiles<WQ, WK>(q0, a.sk, off, a.causal);
      const int b = it % QBUF;
      sm::mbar_wait(&q_empty[b], ((it / QBUF) & 1) ^ 1);
      sm::mbar_expect_tx(&q_full[b], C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        sm::tma_load_3d(qs + b * C::Q_BYTES + c * C::QBOX, &tq, &q_full[b],
                        c * 64, q0, bh);
      const char* brow = nullptr;
      const int* kseg = nullptr;
      if (MK != MK_NONE) {
        if (a.bias_kind == ROW_F32 || a.bias_kind == ROW_BF16)
          brow = static_cast<const char*>(a.mask.bias) +
                 (size_t)pt::bias_slice(a.mask, bh) * a.sk * es;
        if (a.mask.kseg)
          kseg = a.mask.kseg + (size_t)(bh / a.mask.heads) * a.sk;
      }
      const uint32_t k_bytes = C::KV_BYTES + (brow ? WK * es : 0) +
                               (kseg ? WK * 4 : 0);
      for (int kb = 0; kb < n_kb; ++kb, ++kc) {
        const int s = kc % ST;
        const uint32_t ph = ((kc / ST) & 1) ^ 1;
        sm::mbar_wait(&k_empty[s], ph);
        sm::mbar_expect_tx(&k_full[s], k_bytes);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm::tma_load_3d(ks + s * C::KV_BYTES + c * C::KBOX, &tk, &k_full[s],
                          c * 64, kb * WK, bh);
        if (brow)
          sm::bulk_load(ms + s * MASK_BYTES, brow + (size_t)kb * WK * es,
                        WK * es, &k_full[s]);
        if (kseg)
          sm::bulk_load(ms + s * MASK_BYTES + pt::KSEG_AT, kseg + kb * WK,
                        WK * 4, &k_full[s]);
        sm::mbar_wait(&v_empty[s], ph);
        sm::mbar_expect_tx(&v_full[s], C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          sm::tma_load_3d(vs + s * C::KV_BYTES + c * C::KBOX, &tv, &v_full[s],
                          c * 64, kb * WK, bh);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = wg - 1, t = threadIdx.x % 128;
  const int lane = t % 32, g = lane / 4, tl = lane % 4;
  // this thread's first row in the item's 128 (and the row 8 below)
  const int r0 = cw * 64 + (t / 32) * 16 + g;

  // The two consumer warpgroups take turns to issue their products
  // (named barriers 3 and 4), so that one's softmax runs while the
  // other's products keep the tensor cores busy; warpgroup 0 goes first.
  auto turn = [&]() { sm::named_barrier(3 + cw, 256); };
  auto pass = [&]() { sm::named_barrier_arrive(3 + (cw ^ 1), 256); };
  if (cw == 1) sm::named_barrier_arrive(3, 256);

  float o[D / 2];                  // O: 64 x D f32, D/8 n8 blocks
  float s[WK / 2];                 // S, then p: 64 x 128 f32
  uint32_t pa[WK / 16][4];         // p in bf16: the A operand of p . v
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.f;
#pragma unroll
  for (int e = 0; e < WK / 2; ++e) s[e] = 0.f;

  int kc = 0, it = 0;
  int pending = -1;                // the q buffer whose O store is in flight
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
    sm::walk_item(i, a.n_qt, true, bh, qt);
    const int q0 = qt * WQ;
    const int n_kb = pt::kv_tiles<WQ, WK>(q0, a.sk, off, a.causal);
    const int b = it % QBUF;
    const int row[2] = {q0 + r0, q0 + r0 + 8};
    // the first row of this warpgroup sees keys up to q0 + cw * 64 + off
    const int diag = q0 + cw * 64 + off;
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
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};   // in base 2
    float l[2] = {0.f, 0.f};
    float alpha[2] = {0.f, 0.f};
    const unsigned char* qb = qs + b * C::Q_BYTES;
    sm::mbar_wait(&q_full[b], (it / QBUF) & 1);

    // S_j = q . k_j^T over D (K-major operands; 16 of D are 32 bytes on)
    auto issue_s = [&](int st) {
      const unsigned char* kt = ks + st * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, kin = (kk % 4) * 32;
        const uint64_t da =
            sm::desc_sw128(qb + c * C::QBOX + cw * 64 * 128 + kin, 16, 1024);
        const uint64_t db = sm::desc_sw128(kt + c * C::KBOX + kin, 16, 1024);
        sm::wgmma_m64n128k16_ss<0, 0>(s, da, db, kk > 0);
      }
    };
    // O = alpha O + p_j . v_j: v is MN-major (D contiguous), 16 keys are
    // 2048 bytes on, the second 64 columns of D a box (WK x 128 B) on
    auto issue_pv = [&](int st, bool first) {
      const unsigned char* vt = vs + st * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) {
        const uint64_t db = sm::desc_sw128(vt + kk * 2048, C::KBOX, 1024);
        if constexpr (D == 64)
          sm::wgmma_m64n64k16_rs<1>(o, pa[kk], db, !first || kk > 0);
        else
          sm::wgmma_m64n128k16_rs<1>(o, pa[kk], db, !first || kk > 0);
      }
    };
    // the online softmax of tile j on S in registers: p = 2^(x - m) with
    // x = s * scale * log2e (+ bias * log2e); the row max and sum over the
    // 4 lanes of a quad.  Without a mask x is never formed: p =
    // 2^(s * scale2 - m), one FFMA.  EDGE (a std::bool_constant): the tile
    // crosses the diagonal or the end of the keys, and the keys past a
    // row's last visible one score -inf; the other tiles compile without
    // that code.
    auto softmax = [&](auto edge, int j, int st) {
      const int k0 = j * WK;
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
        for (int e = 0; e < WK / 2; ++e)
          if (8 * (e >> 2) + (e & 1) >= vis[(e >> 1) & 1])
            s[e] = -CUDART_INF_F;
      }
      // four partial maxima and sums a row, so that no chain of dependent
      // operations runs the length of the tile
      float mx[2][4];
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[e >> 2][e & 3] = -CUDART_INF_F;
#pragma unroll
      for (int e = 0; e < WK / 2; ++e)
        mx[(e >> 1) & 1][(e >> 2) & 3] =
            fmaxf(mx[(e >> 1) & 1][(e >> 2) & 3], s[e]);
      const float unit = MK == MK_NONE ? a.scale2 : 1.f;  // s to base 2
      float mu[2];                                 // the max subtracted
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const float mr = fmaxf(fmaxf(mx[hi][0], mx[hi][1]),
                               fmaxf(mx[hi][2], mx[hi][3]));
        const float m_new = fmaxf(m[hi], pt::group_max<4>(mr) * unit);
        alpha[hi] = m[hi] != -CUDART_INF_F ? pt::ex2(m[hi] - m_new) : 0.f;
        m[hi] = m_new;
        // a row with no key yet: 2^(-inf - 0) = 0
        mu[hi] = m_new != -CUDART_INF_F ? m_new : 0.f;
      }
      float rs[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int e = 0; e < WK / 2; ++e) {
        const int hi = (e >> 1) & 1;
        const float p = pt::ex2(fmaf(s[e], unit, -mu[hi]));
        s[e] = p;
        rs[hi][(e >> 2) & 3] += p;
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
        l[hi] = alpha[hi] * l[hi] +
                pt::group_sum<4>((rs[hi][0] + rs[hi][1]) +
                                 (rs[hi][2] + rs[hi][3]));
    };
    // p in bf16 is the A operand of O += p . v
    auto pack = [&]() { sm::pack_a<WK>(pa, s); };
    auto rescale = [&]() {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e >> 1) & 1];
    };

    // Tile j's S_j is issued beside p_{j-1} . v_{j-1}; the softmax of
    // tile j runs while that product is in flight, and p_j is packed once
    // it has completed (it reads the packed p_{j-1}).  Tile 0 is peeled
    // off, so that every wait in the loop is the same: ptxas keeps the
    // products in flight only where it can tell which have completed.
    // The operand fences pin the softmax's results before the wait, so the
    // compiler cannot sink its exponentials below it.
    auto first_tile = [&](auto edge) {
      const int st = kc % ST;
      sm::mbar_wait(&k_full[st], (kc / ST) & 1);
      turn();
      sm::fence_acc(s);
      sm::wgmma_fence();
      issue_s(st);
      sm::wgmma_commit();
      pass();
      release_q();
      sm::wgmma_wait<0>();
      sm::fence_acc(s);
      if (MK == MK_NONE && t == 0) sm::mbar_arrive(&k_empty[st]);
      softmax(edge, 0, st);
      if (MK != MK_NONE && t == 0) sm::mbar_arrive(&k_empty[st]);  // its mask
      pack();
      ++kc;
    };
    auto next_tile = [&](auto edge, int j) {
      const int st = kc % ST;
      const int sp = (kc + ST - 1) % ST;        // tile j - 1's stage
      sm::mbar_wait(&k_full[st], (kc / ST) & 1);
      sm::mbar_wait(&v_full[sp], ((kc - 1) / ST) & 1);
      turn();
      // O holds p . v up to tile j - 2 (complete): rescale it before any
      // product is in flight, so no register of an asynchronous product
      // is read while it runs (ptxas would serialise them, C7514)
      if (j > 1) rescale();
      sm::fence_acc(s);
      sm::fence_acc(o);
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) sm::fence_acc(pa[kk]);
      sm::wgmma_fence();
      issue_s(st);
      sm::wgmma_commit();
      sm::wgmma_fence();
      issue_pv(sp, j == 1);
      sm::wgmma_commit();
      pass();
      sm::wgmma_wait<1>();             // S_j; p_{j-1} . v_{j-1} runs on
      sm::fence_acc(s);
      if (MK == MK_NONE && t == 0) sm::mbar_arrive(&k_empty[st]);
      softmax(edge, j, st);
      if (MK != MK_NONE && t == 0) sm::mbar_arrive(&k_empty[st]);
      sm::fence_acc(s);
      sm::fence_acc(l);
      sm::wgmma_wait<0>();
      sm::fence_acc(o);
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) sm::fence_acc(pa[kk]);
      if (t == 0) sm::mbar_arrive(&v_empty[sp]);
      pack();
      ++kc;
    };
    // the tiles crossing the diagonal or the key end are a suffix: from
    // the first whose last key is past the first row's (or the keys') end
    int edge0 = (a.sk - WK) / WK + 1;       // the first tile past sk - WK
    if (a.sk < WK) edge0 = 0;
    if (a.causal) {
      const int lim = diag + 1 - WK;         // k0 + WK - 1 > diag
      const int first = lim < 0 ? 0 : lim / WK + 1;
      edge0 = min(edge0, first);
    }
    if (n_kb > 0) {
      if (edge0 <= 0)
        first_tile(std::true_type{});
      else
        first_tile(std::false_type{});
    }
    int j = 1;
    for (; j < min(edge0, n_kb); ++j) next_tile(std::false_type{}, j);
    for (; j < n_kb; ++j) next_tile(std::true_type{}, j);
    if (n_kb > 0) {
      const int sp = (kc + ST - 1) % ST;
      sm::mbar_wait(&v_full[sp], ((kc - 1) / ST) & 1);
      turn();
      if (n_kb > 1) rescale();
      sm::fence_acc(o);
#pragma unroll
      for (int kk = 0; kk < WK / 16; ++kk) sm::fence_acc(pa[kk]);
      sm::wgmma_fence();
      issue_pv(sp, n_kb == 1);
      sm::wgmma_commit();
      pass();
      sm::wgmma_wait<0>();
      sm::fence_acc(o);
      if (t == 0) sm::mbar_arrive(&v_empty[sp]);
    }
    release_q();

    // epilogue: O / l in bf16 into this warpgroup's 64 rows of the q
    // buffer (box c holds columns 64c..64c+63), then one TMA store per 64
    // columns, which drops rows past Sq
    unsigned char* ob = qs + b * C::Q_BYTES;
    float inv[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const bool any = l[hi] > 0.f;
      inv[hi] = any ? 1.f / l[hi] : 0.f;
      if (tl == 0 && row[hi] < a.sq)
        a.lse[(size_t)bh * a.sq + row[hi]] =
            any ? (m[hi] + log2f(l[hi])) * LN2 : -CUDART_INF_F;
    }
    sm::stage_rows<D>(ob, C::QBOX, o, inv, r0, tl);
    sm::fence_proxy_async();
    sm::named_barrier(1 + cw, 128);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        sm::tma_store_3d(&to, ob + c * C::QBOX + cw * 64 * 128, c * 64,
                         q0 + cw * 64, bh);
      sm::bulk_commit();
    }
    pending = b;
  }
  release_q();
  // the last turn warpgroup 1 passed to warpgroup 0
  if (cw == 0) sm::named_barrier(3, 256);
}

template <int D, int MK>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* o, float* lse, const pt::AttnMask& mask,
                         int bh, int sq, int sk, int causal, float scale,
                         cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap tq, tk, tv, to;
  if (!sm::bf16_map_3d(&tq, q, bh, sq, D, WQ) ||
      !sm::bf16_map_3d(&tk, k, bh, sk, D, WK) ||
      !sm::bf16_map_3d(&tv, v, bh, sk, D, WK) ||
      !sm::bf16_map_3d(&to, o, bh, sq, D, 64))
    return cudaErrorInvalidValue;
  const int n_qt = (sq + WQ - 1) / WQ;
  const long long items = (long long)bh * n_qt;
  if (items > INT_MAX / 2) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const FwdArgs a{lse,  mask,  pt::bias_kind(mask), bh, sq, sk, causal,
                  n_qt, (int)items, scale * LOG2E};
  const void* fn = (const void*)fa_fwd_wgmma_kernel<D, MK>;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const long long pairs = (items + 1) / 2;
  const int grid = pairs < sms ? (int)pairs : sms;
  fa_fwd_wgmma_kernel<D, MK><<<grid, WT, C::SMEM, stream>>>(tq, tk, tv,
                                                                 to, a);
  return cudaGetLastError();
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

template <int D, bool MASKED>
__global__ void __launch_bounds__(FMA_THREADS)
    fa_fwd_fma_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      float* __restrict__ lse, pt::AttnMask mask, int sq,
                      int sk, int causal, float scale) {
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
  const pt::SliceMask sm = pt::slice_mask(mask, bh, sq, sk);

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

  const int n_kb = pt::kv_tiles<BQ, BK>(q0, sk, off, causal);
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
        if (MASKED) x = sm.apply(x, qrow, kc, 1.f);
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

template <int D, bool MASKED>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* o,
                       float* lse, const pt::AttnMask& mask, int bh, int sq,
                       int sk, int causal, float scale, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)fa_fwd_fma_kernel<D, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, bh);
  fa_fwd_fma_kernel<D, MASKED><<<grid, FMA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, mask, sq,
      sk, causal, scale);
  return cudaGetLastError();
}

// the instantiation of a call: bf16 or f32, masked or not, D
template <int D>
cudaError_t launch_d(bool bf, const void* q, const void* k, const void* v,
                     void* o, float* lse, const pt::AttnMask& mask, int bh,
                     int sq, int sk, int causal, float scale,
                     cudaStream_t stream) {
  const bool masked = mask.bias || mask.qseg;
  if (bf) {
    switch (pt::mask_kind(mask)) {
      case MK_NONE:
        return launch_wgmma<D, MK_NONE>(q, k, v, o, lse, mask, bh, sq, sk,
                                        causal, scale, stream);
      case MK_ROW:
        return launch_wgmma<D, MK_ROW>(q, k, v, o, lse, mask, bh, sq, sk,
                                       causal, scale, stream);
      default:
        return launch_wgmma<D, MK_ANY>(q, k, v, o, lse, mask, bh, sq, sk,
                                       causal, scale, stream);
    }
  }
  return masked ? launch_fma<D, true>(q, k, v, o, lse, mask, bh, sq, sk,
                                      causal, scale, stream)
                : launch_fma<D, false>(q, k, v, o, lse, mask, bh, sq, sk,
                                       causal, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  q, k, v, o and, for bf16, the bias
// and segment ids must be 16-byte aligned.  bias, qseg, kseg: the masks
// (null when absent), as pt::AttnMask describes them; bias_bf16, bb, hb,
// sqb and heads describe the bias and the folded axis.  Returns a
// cudaError_t as int.
extern "C" int pt_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const int* qseg, const int* kseg,
                                      void* o, float* lse, int bh, int sq,
                                      int sk, int d, int dtype, int causal,
                                      int bias_bf16, int bb, int hb, int sqb,
                                      int heads, float scale, void* stream) {
  const pt::AttnMask mask =
      pt::make_mask(bias, qseg, kseg, bias_bf16, bb, hb, sqb, heads);
  const int chunk = pt::slice_chunk(mask);
  if (bh <= 0 || sq <= 0 || sk <= 0 || (dtype != 0 && dtype != 1) ||
      (d != 64 && d != 128) || chunk <= 0 ||
      pt::bad_mask(mask, bh, sq, sk, WQ) || pt::misaligned(q) ||
      pt::misaligned(k) || pt::misaligned(v) || pt::misaligned(o))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // the persistent kernel walks any B*H in one launch
    if (pt::misaligned(bias) || pt::misaligned(qseg) || pt::misaligned(kseg))
      return (int)cudaErrorInvalidValue;
    return d == 64 ? launch_d<64>(true, q, k, v, o, lse, mask, bh, sq, sk,
                                  causal, scale, s)
                   : launch_d<128>(true, q, k, v, o, lse, mask, bh, sq, sk,
                                   causal, scale, s);
  }
  // f32: B*H past grid y runs in chunks
  return pt::for_each_chunk(mask, bh, chunk, 1, sq, sk,
                            [&](int bh0, int n, const pt::AttnMask& m) {
    const size_t qo = (size_t)bh0 * sq * d, ko = (size_t)bh0 * sk * d;
    const void *qc = pt::advance(q, qo, 4), *kc = pt::advance(k, ko, 4),
               *vc = pt::advance(v, ko, 4);
    void* oc = pt::advance(o, qo, 4);
    float* lc = lse + (size_t)bh0 * sq;
    return d == 64 ? launch_d<64>(false, qc, kc, vc, oc, lc, m, n, sq, sk,
                                  causal, scale, s)
                   : launch_d<128>(false, qc, kc, vc, oc, lc, m, n, sq, sk,
                                   causal, scale, s);
  });
}
