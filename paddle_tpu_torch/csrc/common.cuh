// Device helpers shared by the port's kernels: dtype conversion, warp
// reductions, the base-2 exponential, bf16 packing, and the attention
// masks (the mask of a folded slice, the chunks of a launch past grid y,
// the bf16 flash kernels' mask kinds and tile masking).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace pt {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// reductions over the lanes whose index differs only in the low bits
template <int WIDTH>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
template <int WIDTH>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> one register of two bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The optional masks of the attention kernels (reference
// flash_attention.py `_mask_tile` :176 and `_bias_g_map` :165): an additive
// bias in its canonical (Bb, Hb, Sqb, Sk) shape, folded to (Bb*Hb, Sqb, Sk),
// f32 or bf16; int32 segment ids (B, Sq) and (B, Sk).  A null pointer is an
// absent mask.  Masked calls take no sequence tails (the wrapper checks).
struct AttnMask {
  const void* bias;
  const int* qseg;
  const int* kseg;
  int bias_bf16;     // 1: the bias is bf16, 0: f32
  int bb, hb, sqb;   // the bias's broadcast extents
  int heads;         // H of the folded (B*H) axis
};

// the bias slice a folded (b, h) index reads (reference `_bias_g_map`)
__device__ __forceinline__ int bias_slice(const AttnMask& m, int bh) {
  if (m.bb == 1 && m.hb == 1) return 0;
  if (m.bb == 1) return bh % m.heads;
  if (m.hb == 1) return bh / m.heads;
  return bh;
}

// the mask of one folded (b, h) slice
struct SliceMask {
  const float* bf;   // f32 bias rows, or null
  const bf16* b16;   // bf16 bias rows, or null
  int ld;            // elements between bias rows: sk, or 0 when Sqb = 1
  const int* qs;     // segment ids of the slice's batch, or null
  const int* ks;

  // x = s * scale * unit -> (s * scale + bias) * unit, then -inf where the
  // segment ids differ: the reference's order.  unit is log2(e) for the
  // kernels that exponentiate in base 2, 1 for the others.  A finite bias
  // (BERT's -1e30) stays finite.
  __device__ __forceinline__ float apply(float x, int q, int k,
                                         float unit) const {
    const size_t i = (size_t)q * ld + k;
    if (bf) x += bf[i] * unit;
    else if (b16) x += __bfloat162float(b16[i]) * unit;
    if (qs && qs[q] != ks[k]) x = -CUDART_INF_F;
    return x;
  }
};

__device__ __forceinline__ SliceMask slice_mask(const AttnMask& m, int bh,
                                                int sq, int sk) {
  SliceMask s{nullptr, nullptr, 0, nullptr, nullptr};
  if (m.bias) {
    const size_t off = (size_t)bias_slice(m, bh) * m.sqb * sk;
    if (m.bias_bf16)
      s.b16 = static_cast<const bf16*>(m.bias) + off;
    else
      s.bf = static_cast<const float*>(m.bias) + off;
    s.ld = m.sqb > 1 ? sk : 0;
  }
  if (m.qseg) {
    const int b = bh / m.heads;
    s.qs = m.qseg + (size_t)b * sq;
    s.ks = m.kseg + (size_t)b * sk;
  }
  return s;
}

// the host's view: a mask from the C interface's arguments, and whether a
// call is masked (then both sequence lengths must be multiples of `tile`)
inline AttnMask make_mask(const void* bias, const int* qseg, const int* kseg,
                          int bias_bf16, int bb, int hb, int sqb, int heads) {
  return AttnMask{bias, qseg, kseg, bias_bf16, bb, hb, sqb, heads};
}

// Grid y holds the folded B*H axis, at most MAX_GRID_Y slices a launch.  A
// call with more runs as several launches, each over a chunk of whole batch
// entries (a multiple of `heads` slices, so the mask indices the kernels
// derive from a slice stay right); the chunk's tensors start at its first
// slice and its mask at that slice's batch entry (mask_at).  0: no chunk
// fits (more than MAX_GRID_Y heads).
constexpr int MAX_GRID_Y = 65535;

inline int slice_chunk(const AttnMask& m) {
  const int heads = m.heads > 0 ? m.heads : 1;
  return MAX_GRID_Y / heads * heads;
}

// the mask of the chunk that starts at folded slice bh0, a multiple of heads
inline AttnMask mask_at(const AttnMask& m, int bh0, int sq, int sk) {
  AttnMask c = m;
  if (bh0 == 0) return c;
  const size_t b0 = (size_t)(bh0 / m.heads);
  if (m.bias) {
    const size_t first = (m.bb != 1 && m.hb != 1) ? (size_t)bh0
                         : m.bb != 1                ? b0
                                                    : 0;
    const size_t off = first * m.sqb * sk;
    c.bias = m.bias_bf16
                 ? static_cast<const void*>(static_cast<const bf16*>(m.bias) +
                                            off)
                 : static_cast<const void*>(
                       static_cast<const float*>(m.bias) + off);
  }
  if (m.qseg) {
    c.qseg = m.qseg + b0 * sq;
    c.kseg = m.kseg + b0 * sk;
  }
  return c;
}

// Calls fn(i0, n, m) for the chunks [i0, i0 + n) of [0, total), n at most
// `chunk`: unit i0 starts at folded slice i0 * stride, m is the mask of that
// slice's chunk (mask_at).  fn launches the chunk and returns its
// cudaError_t; the first error stops the loop and is returned.
template <class Fn>
inline int for_each_chunk(const AttnMask& mask, int total, int chunk,
                          int stride, int sq, int sk, Fn fn) {
  for (int i0 = 0; i0 < total; i0 += chunk) {
    const int n = total - i0 < chunk ? total - i0 : chunk;
    const cudaError_t err = fn(i0, n, mask_at(mask, i0 * stride, sq, sk));
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// p advanced by n elements of `bytes` bytes each
inline const void* advance(const void* p, size_t n, size_t bytes) {
  return static_cast<const char*>(p) + n * bytes;
}
inline void* advance(void* p, size_t n, size_t bytes) {
  return static_cast<char*>(p) + n * bytes;
}

inline bool bad_mask(const AttnMask& m, int bh, int sq, int sk, int tile) {
  if (!m.bias && !m.qseg) return false;
  if (sq % tile || sk % tile || m.heads <= 0 || bh % m.heads) return true;
  if ((m.qseg == nullptr) != (m.kseg == nullptr)) return true;
  if (m.bias) {
    const int b = bh / m.heads;
    if ((m.bb != 1 && m.bb != b) || (m.hb != 1 && m.hb != m.heads) ||
        (m.sqb != 1 && m.sqb != sq) || (m.bias_bf16 != 0 && m.bias_bf16 != 1))
      return true;
  }
  return false;
}

// the key tiles of TK keys that the query tile [q0, q0 + TQ) needs (off =
// sk - sq): under the end-aligned causal mask tile kb is needed iff kb TK
// < q0 + TQ + off
template <int TQ, int TK>
__device__ __forceinline__ int kv_tiles(int q0, int sk, int off,
                                        int causal) {
  int n_kb = (sk + TK - 1) / TK;
  if (causal) {
    const int lim = q0 + TQ + off;
    const int need = lim <= 0 ? 0 : (lim + TK - 1) / TK;
    n_kb = need < n_kb ? need : n_kb;
  }
  return n_kb;
}

// the first query tile of qt rows that sees a key of the tile starting at
// k0 under the end-aligned causal mask (off = sk - sq): tile i is needed
// iff k0 < (i + 1) qt + off
__device__ __forceinline__ int first_q_tile(int k0, int off, int causal,
                                            int qt) {
  if (!causal) return 0;
  const int lim = k0 - off - qt + 1;
  return lim <= 0 ? 0 : (lim + qt - 1) / qt;
}

inline bool misaligned(const void* p) {
  return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) != 0;
}

// The bf16 flash kernels' view of a mask: the bias by kind, and their
// instantiations: no mask; one f32 bias row a slice and no segment ids
// (BERT's padding bias, a bool padding mask); any other mask, read by kind
// at run time.
enum BiasKind { NO_BIAS, ROW_F32, ROW_BF16, FULL_F32, FULL_BF16 };
enum MaskKind { MK_NONE, MK_ROW, MK_ANY };

inline int bias_kind(const AttnMask& m) {
  if (!m.bias) return NO_BIAS;
  return m.sqb == 1 ? (m.bias_bf16 ? ROW_BF16 : ROW_F32)
                    : (m.bias_bf16 ? FULL_BF16 : FULL_F32);
}

inline int mask_kind(const AttnMask& m) {
  if (!m.bias && !m.qseg) return MK_NONE;
  if (m.bias && !m.qseg && m.sqb == 1 && !m.bias_bf16) return MK_ROW;
  return MK_ANY;
}

// A 128-key tile's mask as the producer stages it beside the keys (bulk
// copies): a one-row bias's 128 values at 0, the key segment ids at
// KSEG_AT.
constexpr int MASK_BYTES = 1024;
constexpr int KSEG_AT = 512;

// The scores of a 128-key tile in a thread's fragment of a 64 x 128 wgmma
// accumulator (s[4 jn + 2 hi + lo] at the thread's row hi and key k0 +
// 8 jn + 2 tl + lo) in base-2 units with the mask applied: s * scale2 +
// bias * log2(e), then -inf where the segment ids differ.  mt: the tile's
// staged mask; qseg: the query segment ids of the thread's two rows;
// bf_rows / bh_rows: a full bias's two rows (f32 / bf16).  MK_NONE leaves
// s in its own units.
template <int MK>
__device__ __forceinline__ void mask_tile(
    float (&s)[64], const unsigned char* mt, const AttnMask& m, int kind,
    float scale2, int k0, int tl, const int (&qseg)[2],
    const float* const (&bf_rows)[2], const bf16* const (&bh_rows)[2]) {
  constexpr float log2e = 1.4426950408889634f;
  if constexpr (MK == MK_ROW) {
    // one FFMA a score
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const float2 b2 =
          *reinterpret_cast<const float2*>(mt + (8 * jn + 2 * tl) * 4);
      const float b0 = b2.x * log2e, b1 = b2.y * log2e;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * jn + e] = fmaf(s[4 * jn + e], scale2, e & 1 ? b1 : b0);
    }
  } else if constexpr (MK == MK_ANY) {
#pragma unroll
    for (int jn = 0; jn < 16; ++jn) {
      const int kl = 8 * jn + 2 * tl;          // the pair's first key
      float bias[2] = {0.f, 0.f};
      int kseg[2] = {0, 0};
      if (kind == ROW_F32) {
        const float2 v2 = *reinterpret_cast<const float2*>(mt + kl * 4);
        bias[0] = v2.x * log2e;
        bias[1] = v2.y * log2e;
      } else if (kind == ROW_BF16) {
        const __nv_bfloat162 v2 =
            *reinterpret_cast<const __nv_bfloat162*>(mt + kl * 2);
        bias[0] = __low2float(v2) * log2e;
        bias[1] = __high2float(v2) * log2e;
      }
      if (m.qseg) {
        const int2 k2 = *reinterpret_cast<const int2*>(mt + KSEG_AT + kl * 4);
        kseg[0] = k2.x;
        kseg[1] = k2.y;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hi = e >> 1, lo = e & 1;
        const int key = k0 + kl + lo;
        float x = s[4 * jn + e] * scale2;
        if (kind == FULL_F32)
          x += bf_rows[hi][key] * log2e;
        else if (kind == FULL_BF16)
          x += __bfloat162float(bh_rows[hi][key]) * log2e;
        else
          x += bias[lo];
        if (m.qseg && qseg[hi] != kseg[lo]) x = -CUDART_INF_F;
        s[4 * jn + e] = x;
      }
    }
  }
}

}  // namespace pt
