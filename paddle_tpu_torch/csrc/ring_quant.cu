// Per-row symmetric quantizer of the collectives' wire (int8, packed int4)
// for Hopper (sm_90a), bound through a plain C interface (ctypes).
//
// Replaces: paddle_tpu/ops/pallas/ring_quant.py `_rowquant_kernel` (:51),
// called at :75 from `ring_quant_rows` (:90).  For each row of an (R, D) f32
// input:
//    scale = max|row| / qmax   (127 for int8, 7 for int4; not > 0 -> 1)
//    q     = clip(rint(x / scale), -qmax, qmax)
// bitwise the codec of distributed/wire.py: IEEE division for the scale and
// for x / scale (__fdiv_rn, no reciprocal, no fast math), rintf (ties to
// even), then the clip.  A NaN in a row makes its max NaN, as jnp.max and
// torch.amax do, and so its scale 1 through the `> 0` test; fmaxf drops
// NaN, so the kernel tracks it on the side.  int4 packs two values a byte,
// low nibble first, two's complement, a zero pad nibble for an odd D: the
// pack the reference leaves to a jnp epilogue is fused into the store.
// Outputs: q int8 (R, D) or uint8 (R, ceil(D/2)), scale f32 (R,).
//
// Design.  One warp a row, eight rows a 256-thread block.  Where D is a
// multiple of 4, the row 16-byte aligned and D <= 1024, each lane loads its
// share of the row as float4 into registers once, the warp reduces the max
// by shuffles and encodes from the same registers: the row is read once,
// and each float4 becomes one 4-byte (int8) or 2-byte (int4) store.  Any
// other D (the ZeRO tests' chunks of 13, a one-column row) takes a scalar
// two-pass body, whose second read of the row hits the cache.
//
// What bounds it.  Bytes: 4 B read a value, 1 B (int8) or 0.5 B (int4)
// written a value and 4 B a row.  GPT-2 345M's gradient in 256-wide rows
// (354,871,296 values, 1,386,216 rows) moves 1.78 GB (int8) or 1.60 GB
// (int4): 0.53 and 0.48 ms at 3.35 TB/s.  Five operations a value.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = THREADS / 32;      // rows a block
constexpr int MAX_V = 8;                // float4 a lane held in registers

// max over the warp of each lane's |x| max; NaN if any lane saw a NaN
__device__ __forceinline__ float warp_absmax(float m, bool nan) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  return __any_sync(0xffffffffu, nan) ? CUDART_NAN_F : m;
}

__device__ __forceinline__ void absmax(float x, float& m, bool& nan) {
  const float a = fabsf(x);
  nan |= isnan(a);
  m = fmaxf(m, a);
}

__device__ __forceinline__ float row_scale(float amax, float qmax) {
  const float s = __fdiv_rn(amax, qmax);
  return s > 0.f ? s : 1.f;            // NaN > 0 is false
}

__device__ __forceinline__ int encode(float x, float scale, float qmax) {
  return (int)fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -qmax), qmax);
}

// one byte of two int4 values: lo in the low nibble
__device__ __forceinline__ uint32_t nibbles(int lo, int hi) {
  return ((uint32_t)lo & 0xFu) | (((uint32_t)hi & 0xFu) << 4);
}

template <int V, bool INT4>
__global__ void __launch_bounds__(THREADS)
    rowquant_reg_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                        float* __restrict__ scale, long long rows, int d,
                        float qmax) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;             // the whole warp leaves together
  const int n4 = d >> 2;
  const float4* xr = reinterpret_cast<const float4*>(x + row * d);
  float4 v[V];
  float m = 0.f;
  bool nan = false;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < n4 ? xr[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    absmax(v[i].x, m, nan);
    absmax(v[i].y, m, nan);
    absmax(v[i].z, m, nan);
    absmax(v[i].w, m, nan);
  }
  const float s = row_scale(warp_absmax(m, nan), qmax);
  if (lane == 0) scale[row] = s;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane + 32 * i;
    if (c >= n4) break;
    const int a = encode(v[i].x, s, qmax), b = encode(v[i].y, s, qmax);
    const int e = encode(v[i].z, s, qmax), f = encode(v[i].w, s, qmax);
    if (INT4) {
      reinterpret_cast<uint16_t*>(q + row * (d >> 1))[c] =
          (uint16_t)(nibbles(a, b) | (nibbles(e, f) << 8));
    } else {
      reinterpret_cast<uint32_t*>(q + row * d)[c] =
          ((uint32_t)a & 0xFFu) | (((uint32_t)b & 0xFFu) << 8) |
          (((uint32_t)e & 0xFFu) << 16) | (((uint32_t)f & 0xFFu) << 24);
    }
  }
}

template <bool INT4>
__global__ void __launch_bounds__(THREADS)
    rowquant_any_kernel(const float* __restrict__ x, uint8_t* __restrict__ q,
                        float* __restrict__ scale, long long rows, int d,
                        float qmax) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const float* xr = x + row * d;
  float m = 0.f;
  bool nan = false;
  for (int c = lane; c < d; c += 32) absmax(xr[c], m, nan);
  const float s = row_scale(warp_absmax(m, nan), qmax);
  if (lane == 0) scale[row] = s;
  if (INT4) {
    const int nb = (d + 1) >> 1;
    uint8_t* qr = q + row * nb;
    for (int b = lane; b < nb; b += 32) {
      const int lo = encode(xr[2 * b], s, qmax);
      const int hi = 2 * b + 1 < d ? encode(xr[2 * b + 1], s, qmax) : 0;
      qr[b] = (uint8_t)nibbles(lo, hi);
    }
  } else {
    uint8_t* qr = q + row * d;
    for (int c = lane; c < d; c += 32)
      qr[c] = (uint8_t)((uint32_t)encode(xr[c], s, qmax) & 0xFFu);
  }
}

template <bool INT4>
cudaError_t launch(const float* x, void* q, float* scale, long long rows,
                   int d, cudaStream_t stream) {
  const float qmax = INT4 ? 7.f : 127.f;
  const unsigned blocks = (unsigned)((rows + ROWS - 1) / ROWS);
  uint8_t* qo = static_cast<uint8_t*>(q);
  const int n4 = d >> 2;
  const bool vec = d % 4 == 0 && n4 <= 32 * MAX_V &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (!vec)
    rowquant_any_kernel<INT4><<<blocks, THREADS, 0, stream>>>(x, qo, scale,
                                                              rows, d, qmax);
  else if (n4 <= 32)
    rowquant_reg_kernel<1, INT4><<<blocks, THREADS, 0, stream>>>(
        x, qo, scale, rows, d, qmax);
  else if (n4 <= 64)
    rowquant_reg_kernel<2, INT4><<<blocks, THREADS, 0, stream>>>(
        x, qo, scale, rows, d, qmax);
  else if (n4 <= 128)
    rowquant_reg_kernel<4, INT4><<<blocks, THREADS, 0, stream>>>(
        x, qo, scale, rows, d, qmax);
  else
    rowquant_reg_kernel<8, INT4><<<blocks, THREADS, 0, stream>>>(
        x, qo, scale, rows, d, qmax);
  return cudaGetLastError();
}

}  // namespace

// x: (rows, d) f32, contiguous.  int4 = 0: q int8 (rows, d); int4 = 1: q
// uint8 (rows, ceil(d / 2)), packed.  scale: (rows,) f32.  Returns a
// cudaError_t as int.
extern "C" int pt_ring_quant_rows(const float* x, void* q, float* scale,
                                  long long rows, int d, int int4,
                                  void* stream) {
  if (rows < 0 || d <= 0 || (int4 != 0 && int4 != 1) ||
      (rows + ROWS - 1) / ROWS > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(int4 ? launch<true>(x, q, scale, rows, d, s)
                    : launch<false>(x, q, scale, rows, d, s));
}
