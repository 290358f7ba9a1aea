// Fused Adam / AdamW update of many tensors per launch (a multi-tensor
// apply) for Hopper (sm_90a), bound through a plain C interface (ctypes),
// in two instantiations of one kernel over the storage type: f32
// (`pt_fused_adam`) and bf16 (`pt_fused_adam_bf16`).
//
// Replaces: paddle_tpu/ops/pallas/fused_adam.py `_adam_kernel` (:47),
// called through `fused_adam_update` (:63) once per tensor, which widens
// p, g, m and v to f32, computes, and stores p', m', v' back in p's, m's
// and v's dtypes (:83-116).  Same function, element by element, in f32:
//    m' = b1 m + (1 - b1) g
//    v' = b2 v + (1 - b2) g g
//    p' = p - lr_t m' / (sqrt(v') + eps) - wd_lr p
// with IEEE division and square root (no fast math), and every product and
// sum rounded on its own (no fused multiply-add) in the order of the plain
// version (`fused_adam_reference`), so the two agree to the last bit; the
// bf16 instantiation rounds p', m', v' to nearest even on the store, from
// the unrounded f32 values.  lr_t (one per tensor, from its beta pows) and
// wd_lr are read from device memory, as the reference passes them as data
// (:89-98): a new rate never goes through the host, and nothing
// synchronises.
//
// Design.  The Pallas kernel runs once per tensor over a (rows, 128) view.
// Here one launch updates up to 32 tensors: the table of their pointers and
// sizes is the kernel's argument (read from the constant bank, no copy to
// the device), each tensor is cut into chunks of 2048 elements, and the
// blocks walk the chunks of all tensors in a grid-stride loop, with 16-byte
// loads and stores (4 f32 or 8 bf16 values); the wrapper requires every
// tensor to start on a 16-byte boundary, so a chunk is whole vectors but
// for a scalar tail where the tensor's length is no multiple of the
// vector.  The outputs may alias the inputs: each element is read before
// it is written, by one thread.
//
// What bounds it.  Bytes: an element reads p, g, m, v and writes p, m, v,
// 28 bytes in f32 and 14 in bf16, for 11 operations.  At GPT-2 345M's
// 354,871,296 parameters that is 9.94 GB, 2.97 ms at 3.35 TB/s, in f32 and
// 4.97 GB, 1.48 ms in bf16.
#include "common.cuh"

namespace {

constexpr int MAXT = 32;        // tensors per launch
constexpr int CHUNK = 2048;     // elements per block step
constexpr int THREADS = 256;

template <typename T>
struct Table {
  const T* p[MAXT];
  const T* g[MAXT];
  const T* m[MAXT];
  const T* v[MAXT];
  T* po[MAXT];
  T* mo[MAXT];
  T* vo[MAXT];
  long long numel[MAXT];
  long long chunk0[MAXT + 1];   // first chunk of each tensor; [n] = total
  int n;
};

struct Consts {
  float b1, c1, b2, c2, eps;    // c1 = 1 - b1, c2 = 1 - b2 (from the host)
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v,
                                      float lr_t, float wd_lr,
                                      const Consts& k) {
  m = __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.c1, g));
  v = __fadd_rn(__fmul_rn(k.b2, v), __fmul_rn(__fmul_rn(k.c2, g), g));
  const float step =
      __fdiv_rn(__fmul_rn(lr_t, m), __fadd_rn(__fsqrt_rn(v), k.eps));
  p = __fadd_rn(__fadd_rn(p, -step), -__fmul_rn(wd_lr, p));
}

template <typename T>
__device__ __forceinline__ void adam_one(const Table<T>& tab, int i,
                                         long long e, float lr, float wd,
                                         const Consts& k) {
  float p = widen(tab.p[i][e]), m = widen(tab.m[i][e]);
  float v = widen(tab.v[i][e]);
  adam1(p, widen(tab.g[i][e]), m, v, lr, wd, k);
  tab.po[i][e] = narrow<T>(p);
  tab.mo[i][e] = narrow<T>(m);
  tab.vo[i][e] = narrow<T>(v);
}

// 16 bytes of each of p, g, m, v at element e (16-byte aligned)
template <typename T>
__device__ __forceinline__ void adam_vec(const Table<T>& tab, int i,
                                         long long e, float lr, float wd,
                                         const Consts& k) {
  constexpr int N = 16 / sizeof(T);
  uint4 pu = *reinterpret_cast<const uint4*>(tab.p[i] + e);
  const uint4 gu = *reinterpret_cast<const uint4*>(tab.g[i] + e);
  uint4 mu = *reinterpret_cast<const uint4*>(tab.m[i] + e);
  uint4 vu = *reinterpret_cast<const uint4*>(tab.v[i] + e);
  T* pt = reinterpret_cast<T*>(&pu);
  const T* gt = reinterpret_cast<const T*>(&gu);
  T* mt = reinterpret_cast<T*>(&mu);
  T* vt = reinterpret_cast<T*>(&vu);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float p = widen(pt[j]), m = widen(mt[j]), v = widen(vt[j]);
    adam1(p, widen(gt[j]), m, v, lr, wd, k);
    pt[j] = narrow<T>(p);
    mt[j] = narrow<T>(m);
    vt[j] = narrow<T>(v);
  }
  *reinterpret_cast<uint4*>(tab.po[i] + e) = pu;
  *reinterpret_cast<uint4*>(tab.mo[i] + e) = mu;
  *reinterpret_cast<uint4*>(tab.vo[i] + e) = vu;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adam_kernel(const __grid_constant__ Table<T> tab,
                const float* __restrict__ lr_t,
                const float* __restrict__ wd_lr, const Consts k) {
  constexpr int N = 16 / sizeof(T);
  const float wd = *wd_lr;
  const long long total = tab.chunk0[tab.n];
  int i = 0;
  for (long long c = blockIdx.x; c < total; c += gridDim.x) {
    while (c >= tab.chunk0[i + 1]) ++i;
    const long long n = tab.numel[i];
    const long long e0 = (c - tab.chunk0[i]) * CHUNK;
    const long long e1 = e0 + CHUNK < n ? e0 + CHUNK : n;
    const float lr = lr_t[i];
    // [e0, b) whole vectors, [b, e1) scalar tail
    const long long b = e0 + (e1 - e0) / N * N;
    for (long long e = e0 + (long long)threadIdx.x * N; e < b;
         e += (long long)THREADS * N)
      adam_vec(tab, i, e, lr, wd, k);
    for (long long e = b + threadIdx.x; e < e1; e += THREADS)
      adam_one(tab, i, e, lr, wd, k);
  }
}

template <typename T>
int launch(int n, const void* const* p, const void* const* g,
           const void* const* m, const void* const* v, void* const* po,
           void* const* mo, void* const* vo, const long long* numel,
           const float* lr_t, const float* wd_lr, float b1, float c1,
           float b2, float c2, float eps, void* stream) {
  if (n <= 0 || n > MAXT) return (int)cudaErrorInvalidValue;
  Table<T> tab;
  tab.n = n;
  tab.chunk0[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (numel[i] < 0) return (int)cudaErrorInvalidValue;
    tab.p[i] = static_cast<const T*>(p[i]);
    tab.g[i] = static_cast<const T*>(g[i]);
    tab.m[i] = static_cast<const T*>(m[i]);
    tab.v[i] = static_cast<const T*>(v[i]);
    tab.po[i] = static_cast<T*>(po[i]);
    tab.mo[i] = static_cast<T*>(mo[i]);
    tab.vo[i] = static_cast<T*>(vo[i]);
    tab.numel[i] = numel[i];
    tab.chunk0[i + 1] = tab.chunk0[i] + (numel[i] + CHUNK - 1) / CHUNK;
    const void* const all[7] = {p[i], g[i], m[i], v[i], po[i], mo[i], vo[i]};
    for (int j = 0; j < 7; ++j)
      if (reinterpret_cast<uintptr_t>(all[j]) % 16)
        return (int)cudaErrorMisalignedAddress;
  }
  const long long total = tab.chunk0[n];
  if (total == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // a few resident 256-thread blocks on each SM walk all chunks
  const long long blocks = total < 8LL * sms ? total : 8LL * sms;
  const Consts k{b1, c1, b2, c2, eps};
  adam_kernel<T><<<(unsigned)blocks, THREADS, 0,
                   static_cast<cudaStream_t>(stream)>>>(tab, lr_t, wd_lr, k);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over n <= 32 tensors of one storage type: p, g, m, v and the
// outputs po, mo, vo are arrays of n device pointers (an output may equal
// its input; every pointer 16-byte aligned), numel their sizes; lr_t points to n f32
// rates on the device and wd_lr to one.  c1 = 1 - b1 and c2 = 1 - b2 as
// the caller rounds them.  Returns a cudaError_t as int.
extern "C" int pt_fused_adam(int n, const void* const* p,
                             const void* const* g, const void* const* m,
                             const void* const* v, void* const* po,
                             void* const* mo, void* const* vo,
                             const long long* numel, const float* lr_t,
                             const float* wd_lr, float b1, float c1,
                             float b2, float c2, float eps, void* stream) {
  return launch<float>(n, p, g, m, v, po, mo, vo, numel, lr_t, wd_lr, b1, c1,
                       b2, c2, eps, stream);
}

extern "C" int pt_fused_adam_bf16(int n, const void* const* p,
                                  const void* const* g, const void* const* m,
                                  const void* const* v, void* const* po,
                                  void* const* mo, void* const* vo,
                                  const long long* numel, const float* lr_t,
                                  const float* wd_lr, float b1, float c1,
                                  float b2, float c2, float eps,
                                  void* stream) {
  return launch<__nv_bfloat16>(n, p, g, m, v, po, mo, vo, numel, lr_t, wd_lr,
                               b1, c1, b2, c2, eps, stream);
}
