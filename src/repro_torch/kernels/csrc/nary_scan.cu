// K5: the horizontal (N-ary) distance scan, the paper's baseline layout.
//
// Replaces the TPU kernel src/repro/kernels/nary_scan.py:nary_distance_pallas
// (body _nary_kernel).  Plain version:
// repro_torch/kernels/ref.py:nary_distance_ref.  X (N, D) f32 | bf16,
// row-major, q (D,) f32 -> (N,) f32: sum_d (x - q)^2 (l2), sum_d |x - q|
// (l1) or -sum_d x*q (ip), accumulated in f32.
//
// Bound on an H100: bytes (one read of X, 1-3 flops a value), the same
// bytes as K4 on the transposed collection, so the two differ only in how
// the layout lets the threads use them.  A row's values lie next to each
// other, so its sum is a horizontal reduction across the threads that read
// it: the cost the paper charges the N-ary layout with.  To keep the
// baseline fair, the design spends nothing it need not:
//   * a group of G threads owns a row, G the least power of two (at most
//     a warp) that leaves each thread at most 4 of the row's 16-byte
//     vectors (4 f32 or 8 bf16 values): one warp packs 32 / G rows, so no
//     lane idles at low D (D = 8 f32: a thread a row, its sum kept in
//     registers; D = 64: 8 rows of 4 threads), a wide row gets the whole
//     warp, and every thread keeps up to 4 loads in flight (with one
//     vector a thread, D = 64-192 ran at 65-72 % of the H100's byte bound);
//   * each thread reads its vectors with 16-byte loads, group-neighbours on
//     neighbouring addresses, so each load of a group covers G whole
//     vectors of its row (whole 32-byte sectors); a row whose length is
//     not a multiple of 16 bytes falls back to scalar loads, G sized to
//     the row's values the same way;
//   * the group reduces its partial sums with log2(G) warp shuffles
//     (__shfl_xor_sync), no shared memory, and its first thread writes the
//     row's distance;
//   * q sits in shared memory, read as float4 at the thread's offsets.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "metric.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// One 16-byte vector of a row (kElems values) as floats.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kElems = 4;
  __device__ __forceinline__ static void load(const float* p, float v[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float v[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
      v[2 * i] = __bfloat162float(b.x);
      v[2 * i + 1] = __bfloat162float(b.y);
    }
  }
};

// kVec: D is a multiple of the vector width, so every row starts 16-byte
// aligned and is read in whole vectors; otherwise value by value.
template <typename T, int kMetric, bool kVec>
__global__ void __launch_bounds__(kThreads)
nary_distance_kernel(const T* __restrict__ x, const float* __restrict__ q,
                     float* __restrict__ out, int N, int D, int G) {
  extern __shared__ __align__(16) float sq[];
  for (int i = threadIdx.x; i < D; i += blockDim.x) sq[i] = q[i];
  __syncthreads();
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t row = t / G;
  const int g = (int)(t % G);
  float acc = 0.f;
  if (row < N) {
    const T* xr = x + row * D;
    if constexpr (kVec) {
      constexpr int kE = Vec<T>::kElems;
      const int n_vec = D / kE;
#pragma unroll 4
      for (int c = g; c < n_vec; c += G) {
        float v[kE];
        Vec<T>::load(xr + c * kE, v);
#pragma unroll
        for (int i = 0; i < kE; i += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(sq + c * kE + i);
          acc += term<kMetric>(v[i], qv.x);
          acc += term<kMetric>(v[i + 1], qv.y);
          acc += term<kMetric>(v[i + 2], qv.z);
          acc += term<kMetric>(v[i + 3], qv.w);
        }
      }
    } else {
#pragma unroll 4
      for (int e = g; e < D; e += G) acc += term<kMetric>(to_float(xr[e]), sq[e]);
    }
  }
  // every lane of the warp takes part in the shuffles (G divides 32, and a
  // block is whole warps), rows past N with a zero sum
  for (int off = G >> 1; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row < N && g == 0) out[row] = kMetric == kIP ? -acc : acc;
}

constexpr int kItemsPerThread = 4;  // vectors (or scalar values) a thread reads

// The least power of two g <= 32 with g * kItemsPerThread >= items.
int group_size(int items) {
  int g = 1;
  while (g < 32 && g * kItemsPerThread < items) g <<= 1;
  return g;
}

template <typename T, int kMetric>
cudaError_t launch(const void* x, const float* q, float* out, int N, int D,
                   cudaStream_t stream) {
  constexpr int kE = Vec<T>::kElems;
  const bool vec = D % kE == 0;
  const int G = group_size(vec ? D / kE : D);
  const size_t smem = (size_t)D * sizeof(float);
  auto kernel = vec ? nary_distance_kernel<T, kMetric, true>
                    : nary_distance_kernel<T, kMetric, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t threads = (int64_t)N * G;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(static_cast<const T*>(x), q, out, N, D,
                                                       G);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* q, float* out, int N, int D, int metric,
                     cudaStream_t s) {
  switch (metric) {
    case kL2: return launch<T, kL2>(x, q, out, N, D, s);
    case kIP: return launch<T, kIP>(x, q, out, N, D, s);
    case kL1: return launch<T, kL1>(x, q, out, N, D, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K5.  dtype: 0 f32, 1 bf16; metric: 0 l2, 1 ip (negated), 2 l1.  Returns a
// cudaError_t.
extern "C" int nary_distance(const void* x, int dtype, const float* q, float* out, int N, int D,
                             int metric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(x, q, out, N, D, metric, s);
    case 1: return dispatch<__nv_bfloat16>(x, q, out, N, D, metric, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* nary_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
