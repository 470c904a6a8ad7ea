// K2: batched query-vs-tile distances with in-register dequantization.
//
// Replaces the TPU kernel src/repro/kernels/batched_matmul.py:
// batched_distance_quant_pallas (body _bmm_quant_kernel).  Contract
// (plain version: repro_torch/kernels/ref.py:batched_distance_quant_ref):
//   T (P, D, V) f32 | bf16 | int8 mirror tiles (int4 arrives unpacked to
//   int8 levels), Q (B, D) f32, qn (B,) f32 = ||q||^2 computed outside,
//   scale/offset (D,) f32.  Out (B, P*V) f32, column p*V + v:
//       l2: ||q||^2 - 2 q.x^ + ||x^||^2     ip: -q.x^
//   with x^ = x*scale + offset (int8) or x upcast (f32/bf16).  The tile
//   norm ||x^||^2 is accumulated beside the product, so no f32 norm array
//   over the store exists anywhere; every stored byte is read once.
//
// What bounds it on an H100: at B = 64 over a 1M x 960 store the product
// is ~123 GFLOP against 1.5-5.9 GB of tiles, so in full f32 on the SIMT
// cores (67 TFLOP/s) operations bound it; only tensor cores would make it
// memory-bound.  This first version stays on the SIMT cores in full f32
// (no TF32: the cancelling l2 form flips near-tie ids under TF32) and is
// a plain tiled GEMM:
//   * one block per 64 queries x 64 lanes x partition (grid.z = P, so one
//     launch covers the whole stacked store);
//   * K steps of 32 dims stage Q (transposed) and the dequantized tile in
//     shared memory; each of 256 threads owns a 4 x 4 output micro-tile
//     read as float4 rows from shared memory, and the 4 column norms;
//   * tile loads are coalesced along V, which is the PDX tile's
//     contiguous axis, so no relayout is needed.
// Tensor cores (wgmma) with a precision-safe split and TMA pipelining are
// the work of a later change.
//
// K7: the plain batch distance product over one f32 or bf16 PDX tile, the
// template instance kNorms = true of the same kernel.
//
// Replaces the TPU kernel src/repro/kernels/batched_matmul.py:
// batched_distance_pallas (body _bmm_kernel).  Plain version:
// repro_torch/kernels/ref.py:batched_distance_ref.  T (D, V) f32 | bf16,
// Q (B, D) f32 | bf16, qn (B,) = ||q||^2 and xn (V,) = ||x||^2 computed
// outside the kernel (as the TPU kernel's wrapper computes them outside
// pallas_call), out (B, V) f32: qn - 2 q.x + xn (l2) or -q.x (ip).  Both
// operands upcast to f32 on load and the product runs in full f32, as K2's
// does (no TF32: the l2 form cancels).  Bound on an H100: operations at a
// batch of 64 (2 B D V flops against D V bytes), as for K2; the same SIMT
// tiling, with the given norms added in the epilogue instead of the
// column norms summed beside the product.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;   // queries per block
constexpr int kBN = 64;   // lanes per block
constexpr int kBK = 32;   // dims per K step
constexpr int kThreads = 256;
constexpr int kPad = 4;   // keeps rows 16-byte aligned for float4 reads

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(int8_t v) { return (float)v; }

// kNorms = false is K2 (column norms summed beside the product), true is K7
// (norms given in xn, which K2 leaves null).
template <typename T, typename QT, bool kQuant, bool kIP, bool kNorms>
__global__ void __launch_bounds__(kThreads)
bmm_kernel(const T* __restrict__ x, const QT* __restrict__ Q, const float* __restrict__ qn,
           const float* __restrict__ xn_given, const float* __restrict__ scale,
           const float* __restrict__ offset, float* __restrict__ out, int B, int D, int V,
           int64_t ld_out) {
  __shared__ __align__(16) float Qs[kBK][kBM + kPad];
  __shared__ __align__(16) float Xs[kBK][kBN + kPad];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // lane micro-tile column
  const int ty = tid / 16;  // query micro-tile row
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int p = blockIdx.z;
  const T* xp = x + (int64_t)p * D * V;

  float acc[4][4] = {};
  float xn[4] = {};

  for (int k0 = 0; k0 < D; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < (kBM * kBK) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int m = e / kBK, k = e % kBK;
      const int gm = m0 + m, gk = k0 + k;
      Qs[k][m] = (gm < B && gk < D) ? to_float(Q[(int64_t)gm * D + gk]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < (kBK * kBN) / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int k = e / kBN, n = e % kBN;
      const int gk = k0 + k, gn = n0 + n;
      float v = 0.f;
      if (gk < D && gn < V) {
        v = to_float(xp[(int64_t)gk * V + gn]);
        if (kQuant) v = v * scale[gk] + offset[gk];
      }
      Xs[k][n] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Xs[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
      }
      if (!kIP && !kNorms) {
#pragma unroll
        for (int j = 0; j < 4; ++j) xn[j] += bv[j] * bv[j];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty * 4 + i;
    if (gm >= B) continue;
    const float qv = kIP ? 0.f : qn[gm];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= V) continue;
      const float xv = kIP ? 0.f : (kNorms ? xn_given[gn] : xn[j]);
      out[(int64_t)gm * ld_out + (int64_t)p * V + gn] =
          kIP ? -acc[i][j] : (qv - 2.f * acc[i][j]) + xv;
    }
  }
}

template <typename T, bool kQuant, bool kIP>
cudaError_t launch(const void* x, const float* Q, const float* qn, const float* scale,
                   const float* offset, float* out, int P, int B, int D, int V,
                   cudaStream_t stream) {
  dim3 grid((V + kBN - 1) / kBN, (B + kBM - 1) / kBM, P);
  bmm_kernel<T, float, kQuant, kIP, false><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), Q, qn, nullptr, scale, offset, out, B, D, V, (int64_t)P * V);
  return cudaGetLastError();
}

template <typename T, typename QT, bool kIP>
cudaError_t launch_plain(const void* x, const void* Q, const float* qn, const float* xn,
                         float* out, int B, int D, int V, cudaStream_t stream) {
  dim3 grid((V + kBN - 1) / kBN, (B + kBM - 1) / kBM, 1);
  bmm_kernel<T, QT, false, kIP, true><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const QT*>(Q), qn, xn, nullptr, nullptr, out, B,
      D, V, (int64_t)V);
  return cudaGetLastError();
}

template <typename T, typename QT>
cudaError_t dispatch_plain(const void* x, const void* Q, const float* qn, const float* xn,
                           float* out, int B, int D, int V, bool ip, cudaStream_t s) {
  return ip ? launch_plain<T, QT, true>(x, Q, qn, xn, out, B, D, V, s)
            : launch_plain<T, QT, false>(x, Q, qn, xn, out, B, D, V, s);
}

template <typename T>
cudaError_t dispatch(const void* x, const float* Q, const float* qn, const float* scale,
                     const float* offset, float* out, int P, int B, int D, int V, bool quant,
                     bool ip, cudaStream_t s) {
  if (quant) {
    return ip ? launch<T, true, true>(x, Q, qn, scale, offset, out, P, B, D, V, s)
              : launch<T, true, false>(x, Q, qn, scale, offset, out, P, B, D, V, s);
  }
  return ip ? launch<T, false, true>(x, Q, qn, scale, offset, out, P, B, D, V, s)
            : launch<T, false, false>(x, Q, qn, scale, offset, out, P, B, D, V, s);
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 int8.  Returns a cudaError_t.
extern "C" int batched_distance_quant(const void* x, int dtype, const float* Q, const float* qn,
                                      const float* scale, const float* offset, float* out,
                                      int P, int B, int D, int V, int quantized, int ip,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = quantized != 0, is_ip = ip != 0;
  switch (dtype) {
    case 0:
      return dispatch<float>(x, Q, qn, scale, offset, out, P, B, D, V, quant, is_ip, s);
    case 1:
      return dispatch<__nv_bfloat16>(x, Q, qn, scale, offset, out, P, B, D, V, quant, is_ip, s);
    case 2:
      return dispatch<int8_t>(x, Q, qn, scale, offset, out, P, B, D, V, quant, is_ip, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K7.  t_dtype, q_dtype: 0 f32, 1 bf16.  qn, xn are ignored for ip.
// Returns a cudaError_t.
extern "C" int batched_distance(const void* x, int t_dtype, const void* Q, int q_dtype,
                                const float* qn, const float* xn, float* out, int B, int D,
                                int V, int ip, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool is_ip = ip != 0;
  switch (t_dtype * 2 + q_dtype) {
    case 0:
      return dispatch_plain<float, float>(x, Q, qn, xn, out, B, D, V, is_ip, s);
    case 1:
      return dispatch_plain<float, __nv_bfloat16>(x, Q, qn, xn, out, B, D, V, is_ip, s);
    case 2:
      return dispatch_plain<__nv_bfloat16, float>(x, Q, qn, xn, out, B, D, V, is_ip, s);
    case 3:
      return dispatch_plain<__nv_bfloat16, __nv_bfloat16>(x, Q, qn, xn, out, B, D, V, is_ip,
                                                           s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* batched_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
