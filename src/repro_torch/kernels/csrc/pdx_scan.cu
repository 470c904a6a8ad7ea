// K1: whole-store fused L2 scan with the ADSampling test per d-tile.
//
// Replaces the TPU kernel src/repro/kernels/pdx_scan.py:
// pdx_prune_scan_multi_pallas (body _prune_scan_multi_kernel).  Contract
// (plain version: repro_torch/kernels/ref.py:pdx_prune_scan_multi_ref):
//   T (P, Drows, V) f32 | bf16 | int8, or packed int4 (P, ceil(dim/2), V)
//   uint8 (byte r holds dims 2r and 2r+1 in its low and high nibble, +8
//   bias); ids (P, V) int32; q, scale, offset (Dlog,) f32 (Dlog = Drows,
//   or 2*Drows when packed, zero-padded past dim); thr: one f32 on the
//   device.  Out: dists (P, V) f32 and alive (P, V) bool.  Lanes with
//   ids < 0 start dead.  After each d-tile a live lane accumulates the
//   tile's sum of (x*scale + offset - q)^2 and stays alive while
//       acc * (dim / d_seen) <= thr * (1 + eps0 / sqrt(d_seen))^2,
//   d_seen = min((t+1) * d_tile, dim), every scalar a true f32 operation
//   (no --use_fast_math: approximate division or root flips lanes at the
//   bound).  A dead lane keeps its partial distance.
//
// What bounds it on an H100: bytes.  The store is read once at mirror
// width (960 dims x 1024 lanes x 1.5 k partitions is 5.9 GB at f32) for
// about 3 flops a value, far below the card's ~20 flops per byte of f32
// SIMT throughput.  The design keeps every byte moved useful:
//   * one block per partition (and per 1024 lanes), 256 threads, each
//     thread owning 4 consecutive lanes: a dimension row x[p, d, :] is
//     read as one 16/8/4-byte vector per thread, so a warp reads 128
//     consecutive lanes and the PDX tile needs no relayout;
//   * q, scale and offset for all dims sit in shared memory, loaded once;
//   * accumulators and alive flags live in registers for the whole scan;
//   * after each d-tile the block votes (__syncthreads_or) and stops when
//     no lane is alive, which skips the remaining loads as well as the
//     arithmetic (the TPU kernel could only skip the arithmetic).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;  // consecutive lanes per thread

// Load 4 consecutive lanes [v0, v0 + 4) of one dimension row as floats.
// `vec` is true when V % 4 == 0, so the 4 lanes are aligned and in range.
__device__ __forceinline__ void load4(const float* row, int v0, int V, bool vec, float x[4]) {
  if (vec) {
    float4 t = *reinterpret_cast<const float4*>(row + v0);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) x[j] = (v0 + j < V) ? row[v0 + j] : 0.f;
  }
}

__device__ __forceinline__ void load4(const __nv_bfloat16* row, int v0, int V, bool vec, float x[4]) {
  if (vec) {
    uint2 t = *reinterpret_cast<const uint2*>(row + v0);
    __nv_bfloat162 a = *reinterpret_cast<__nv_bfloat162*>(&t.x);
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&t.y);
    x[0] = __bfloat162float(a.x); x[1] = __bfloat162float(a.y);
    x[2] = __bfloat162float(b.x); x[3] = __bfloat162float(b.y);
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) x[j] = (v0 + j < V) ? __bfloat162float(row[v0 + j]) : 0.f;
  }
}

__device__ __forceinline__ void load4(const int8_t* row, int v0, int V, bool vec, float x[4]) {
  if (vec) {
    char4 t = *reinterpret_cast<const char4*>(row + v0);
    x[0] = (float)t.x; x[1] = (float)t.y; x[2] = (float)t.z; x[3] = (float)t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) x[j] = (v0 + j < V) ? (float)row[v0 + j] : 0.f;
  }
}

__device__ __forceinline__ void load4_bytes(const uint8_t* row, int v0, int V, bool vec, int b[4]) {
  if (vec) {
    uchar4 t = *reinterpret_cast<const uchar4*>(row + v0);
    b[0] = t.x; b[1] = t.y; b[2] = t.z; b[3] = t.w;
  } else {
#pragma unroll
    for (int j = 0; j < kLanes; ++j) b[j] = (v0 + j < V) ? row[v0 + j] : 0x88;
  }
}

__device__ __forceinline__ float sq_dev(float x, float s, float o, float qv, bool quant) {
  float v = quant ? x * s + o : x;
  float d = v - qv;
  return d * d;
}

// One tile's contribution for rows [r0, r1) into c[4].
template <typename T>
__device__ __forceinline__ void tile_sum(const T* base, int r0, int r1, int V, int v0, bool vec,
                                         const float* sq, const float* ss, const float* so,
                                         bool quant, float c[4]) {
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    float x[4];
    load4(base + (int64_t)r * V, v0, V, vec, x);
    const float qv = sq[r], s = ss[r], o = so[r];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) c[j] += sq_dev(x[j], s, o, qv, quant);
  }
}

// Packed int4: byte row r holds dims 2r (low nibble) and 2r+1 (high).
__device__ __forceinline__ void tile_sum_packed(const uint8_t* base, int r0, int r1, int V, int v0,
                                                bool vec, const float* sq, const float* ss,
                                                const float* so, float c[4]) {
#pragma unroll 4
  for (int r = r0; r < r1; ++r) {
    int b[4];
    load4_bytes(base + (int64_t)r * V, v0, V, vec, b);
    const int d0 = 2 * r, d1 = 2 * r + 1;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      c[j] += sq_dev((float)((b[j] & 0xF) - 8), ss[d0], so[d0], sq[d0], true);
      c[j] += sq_dev((float)((b[j] >> 4) - 8), ss[d1], so[d1], sq[d1], true);
    }
  }
}

template <typename T, bool kPacked>
__global__ void __launch_bounds__(kThreads)
prune_scan_multi_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                        const float* __restrict__ q, const float* __restrict__ thr_ptr,
                        const float* __restrict__ scale, const float* __restrict__ offset,
                        float* __restrict__ dists, bool* __restrict__ alive_out,
                        int Drows, int V, int dim, int d_tile, float eps0, bool quant) {
  extern __shared__ float smem[];
  const int Dlog = kPacked ? 2 * Drows : Drows;
  float* sq = smem;
  float* ss = smem + Dlog;
  float* so = smem + 2 * Dlog;
  for (int i = threadIdx.x; i < Dlog; i += blockDim.x) {
    sq[i] = q[i];
    ss[i] = scale[i];
    so[i] = offset[i];
  }
  __syncthreads();

  const int p = blockIdx.x;
  const int v0 = (blockIdx.y * blockDim.x + threadIdx.x) * kLanes;
  const bool vec = (V % kLanes) == 0;
  const T* base = x + (int64_t)p * Drows * V;
  const float thr = *thr_ptr;

  float acc[kLanes];
  bool live[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    acc[j] = 0.f;
    live[j] = (v0 + j < V) && ids[(int64_t)p * V + v0 + j] >= 0;
  }

  const int rows_per_tile = kPacked ? d_tile / 2 : d_tile;
  const int n_tiles = (dim + d_tile - 1) / d_tile;
  for (int t = 0; t < n_tiles; ++t) {
    const int r0 = t * rows_per_tile;
    const int r1 = min(r0 + rows_per_tile, Drows);
    float c[kLanes] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (kPacked) {
      tile_sum_packed(reinterpret_cast<const uint8_t*>(base), r0, r1, V, v0, vec, sq, ss, so, c);
    } else {
      tile_sum(base, r0, r1, V, v0, vec, sq, ss, so, quant, c);
    }
    const int d_seen = min((t + 1) * d_tile, dim);
    const float fd = (float)d_seen;
    const float ratio = (float)dim / fd;
    const float s = 1.f + eps0 / sqrtf(fd);
    const float bound = thr * (s * s);
    int any = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      if (live[j]) {
        acc[j] += c[j];
        live[j] = acc[j] * ratio <= bound;
      }
      any |= live[j];
    }
    if (!__syncthreads_or(any)) break;  // no lane of this block alive
  }

#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    if (v0 + j < V) {
      dists[(int64_t)p * V + v0 + j] = acc[j];
      alive_out[(int64_t)p * V + v0 + j] = live[j];
    }
  }
}

template <typename T, bool kPacked>
cudaError_t launch(const void* x, const int* ids, const float* q, const float* thr,
                   const float* scale, const float* offset, float* dists, bool* alive, int P,
                   int Drows, int V, int dim, int d_tile, float eps0, bool quant,
                   cudaStream_t stream) {
  const int Dlog = kPacked ? 2 * Drows : Drows;
  const size_t smem = 3 * (size_t)Dlog * sizeof(float);
  auto kernel = prune_scan_multi_kernel<T, kPacked>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int lanes_per_block = kThreads * kLanes;
  dim3 grid(P, (V + lanes_per_block - 1) / lanes_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), ids, q, thr, scale, offset,
                                           dists, alive, Drows, V, dim, d_tile, eps0, quant);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 int8, 3 packed int4.  Returns a cudaError_t.
extern "C" int pdx_prune_scan_multi(const void* x, int dtype, const int* ids, const float* q,
                                    const float* thr, const float* scale, const float* offset,
                                    float* dists, bool* alive, int P, int Drows, int V, int dim,
                                    int d_tile, float eps0, int quantized, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = quantized != 0;
  switch (dtype) {
    case 0:
      return launch<float, false>(x, ids, q, thr, scale, offset, dists, alive, P, Drows, V, dim,
                                  d_tile, eps0, quant, s);
    case 1:
      return launch<__nv_bfloat16, false>(x, ids, q, thr, scale, offset, dists, alive, P, Drows,
                                          V, dim, d_tile, eps0, quant, s);
    case 2:
      return launch<int8_t, false>(x, ids, q, thr, scale, offset, dists, alive, P, Drows, V, dim,
                                   d_tile, eps0, quant, s);
    case 3:
      return launch<uint8_t, true>(x, ids, q, thr, scale, offset, dists, alive, P, Drows, V, dim,
                                   d_tile, eps0, true, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pdx_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
