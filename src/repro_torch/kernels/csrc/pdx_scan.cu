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
//
// K3: the same scan for the later stages of a multi-resolution cascade,
// the template instance kPrefetch = true of the same kernel.
//
// Replaces the TPU kernel src/repro/kernels/pdx_scan.py:
// pdx_prune_scan_multi_prefetch_pallas (body _prune_scan_dskip_kernel).
// Plain version: repro_torch/kernels/ref.py:pdx_prune_scan_multi_dskip_ref.
// Same inputs, dists and alive as K1 (ids < 0 now also marks the lanes the
// previous stage killed), plus streamed (P,) f32: the d-tiles each
// partition fetched.  The TPU kernel needed a scalar-prefetched
// (partition, d-tile) schedule, alive partitions first, and a manual DMA
// to skip fetches.  Here blocks skip on their own:
//   * the block votes before its first load too, so a partition that
//     enters dead reads its ids and nothing else, and reports dist 0,
//     alive false, streamed 0;
//   * streamed counts the tiles a block loaded; where V > 1024 spreads a
//     partition over several blocks (grid.y), the partition's count is the
//     largest of its blocks' (atomicMax on the float's bits, valid for
//     counts >= 0 on a zeroed output), since the partition stops fetching
//     when its last lane dies.
// Bound on an H100: bytes of the tiles the live partitions stream.  A
// surviving partition is scanned by one block, 4 rows in flight; splitting
// it over blocks is later work.
//
// K4: the plain PDX distance scan, no pruning (the paper's PDX kernel).
//
// Replaces the TPU kernel src/repro/kernels/pdx_scan.py:pdx_distance_pallas
// (body _pdx_dist_kernel).  Plain version:
// repro_torch/kernels/ref.py:pdx_distance_ref.  T (D, V) f32 | bf16, q (D,)
// f32 -> (V,) f32: sum_d (x - q)^2 (l2), sum_d |x - q| (l1) or
// -sum_d x*q (ip), accumulated in f32.  Bound on an H100: bytes (one read
// of T, 1-3 flops a value).  Each thread owns 4 consecutive lanes and walks
// all D rows, so a warp reads 128 consecutive lanes of a row (one 16- or
// 8-byte vector a thread): loads are coalesced along V, the tile's
// contiguous axis, and no lane ever needs another's sum (no cross-thread
// reduction, the point of the layout).  q sits in shared memory.
//
// K6: one partition's fused L2 scan with the ADSampling test per d-tile.
//
// Replaces the TPU kernel src/repro/kernels/pdx_scan.py:
// pdx_prune_scan_pallas (body _prune_scan_kernel).  Plain version:
// repro_torch/kernels/ref.py:pdx_prune_scan_ref.  T (D, V) f32 | bf16,
// ids (V,) int32 or null (every lane real), q (D,) f32, thr one f32 on the
// device -> dists (V,) f32, alive (V,) bool; K1's test, at
// d_seen = min((t+1) * d_tile, D): the operands are not padded, so every
// stored dimension is a logical one.
// The TPU kernel walks the d-tiles of the whole (D, V) partition on one
// core; here the V lanes are split over blocks of 1024, each running its own
// d-tile loop.  That changes no output: a dead lane's accumulator is frozen,
// so which lanes a block skips is invisible.  Bound on an H100: bytes of the
// rows of the lanes still alive.  Pruned lanes are scattered over V, so a
// block rarely dies whole (its vote still ends its loop, loads included);
// what saves bytes is that a thread whose 4 lanes are all dead makes no
// load, so a 32-byte sector of a row is read only while one of its 8 (f32)
// lanes lives.  Per tile the sums run in K1's order (same helpers), so on
// one partition K6 and K1 agree to the last bit or two (the compiler
// contracts the two loops into FMAs differently).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "metric.cuh"

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

// kPrefetch = false is K1, true is K3 (entry vote and `streamed`, which K1
// leaves null).
template <typename T, bool kPacked, bool kPrefetch>
__global__ void __launch_bounds__(kThreads)
prune_scan_multi_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                        const float* __restrict__ q, const float* __restrict__ thr_ptr,
                        const float* __restrict__ scale, const float* __restrict__ offset,
                        float* __restrict__ dists, bool* __restrict__ alive_out,
                        float* __restrict__ streamed, int Drows, int V, int dim, int d_tile,
                        float eps0, bool quant) {
  extern __shared__ float smem[];
  const int p = blockIdx.x;
  const int v0 = (blockIdx.y * blockDim.x + threadIdx.x) * kLanes;
  float acc[kLanes];
  bool live[kLanes];
  int any = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    acc[j] = 0.f;
    live[j] = (v0 + j < V) && ids[(int64_t)p * V + v0 + j] >= 0;
    any |= live[j];
  }
  // K3 votes before the first load: a block with no live lane reads nothing
  // more.  The vote is block-uniform, so the barriers below stay legal.
  const bool run = kPrefetch ? __syncthreads_or(any) != 0 : true;

  int loaded = 0;  // d-tiles this block fetched
  if (run) {
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

    const bool vec = (V % kLanes) == 0;
    const T* base = x + (int64_t)p * Drows * V;
    const float thr = *thr_ptr;
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
      loaded = t + 1;
      const int d_seen = min((t + 1) * d_tile, dim);
      const float fd = (float)d_seen;
      const float ratio = (float)dim / fd;
      const float s = 1.f + eps0 / sqrtf(fd);
      const float bound = thr * (s * s);
      any = 0;
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
  }

#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    if (v0 + j < V) {
      dists[(int64_t)p * V + v0 + j] = acc[j];
      alive_out[(int64_t)p * V + v0 + j] = live[j];
    }
  }
  if constexpr (kPrefetch) {
    if (threadIdx.x == 0 && loaded > 0) {
      atomicMax(reinterpret_cast<int*>(streamed + p), __float_as_int((float)loaded));
    }
  }
}

template <typename T, bool kPacked, bool kPrefetch>
cudaError_t launch(const void* x, const int* ids, const float* q, const float* thr,
                   const float* scale, const float* offset, float* dists, bool* alive,
                   float* streamed, int P, int Drows, int V, int dim, int d_tile, float eps0,
                   bool quant, cudaStream_t stream) {
  const int Dlog = kPacked ? 2 * Drows : Drows;
  const size_t smem = 3 * (size_t)Dlog * sizeof(float);
  auto kernel = prune_scan_multi_kernel<T, kPacked, kPrefetch>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int lanes_per_block = kThreads * kLanes;
  dim3 grid(P, (V + lanes_per_block - 1) / lanes_per_block);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), ids, q, thr, scale, offset,
                                           dists, alive, streamed, Drows, V, dim, d_tile, eps0,
                                           quant);
  return cudaGetLastError();
}

template <bool kPrefetch>
int dispatch(const void* x, int dtype, const int* ids, const float* q, const float* thr,
             const float* scale, const float* offset, float* dists, bool* alive, float* streamed,
             int P, int Drows, int V, int dim, int d_tile, float eps0, int quantized,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool quant = quantized != 0;
  switch (dtype) {
    case 0:
      return launch<float, false, kPrefetch>(x, ids, q, thr, scale, offset, dists, alive,
                                             streamed, P, Drows, V, dim, d_tile, eps0, quant, s);
    case 1:
      return launch<__nv_bfloat16, false, kPrefetch>(x, ids, q, thr, scale, offset, dists, alive,
                                                     streamed, P, Drows, V, dim, d_tile, eps0,
                                                     quant, s);
    case 2:
      return launch<int8_t, false, kPrefetch>(x, ids, q, thr, scale, offset, dists, alive,
                                              streamed, P, Drows, V, dim, d_tile, eps0, quant, s);
    case 3:
      return launch<uint8_t, true, kPrefetch>(x, ids, q, thr, scale, offset, dists, alive,
                                              streamed, P, Drows, V, dim, d_tile, eps0, true, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ K4
template <typename T, int kMetric>
__global__ void __launch_bounds__(kThreads)
pdx_distance_kernel(const T* __restrict__ x, const float* __restrict__ q,
                    float* __restrict__ out, int D, int V) {
  extern __shared__ float sq[];
  for (int i = threadIdx.x; i < D; i += blockDim.x) sq[i] = q[i];
  __syncthreads();
  const int v0 = (blockIdx.x * blockDim.x + threadIdx.x) * kLanes;
  if (v0 >= V) return;
  const bool vec = (V % kLanes) == 0;
  float acc[kLanes] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
  for (int r = 0; r < D; ++r) {
    float xv[kLanes];
    load4(x + (int64_t)r * V, v0, V, vec, xv);
    const float qv = sq[r];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[j] += term<kMetric>(xv[j], qv);
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    if (v0 + j < V) out[v0 + j] = kMetric == kIP ? -acc[j] : acc[j];
  }
}

template <typename T, int kMetric>
cudaError_t launch_distance(const void* x, const float* q, float* out, int D, int V,
                            cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  auto kernel = pdx_distance_kernel<T, kMetric>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int lanes_per_block = kThreads * kLanes;
  kernel<<<(V + lanes_per_block - 1) / lanes_per_block, kThreads, smem, stream>>>(
      static_cast<const T*>(x), q, out, D, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_distance(const void* x, const float* q, float* out, int D, int V,
                              int metric, cudaStream_t s) {
  switch (metric) {
    case kL2: return launch_distance<T, kL2>(x, q, out, D, V, s);
    case kIP: return launch_distance<T, kIP>(x, q, out, D, V, s);
    case kL1: return launch_distance<T, kL1>(x, q, out, D, V, s);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------------------------ K6
template <typename T>
__global__ void __launch_bounds__(kThreads)
prune_scan_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                  const float* __restrict__ q, const float* __restrict__ thr_ptr,
                  float* __restrict__ dists, bool* __restrict__ alive_out, int D, int V,
                  int d_tile, float eps0) {
  extern __shared__ float sq[];
  for (int i = threadIdx.x; i < D; i += blockDim.x) sq[i] = q[i];
  __syncthreads();
  const int v0 = (blockIdx.x * blockDim.x + threadIdx.x) * kLanes;
  float acc[kLanes];
  bool live[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    acc[j] = 0.f;
    live[j] = (v0 + j < V) && (ids == nullptr || ids[v0 + j] >= 0);
  }
  const bool vec = (V % kLanes) == 0;
  const float thr = *thr_ptr;
  for (int r0 = 0; r0 < D; r0 += d_tile) {
    const int d_seen = min(r0 + d_tile, D);
    float c[kLanes] = {0.f, 0.f, 0.f, 0.f};
    if (live[0] | live[1] | live[2] | live[3]) {  // a dead thread loads nothing
      tile_sum(x, r0, d_seen, V, v0, vec, sq, sq, sq, false, c);
    }
    const float fd = (float)d_seen;
    const float ratio = (float)D / fd;
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
      dists[v0 + j] = acc[j];
      alive_out[v0 + j] = live[j];
    }
  }
}

template <typename T>
cudaError_t launch_prune(const void* x, const int* ids, const float* q, const float* thr,
                         float* dists, bool* alive, int D, int V, int d_tile, float eps0,
                         cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  auto kernel = prune_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int lanes_per_block = kThreads * kLanes;
  kernel<<<(V + lanes_per_block - 1) / lanes_per_block, kThreads, smem, stream>>>(
      static_cast<const T*>(x), ids, q, thr, dists, alive, D, V, d_tile, eps0);
  return cudaGetLastError();
}

}  // namespace

// K1.  dtype: 0 f32, 1 bf16, 2 int8, 3 packed int4.  Returns a cudaError_t.
extern "C" int pdx_prune_scan_multi(const void* x, int dtype, const int* ids, const float* q,
                                    const float* thr, const float* scale, const float* offset,
                                    float* dists, bool* alive, int P, int Drows, int V, int dim,
                                    int d_tile, float eps0, int quantized, void* stream) {
  return dispatch<false>(x, dtype, ids, q, thr, scale, offset, dists, alive, nullptr, P, Drows,
                         V, dim, d_tile, eps0, quantized, stream);
}

// K3: as K1, plus `streamed` (P,) f32, which the caller zeroes.
extern "C" int pdx_prune_scan_multi_prefetch(const void* x, int dtype, const int* ids,
                                             const float* q, const float* thr,
                                             const float* scale, const float* offset,
                                             float* dists, bool* alive, float* streamed, int P,
                                             int Drows, int V, int dim, int d_tile, float eps0,
                                             int quantized, void* stream) {
  return dispatch<true>(x, dtype, ids, q, thr, scale, offset, dists, alive, streamed, P, Drows,
                        V, dim, d_tile, eps0, quantized, stream);
}

// K4.  dtype: 0 f32, 1 bf16; metric: 0 l2, 1 ip (negated), 2 l1.
extern "C" int pdx_distance(const void* x, int dtype, const float* q, float* out, int D, int V,
                            int metric, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_distance<float>(x, q, out, D, V, metric, s);
    case 1: return dispatch_distance<__nv_bfloat16>(x, q, out, D, V, metric, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6.  dtype: 0 f32, 1 bf16; ids may be null (every lane real).
extern "C" int pdx_prune_scan(const void* x, int dtype, const int* ids, const float* q,
                              const float* thr, float* dists, bool* alive, int D, int V,
                              int d_tile, float eps0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_prune<float>(x, ids, q, thr, dists, alive, D, V, d_tile, eps0, s);
    case 1:
      return launch_prune<__nv_bfloat16>(x, ids, q, thr, dists, alive, D, V, d_tile, eps0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* pdx_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
