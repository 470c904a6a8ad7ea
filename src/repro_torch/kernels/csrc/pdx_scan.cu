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
// What bounds it on an H100: bytes.  At mirror width (960 dims x 1024 lanes
// x 1.5 k partitions) nearly every partition dies at its first d-tile, so
// the scan is a sweep of d-tile 0 over the whole store (80 % of its bytes)
// and then a tail of a few surviving partitions (about 22) walking all
// their d-tiles, about 3 flops a value.  Two bodies, chosen by the shape
// (scan_geometry):
//   * bulk, wherever every row segment a block reads is 16-byte aligned
//     (V * bytes per lane % 16 == 0 and an aligned base; the mirrors,
//     C = 1024, always are): a block covers 256 lanes (128 at f32, so a
//     d-tile of it is 32 KB) of one partition, 4 lanes a thread, so a
//     surviving partition's tail runs on 4-8 blocks over as many SMs.
//     Thread 0 requests each d-tile as one tensor copy (cp.async.bulk.tensor
//     over the mirror as a 3D tensor map (V, Drows, P), box lanes x rows)
//     into a ring in shared memory, counted on the stage's mbarrier
//     (expect_tx); threads read their lanes from the stage, and q, scale
//     and offset from a {q, scale, offset} table of the launch's dims in
//     shared memory, loaded while the first copy flies.  Two launches:
//       - the sweep of d-tile 0, one block per (partition, 256 lanes), one
//         stage each: no copy runs ahead of the first vote, where nearly
//         every block dies, and 6-18 blocks fit an SM;
//       - the tail over tiles 1..: G blocks (4 for each block slot of the
//         card; one lane a thread, 4 for packed int4), block b owning items
//         b, b + G, ...; it reads its items' alive flags 16 at a time and
//         walks the survivors, each lane resuming from the sweep's dists
//         and alive, with a ring of 3 stages kept full (2 d-tiles of
//         look-ahead).  A block initialises its ring's mbarriers once,
//         before its first item, and waits on every copy it requested
//         before it moves on or leaves.  Blocks that find no survivor leave
//         early, so a block that drew two surviving items waits less for a
//         slot.  The host keeps what it asks of the runtime (the tail's
//         occupancy) and the driver (the tensor map) per kernel and shape.
//     Each sum loads 16 bytes of stored values a lane ahead (4-16 rows)
//     before adding them, in row order.  Measured on the H100 and replaced
//     on the way (PERF.md): one launch with its ring sized for the tail
//     (3-4 blocks an SM in the sweep), a tail launch over every block
//     (thousands of empty blocks holding 98 KB each), q/scale/offset read
//     through L1, and sums that waited one shared-memory latency a row.
//   * direct, for the other shapes: one block per partition and 1024
//     lanes, 256 threads of 4 lanes loading their rows from global memory
//     (4 rows in flight), q/scale/offset in shared memory.
// In both, each lane's tile sum is the same row-ordered sequential sum
// (tile_sum's arithmetic), accumulators and alive flags live in registers
// (the bulk tail reloads them from the sweep's f32 outputs, exactly), and
// after each d-tile the block votes (__syncthreads_or) and stops when none
// of its lanes is alive, which skips the remaining loads as well as the
// arithmetic (the TPU kernel could only skip the arithmetic).  A dead
// lane's accumulator is frozen, so how lanes are grouped into blocks
// changes no output.
//
// K3: the same scan for the later stages of a multi-resolution cascade,
// the template instances kPrefetch = true of the same kernels.
//
// Replaces the TPU kernel src/repro/kernels/pdx_scan.py:
// pdx_prune_scan_multi_prefetch_pallas (body _prune_scan_dskip_kernel).
// Plain version: repro_torch/kernels/ref.py:pdx_prune_scan_multi_dskip_ref.
// Same inputs, dists and alive as K1 (ids < 0 now also marks the lanes the
// previous stage killed), plus streamed (P,) f32: the d-tiles each
// partition computed.  The TPU kernel needed a scalar-prefetched
// (partition, d-tile) schedule, alive partitions first, and a manual DMA
// to skip fetches.  Here blocks skip on their own:
//   * the block votes before its first load too, so a block that enters
//     dead reads its ids and nothing else, and reports dist 0, alive
//     false (the bulk body votes so for K1 as well: a block of PAD lanes
//     requests no copy);
//   * streamed counts the tiles a block summed (look-ahead copies do not
//     count); where a partition spans several blocks (grid.y), the
//     partition's count is the largest of its blocks' (atomicMax on the
//     float's bits, valid for counts >= 0 on a zeroed output), since the
//     partition stops when its last lane dies.
// Bound on an H100: bytes of the tiles the live lanes stream.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <mutex>
#include <vector>

#include "mbarrier.cuh"
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

// The direct body.  kPrefetch = false is K1, true is K3 (entry vote and
// `streamed`, which K1 leaves null).
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

// ------------------------------------------------------ K1/K3, bulk body
constexpr int kStageBudget = 32 * 1024;  // bytes of one ring stage (a d-tile of a block), at most
constexpr int kTailStages = 3;           // ring stages of the tail launch
constexpr int kTailOversub = 4;          // tail blocks per block slot the card has
constexpr int kBarBytes = 32;            // the ring's mbarriers, 8 bytes a stage
constexpr int kTailBatch = 16;           // items a tail block checks at once
constexpr size_t kSmemMax = 227 * 1024;  // dynamic shared memory a block can have

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return (float)v; }

// N consecutive lanes of one stored row in shared memory (one vector load
// for N = 4).
template <int N, typename T>
__device__ __forceinline__ void load_lanes(const T* p, float x[N]) {
  if constexpr (N == kLanes) {
    load4(p, 0, kLanes, true, x);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = to_f32(p[j]);
  }
}

template <int N>
__device__ __forceinline__ void load_bytes(const uint8_t* p, int b[N]) {
  if constexpr (N == kLanes) {
    load4_bytes(p, 0, kLanes, true, b);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = p[j];
  }
}

// Lanes a thread of the tail launch: one (more warps to hide a d-tile's
// sums behind), but 4 for packed int4, whose byte holds two values.
template <bool kPacked>
__host__ __device__ constexpr int tail_lanes() { return kPacked ? kLanes : 1; }

// One tile's contribution from a ring stage: its `rows` stored rows, row i
// at stage + i * lanes (`stage` already at the thread's N lanes), qso[d] =
// {q, scale, offset, 0} of the tile's d-th dim.  kAhead rows (16 bytes of
// stored values a lane) are loaded before any of them is summed, so the
// shared-memory loads overlap instead of costing one latency a row; the
// sums still run row by row in tile_sum's order and arithmetic.
template <typename T, bool kQuant, int N>
__device__ __forceinline__ void stage_sum(const T* stage, int lanes, int rows, const float4* qso,
                                          float c[N]) {
  constexpr int kAhead = 16 / sizeof(T);
  int i = 0;
  for (; i + kAhead <= rows; i += kAhead) {
    float x[kAhead][N];
    float4 w[kAhead];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      load_lanes<N>(stage + (i + r) * lanes, x[r]);
      w[r] = qso[i + r];
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
#pragma unroll
      for (int j = 0; j < N; ++j) c[j] += sq_dev(x[r][j], w[r].y, w[r].z, w[r].x, kQuant);
    }
  }
  for (; i < rows; ++i) {
    float x[N];
    load_lanes<N>(stage + i * lanes, x);
    const float4 w = qso[i];
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] += sq_dev(x[j], w.y, w.z, w.x, kQuant);
  }
}

// Packed int4: byte row i holds the tile's dims 2i (low nibble) and 2i+1.
template <int N>
__device__ __forceinline__ void stage_sum_packed(const uint8_t* stage, int lanes, int rows,
                                                 const float4* qso, float c[N]) {
  constexpr int kAhead = 16;
  auto add = [&](const int b[N], const float4& w0, const float4& w1) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c[j] += sq_dev((float)((b[j] & 0xF) - 8), w0.y, w0.z, w0.x, true);
      c[j] += sq_dev((float)((b[j] >> 4) - 8), w1.y, w1.z, w1.x, true);
    }
  };
  int i = 0;
  for (; i + kAhead <= rows; i += kAhead) {
    int b[kAhead][N];
    float4 w[2 * kAhead];
#pragma unroll
    for (int r = 0; r < kAhead; ++r) {
      load_bytes<N>(stage + (i + r) * lanes, b[r]);
      w[2 * r] = qso[2 * (i + r)];
      w[2 * r + 1] = qso[2 * (i + r) + 1];
    }
#pragma unroll
    for (int r = 0; r < kAhead; ++r) add(b[r], w[2 * r], w[2 * r + 1]);
  }
  for (; i < rows; ++i) {
    int b[N];
    load_bytes<N>(stage + i * lanes, b);
    add(b, qso[2 * i], qso[2 * i + 1]);
  }
}

// What a bulk launch's blocks share.  Dynamic shared memory: `stages` ring
// stages of one d-tile box (rows x lanes), the mbarriers (kBarBytes), then
// {q, scale, offset, 0} for the logical dims of tiles [t_lo, t_hi).
struct BulkArgs {
  const float* q;
  const float* thr;
  const float* scale;
  const float* offset;
  float* dists;
  bool* alive;
  float* streamed;
  int P, Drows, V, dim, d_tile;
  float eps0;
  int lanes;        // lanes of a block
  int rows;         // stored rows of a d-tile (the box's)
  int stages;
  int stage_bytes;
  int t_lo, t_hi;   // the launch's tiles
};

// The block scans tiles [a.t_lo, a.t_hi) of the item at partition p, lanes
// [vb, vb + a.lanes), into the thread's acc/live (its N lanes).  Thread 0
// requests each d-tile as one tensor copy into its stage: one arrival
// announcing the box's bytes (rows past Drows and lanes past V arrive as
// zeros), then the copy.  The ring is filled at once (tile t_lo alone in
// the sweep, whose ring has one stage) and after each vote the freed stage
// takes the next tile.  `seq` counts the copies the block requested before
// (its ring's mbarriers, initialised once by ring_init, run on across
// items): tile t is copy seq + t - t_lo, in stage (copy % stages), whose
// phase (copy / stages) % 2 it waits on.  `fill_qso` loads the dims'
// q/scale/offset while the first copies fly.  No block leaves with a copy
// in flight: before returning it waits on every tile it requested.
// Returns the tiles summed, counted from tile 0.
template <typename T, bool kPacked, bool kQuant, int N>
__device__ int scan_item(const CUtensorMap* map, unsigned char* smem, const BulkArgs& a, int p,
                         int vb, bool fill_qso, uint32_t& seq, float acc[N], bool live[N]) {
  const int dpt = kPacked ? 2 * a.rows : a.rows;  // logical dims of a tile
  const uint32_t ring0 = smem_u32(smem);
  const uint32_t bar0 = ring0 + a.stages * a.stage_bytes;
  float4* qso = reinterpret_cast<float4*>(smem + a.stages * a.stage_bytes + kBarBytes);
  // tile t is the block's copy number seq + t - t_lo: its stage, and the
  // phase of that stage's mbarrier to wait on
  auto stage = [&](int t) { return (int)((seq + (uint32_t)(t - a.t_lo)) % (uint32_t)a.stages); };
  auto parity = [&](int t) {
    return ((seq + (uint32_t)(t - a.t_lo)) / (uint32_t)a.stages) & 1u;
  };
  auto request = [&](int t) {
    if (threadIdx.x == 0) {
      const int s = stage(t);
      mbar_arrive_expect_tx(bar0 + 8 * s, a.stage_bytes);
      tma_load_3d(ring0 + s * a.stage_bytes, map, vb, t * a.rows, p, bar0 + 8 * s);
    }
  };
  int requested = min(a.t_lo + a.stages, a.t_hi);
  for (int u = a.t_lo; u < requested; ++u) request(u);
  if (fill_qso) {  // 8 dims a thread in flight at once
    const int d_lo = a.t_lo * dpt;
    const int d_hi = min(a.t_hi * dpt, kPacked ? 2 * a.Drows : a.Drows);
    for (int d0 = d_lo + (int)threadIdx.x; d0 < d_hi; d0 += 8 * (int)blockDim.x) {
      float4 w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = d0 + k * (int)blockDim.x;
        w[k] = d < d_hi ? make_float4(a.q[d], a.scale[d], a.offset[d], 0.f)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int d = d0 + k * (int)blockDim.x;
        if (d < d_hi) qso[d - d_lo] = w[k];
      }
    }
    __syncthreads();
  }

  const float thr = *a.thr;
  int summed = 0;
  for (int t = a.t_lo; t < a.t_hi; ++t) {
    const int s = stage(t);
    mbar_wait(bar0 + 8 * s, parity(t));
    const int n_rows = min(a.rows, a.Drows - t * a.rows);
    const T* tile = reinterpret_cast<const T*>(smem + s * a.stage_bytes) + threadIdx.x * N;
    const float4* w = qso + (t - a.t_lo) * dpt;
    float c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = 0.f;
    if constexpr (kPacked) {
      stage_sum_packed<N>(tile, a.lanes, n_rows, w, c);
    } else {
      stage_sum<T, kQuant, N>(tile, a.lanes, n_rows, w, c);
    }
    summed = t + 1;
    const int d_seen = min((t + 1) * a.d_tile, a.dim);
    const float fd = (float)d_seen;
    const float ratio = (float)a.dim / fd;
    const float sc = 1.f + a.eps0 / sqrtf(fd);
    const float bound = thr * (sc * sc);
    int any = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (live[j]) {
        acc[j] += c[j];
        live[j] = acc[j] * ratio <= bound;
      }
      any |= live[j];
    }
    if (!__syncthreads_or(any)) break;  // no lane of this block alive
    if (requested < a.t_hi) request(requested++);  // into the stage tile t freed
  }
  for (int u = summed; u < requested; ++u) mbar_wait(bar0 + 8 * stage(u), parity(u));
  seq += (uint32_t)(requested - a.t_lo);
  __syncthreads();  // every thread is done with the ring before the next item's copies
  return summed;
}

// Initialises the ring's mbarriers (one a stage, one arrival each phase),
// once a block, before its first item; their phases then run on from item
// to item (scan_item's `seq`).
__device__ __forceinline__ void ring_init(unsigned char* smem, const BulkArgs& a) {
  if (threadIdx.x == 0) {
    const uint32_t bar0 = smem_u32(smem) + a.stages * a.stage_bytes;
    for (int s = 0; s < a.stages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The thread's N lanes' outputs (V % 4 == 0 in the bulk body: one vector
// each for N = 4).
template <int N>
__device__ __forceinline__ void store_lanes(const BulkArgs& a, int64_t out0, const float acc[N],
                                            const bool live[N]) {
  if constexpr (N == kLanes) {
    *reinterpret_cast<float4*>(a.dists + out0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<uchar4*>(a.alive + out0) = make_uchar4(live[0], live[1], live[2], live[3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      a.dists[out0 + j] = acc[j];
      a.alive[out0 + j] = live[j];
    }
  }
}

// The sweep launch: one block per item (partition p = blockIdx.x, lanes
// from blockIdx.y * a.lanes), kLanes lanes a thread, tile 0 only.  The
// block votes on its ids before any copy (a block of dead or PAD lanes
// reads nothing more) and writes all its lanes.
template <typename T, bool kPacked, bool kPrefetch, bool kQuant>
__global__ void __launch_bounds__(256 / kLanes)
prune_scan_sweep_kernel(const __grid_constant__ CUtensorMap map, const int* __restrict__ ids,
                        const __grid_constant__ BulkArgs a) {
  extern __shared__ __align__(128) unsigned char ring[];  // see BulkArgs
  const int p = blockIdx.x;
  const int vb = blockIdx.y * a.lanes;
  const int v0 = vb + threadIdx.x * kLanes;
  const int64_t out0 = (int64_t)p * a.V + v0;
  float acc[kLanes] = {0.f, 0.f, 0.f, 0.f};
  bool live[kLanes];
  int any = 0;
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    live[j] = v0 < a.V && ids[out0 + j] >= 0;
    any |= live[j];
  }
  int summed = 0;
  if (__syncthreads_or(any)) {
    ring_init(ring, a);
    uint32_t seq = 0;
    summed = scan_item<T, kPacked, kQuant, kLanes>(&map, ring, a, p, vb, true, seq, acc, live);
  }
  if (v0 < a.V) store_lanes<kLanes>(a, out0, acc, live);
  if constexpr (kPrefetch) {
    if (threadIdx.x == 0 && summed > 0) {
      atomicMax(reinterpret_cast<int*>(a.streamed + p), __float_as_int((float)summed));
    }
  }
}

// The tail launch, over tiles 1.., tail_lanes() lanes a thread: block b
// owns items b, b + gridDim.x, ... (item i: partition i / nb, lanes from
// (i % nb) * a.lanes, so a surviving partition's items land on
// neighbouring blocks).  A block reads its items' alive flags
// kTailBatch at a time, votes on each, and walks the survivors one after
// the other, each lane resuming from the dists and alive the sweep wrote.
// Items no lane of which survived tile 0 are left as the sweep wrote them.
template <typename T, bool kPacked, bool kPrefetch, bool kQuant>
__global__ void __launch_bounds__(256)
prune_scan_tail_kernel(const __grid_constant__ CUtensorMap map,
                       const __grid_constant__ BulkArgs a) {
  constexpr int N = tail_lanes<kPacked>();
  extern __shared__ __align__(128) unsigned char ring[];  // see BulkArgs
  const int nb = (a.V + a.lanes - 1) / a.lanes;
  const int items = a.P * nb;
  // the thread's N alive bytes of item i, as one word (0 past the items or V)
  auto alive_word = [&](int i) -> uint32_t {
    const int v0 = (i % nb) * a.lanes + threadIdx.x * N;
    if (i >= items || v0 >= a.V) return 0u;
    const bool* f = a.alive + (int64_t)(i / nb) * a.V + v0;
    if constexpr (N == kLanes) return *reinterpret_cast<const uint32_t*>(f);
    uint32_t w = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) w |= (uint32_t)f[j] << (8 * j);
    return w;
  };
  bool qso_loaded = false;  // and the ring's mbarriers initialised
  uint32_t seq = 0;          // copies the block has requested
  for (int i0 = blockIdx.x; i0 < items; i0 += kTailBatch * gridDim.x) {
    uint32_t flags[kTailBatch];
#pragma unroll
    for (int k = 0; k < kTailBatch; ++k) flags[k] = alive_word(i0 + k * gridDim.x);
    uint32_t found = 0;  // the batch's items with a live lane
#pragma unroll
    for (int k = 0; k < kTailBatch; ++k) found |= (uint32_t)__syncthreads_or(flags[k] != 0u) << k;
    while (found != 0u) {
      const int k = __ffs(found) - 1;
      found &= found - 1u;
      const int i = i0 + k * gridDim.x;
      const int p = i / nb, vb = (i % nb) * a.lanes;
      const int v0 = vb + threadIdx.x * N;
      const int64_t out0 = (int64_t)p * a.V + v0;
      const uint32_t f = alive_word(i);
      float acc[N];
      bool live[N];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        live[j] = (f >> (8 * j)) & 0xFFu;
        acc[j] = v0 < a.V ? a.dists[out0 + j] : 0.f;
      }
      if (!qso_loaded) ring_init(ring, a);
      const int summed = scan_item<T, kPacked, kQuant, N>(&map, ring, a, p, vb, !qso_loaded,
                                                          seq, acc, live);
      qso_loaded = true;
      if (v0 < a.V) store_lanes<N>(a, out0, acc, live);
      if constexpr (kPrefetch) {
        if (threadIdx.x == 0) {
          atomicMax(reinterpret_cast<int*>(a.streamed + p), __float_as_int((float)summed));
        }
      }
    }
  }
}

// The launch shape of K1 and K3, one rule for the launches and for
// pdx_prune_scan_multi_geometry.
struct Geometry {
  bool bulk;
  int lanes;          // lanes per block
  int rows;           // stored rows of a d-tile (bulk: of a tensor-map box)
  int stage_bytes;    // bulk: a box
  size_t smem;        // dynamic shared memory per block (bulk: of the tail launch), bytes
  size_t smem_sweep;  // the same, of the bulk sweep launch (one stage)
  dim3 grid;          // blocks (bulk: of the sweep launch)
  int tail_blocks;    // bulk: blocks of the tail launch
};

// `lane_bytes`: bytes of one lane of a stored row (1 for packed int4).  The
// bulk body wherever every row segment a block reads is 16-byte aligned
// (also the tensor map's rule for its strides and base), a d-tile of 128
// or more lanes fits a stage and the tail's ring and table fit a block.
Geometry scan_geometry(const void* x, int lane_bytes, bool packed, int P, int Drows, int V,
                       int d_tile) {
  const int Dlog = packed ? 2 * Drows : Drows;
  const size_t direct_smem = 3 * (size_t)Dlog * sizeof(float);
  const int rows = std::min(packed ? d_tile / 2 : d_tile, Drows);
  Geometry g{false, kThreads * kLanes, rows, 0, direct_smem, direct_smem, dim3(1, 1), 0};
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       (int64_t)V * lane_bytes % 16 == 0;
  const int dpt = packed ? 2 * rows : rows;  // logical dims of a d-tile
  const size_t table = (size_t)std::max(Dlog - dpt, 0) * sizeof(float4);  // the tail's dims
  for (int lanes = 256; aligned && lanes >= 128; lanes /= 2) {
    const int stage = rows * lanes * lane_bytes;
    if (stage <= kStageBudget && kTailStages * (size_t)stage + kBarBytes + table <= kSmemMax) {
      g.bulk = true;
      g.lanes = lanes;
      g.stage_bytes = stage;
      g.smem_sweep = stage + kBarBytes + (size_t)std::min(dpt, Dlog) * sizeof(float4);
      g.smem = kTailStages * (size_t)stage + kBarBytes + table;
      break;
    }
  }
  g.grid = dim3(P, (V + g.lanes - 1) / g.lanes);
  return g;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (so the
// library needs no link to libcuda); null where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      return EncodeTiled(nullptr);
    }
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// The tensor map of the mirror as a 3D tensor (V, Drows, P), innermost
// first, whose box is one d-tile of one block: `lanes` x `rows`.
template <typename T>
cudaError_t tile_map(CUtensorMap* map, const void* x, int P, int Drows, int V, int lanes,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)V, (cuuint64_t)Drows, (cuuint64_t)P};
  const cuuint64_t strides[2] = {(cuuint64_t)V * sizeof(T), (cuuint64_t)Drows * V * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)lanes, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUtensorMapDataType type = sizeof(T) == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                    : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  const CUresult r = encode(map, type, 3, const_cast<void*>(x), dims, strides, box, step,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// What plan() asks of the runtime and the driver for one kernel instance,
// kept so that a call on a device, block size and shape seen before asks
// nothing: the tail's blocks for each (device, threads, shared memory), and
// the tensor map last encoded with what it was encoded from (a map holds
// only the address and the shape, so an equal key gives an equal map).
struct PlanCache {
  struct Tail {
    int device, threads;
    size_t smem;
    int blocks;
  };
  struct Map {
    const void* x;
    int P, Drows, V, lanes, rows;
    CUtensorMap map;
  };
  std::mutex mu;
  std::vector<Tail> tails;
  bool has_map = false;
  Map last{};
};

// The tail launch's blocks (kTailOversub for each block slot of the current
// device), the opt-in to more than 48 KB of shared memory made on the way.
template <typename Kernel>
cudaError_t tail_blocks(PlanCache& cache, Kernel tail, int threads, size_t smem, int* blocks) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(cache.mu);
  for (const PlanCache::Tail& e : cache.tails) {
    if (e.device == device && e.threads == threads && e.smem == smem) {
      *blocks = e.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if ((err = cudaFuncSetAttribute(tail, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kSmemMax)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail, threads, smem)) !=
          cudaSuccess) {
    return err;
  }
  *blocks = kTailOversub * sms * per_sm;
  cache.tails.push_back({device, threads, smem, *blocks});
  return cudaSuccess;
}

template <typename T>
cudaError_t cached_tile_map(PlanCache& cache, CUtensorMap* map, const void* x, int P, int Drows,
                            int V, int lanes, int rows) {
  std::lock_guard<std::mutex> lock(cache.mu);
  const PlanCache::Map& m = cache.last;
  if (!(cache.has_map && m.x == x && m.P == P && m.Drows == Drows && m.V == V &&
        m.lanes == lanes && m.rows == rows)) {
    PlanCache::Map fresh{x, P, Drows, V, lanes, rows, {}};
    const cudaError_t err = tile_map<T>(&fresh.map, x, P, Drows, V, lanes, rows);
    if (err != cudaSuccess) return err;
    cache.last = fresh;
    cache.has_map = true;
  }
  *map = cache.last.map;
  return cudaSuccess;
}

// Plans the launch of K1 (K3) on the mirror and, with `go`, launches it: the
// bulk body as the sweep of tile 0 then, where there are more tiles, the
// tail; otherwise the direct body.  `out` (may be null) receives the plan.
template <typename T, bool kPacked, bool kPrefetch, bool kQuant>
cudaError_t plan(const void* x, const int* ids, const BulkArgs& args, bool go, Geometry* out,
                 cudaStream_t stream) {
  static PlanCache cache;
  Geometry g = scan_geometry(x, sizeof(T), kPacked, args.P, args.Drows, args.V, args.d_tile);
  const int n_tiles = (args.dim + args.d_tile - 1) / args.d_tile;
  cudaError_t err = cudaSuccess;
  if (g.bulk) {
    auto sweep = prune_scan_sweep_kernel<T, kPacked, kPrefetch, kQuant>;
    auto tail = prune_scan_tail_kernel<T, kPacked, kPrefetch, kQuant>;
    if (n_tiles > 1) {
      int cap = 0;
      err = tail_blocks(cache, tail, g.lanes / tail_lanes<kPacked>(), g.smem, &cap);
      if (err != cudaSuccess) return err;
      g.tail_blocks = std::max(1, std::min<int>(cap, g.grid.x * g.grid.y));
    }
    if (out != nullptr) *out = g;
    if (!go) return cudaSuccess;
    CUtensorMap map;
    err = cached_tile_map<T>(cache, &map, x, args.P, args.Drows, args.V, g.lanes, g.rows);
    if (err != cudaSuccess) return err;
    BulkArgs a = args;
    a.lanes = g.lanes;
    a.rows = g.rows;
    a.stage_bytes = g.stage_bytes;
    a.stages = 1;
    a.t_lo = 0;
    a.t_hi = 1;
    sweep<<<g.grid, g.lanes / kLanes, g.smem_sweep, stream>>>(map, ids, a);
    if (n_tiles > 1) {
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      a.stages = kTailStages;
      a.t_lo = 1;
      a.t_hi = n_tiles;
      tail<<<g.tail_blocks, g.lanes / tail_lanes<kPacked>(), g.smem, stream>>>(map, a);
    }
    return cudaGetLastError();
  }
  if (out != nullptr) *out = g;
  if (!go) return cudaSuccess;
  auto kernel = prune_scan_multi_kernel<T, kPacked, kPrefetch>;
  if (g.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)g.smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<g.grid, kThreads, g.smem, stream>>>(
      static_cast<const T*>(x), ids, args.q, args.thr, args.scale, args.offset, args.dists,
      args.alive, args.streamed, args.Drows, args.V, args.dim, args.d_tile, args.eps0, kQuant);
  return cudaGetLastError();
}

// plan() for a dtype code (0 f32, 1 bf16, 2 int8, 3 packed int4).
template <bool kPrefetch>
cudaError_t dispatch(const void* x, int dtype, const int* ids, const BulkArgs& args, bool quant,
                     bool go, Geometry* out, cudaStream_t s) {
  switch (dtype) {
    case 0:
      return quant ? plan<float, false, kPrefetch, true>(x, ids, args, go, out, s)
                   : plan<float, false, kPrefetch, false>(x, ids, args, go, out, s);
    case 1:
      return quant ? plan<__nv_bfloat16, false, kPrefetch, true>(x, ids, args, go, out, s)
                   : plan<__nv_bfloat16, false, kPrefetch, false>(x, ids, args, go, out, s);
    case 2:
      return quant ? plan<int8_t, false, kPrefetch, true>(x, ids, args, go, out, s)
                   : plan<int8_t, false, kPrefetch, false>(x, ids, args, go, out, s);
    case 3:
      return plan<uint8_t, true, kPrefetch, true>(x, ids, args, go, out, s);
    default:
      return cudaErrorInvalidValue;
  }
}

BulkArgs bulk_args(const float* q, const float* thr, const float* scale, const float* offset,
                   float* dists, bool* alive, float* streamed, int P, int Drows, int V, int dim,
                   int d_tile, float eps0) {
  BulkArgs a{};
  a.q = q;
  a.thr = thr;
  a.scale = scale;
  a.offset = offset;
  a.dists = dists;
  a.alive = alive;
  a.streamed = streamed;
  a.P = P;
  a.Drows = Drows;
  a.V = V;
  a.dim = dim;
  a.d_tile = d_tile;
  a.eps0 = eps0;
  return a;
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
  const BulkArgs a = bulk_args(q, thr, scale, offset, dists, alive, nullptr, P, Drows, V, dim,
                               d_tile, eps0);
  return dispatch<false>(x, dtype, ids, a, quantized != 0, true, nullptr,
                         static_cast<cudaStream_t>(stream));
}

// K3: as K1, plus `streamed` (P,) f32, which the caller zeroes.
extern "C" int pdx_prune_scan_multi_prefetch(const void* x, int dtype, const int* ids,
                                             const float* q, const float* thr,
                                             const float* scale, const float* offset,
                                             float* dists, bool* alive, float* streamed, int P,
                                             int Drows, int V, int dim, int d_tile, float eps0,
                                             int quantized, void* stream) {
  const BulkArgs a = bulk_args(q, thr, scale, offset, dists, alive, streamed, P, Drows, V, dim,
                               d_tile, eps0);
  return dispatch<true>(x, dtype, ids, a, quantized != 0, true, nullptr,
                        static_cast<cudaStream_t>(stream));
}

// The launch shape K1 (prefetch 0) or K3 (1) takes for a mirror (dtype as
// above) at dim, d_tile and quantized, by the rule the launch follows;
// launches nothing.  out[0] 1 for the bulk body, 0 for the direct one;
// out[1] lanes per block; out[2] blocks (bulk: of the sweep launch);
// out[3] dynamic shared memory per block, bytes (bulk: of the tail
// launch); out[4] d-tiles of look-ahead after a block's first vote;
// out[5] shared memory per block of the bulk sweep launch (direct: out[3]);
// out[6] blocks of the bulk tail launch (0 where there is none).
extern "C" int pdx_prune_scan_multi_geometry(const void* x, int dtype, int P, int Drows, int V,
                                             int dim, int d_tile, int quantized, int prefetch,
                                             int* out) {
  const BulkArgs a = bulk_args(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, P,
                               Drows, V, dim, d_tile, 0.f);
  Geometry g{};
  const cudaError_t err =
      prefetch ? dispatch<true>(x, dtype, nullptr, a, quantized != 0, false, &g, nullptr)
               : dispatch<false>(x, dtype, nullptr, a, quantized != 0, false, &g, nullptr);
  if (err != cudaSuccess) return (int)err;
  out[0] = g.bulk;
  out[1] = g.lanes;
  out[2] = (int)(g.grid.x * g.grid.y);
  out[3] = (int)g.smem;
  out[4] = g.bulk ? kTailStages - 1 : 0;
  out[5] = (int)g.smem_sweep;
  out[6] = g.tail_blocks;
  return 0;
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
