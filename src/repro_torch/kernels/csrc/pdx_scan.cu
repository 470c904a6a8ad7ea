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
// of T, 1-3 flops a value).  Each thread owns kStreamLanes consecutive
// lanes and walks all D rows (stream_rows), so a warp reads 256
// consecutive lanes of a row in 16-byte vectors: loads are coalesced along
// V, the tile's contiguous axis, and no lane ever needs another's sum (no
// cross-thread reduction, the point of the layout).  The loads of
// kStreamAhead rows are written before their sums, which run row by row.
// q sits in shared memory.  Where V is not a multiple of the vector width,
// or the base is unaligned, the loads are scalar.  The lanes a thread and
// the rows ahead were chosen by timing candidates on the H100 (PERF.md).
//
// K6: one partition's fused L2 scan with the ADSampling test per d-tile.
//
// Replaces the TPU kernel src/repro/kernels/pdx_scan.py:
// pdx_prune_scan_pallas (body _prune_scan_kernel).  Plain version:
// repro_torch/kernels/ref.py:pdx_prune_scan_ref.  T (D, V) f32 | bf16,
// ids (V,) int32 or null (every lane real), q (D,) f32, thr one f32 on the
// device -> dists (V,) f32, alive (V,) bool; K1's test, at
// d_seen = min((t+1) * d_tile, D): the operands are not padded, so every
// stored dimension is a logical one.  A dead lane keeps its partial
// distance, a PAD lane (ids < 0) reports 0 and dead.
// Bound on an H100: bytes, of d-tile 0 over every lane and then of the
// 32-byte sectors (8 f32 or 16 bf16 lanes of a row) that hold a lane alive
// entering each later d-tile.  After d-tile 0 only a few percent of the
// lanes live, scattered over V, so a block of consecutive lanes would walk
// every d-tile for a handful of them, each thread waiting on its own few
// rows.  The paper's PDXearch keeps a list of the positions still alive
// after its warm-up; here that list is built on the card, in a workspace
// the wrapper allocates (kPrefix).  Three steps on the stream, one
// wrapper call:
//   * the workspace's counters are zeroed;
//   * the sweep of d-tile 0 over all V lanes: K4's streaming body
//     (stream_rows) with the test after it.  It writes every lane's dists
//     and alive, and each block writes its surviving lanes, in lane order,
//     as its segment of the list (a block scan, no atomics); the last block
//     to finish turns the segments' lengths into offsets;
//   * where there are more d-tiles, a persistent tail of one block an SM
//     (the host never reads the list's length).  A warp takes up to 32
//     consecutive entries (one atomicAdd on the cursor; a binary search of
//     the offsets, through the read-only cache, finds each entry), so a
//     warp's lanes are neighbours in V and share DRAM pages and sectors
//     where they can.  Per d-tile a lane issues that tile's row gathers (up to kGather
//     in flight) before it sums them, tests, and a lane that died or
//     finished writes its dists and alive back and takes the warp's next
//     entry (ballot), so warps stay full as lanes die.  Lanes of one warp
//     may be at different d-tiles: q sits in shared memory by d-tile, each
//     padded to a stride of 1 mod 32 words, so their reads hit different
//     banks.
// Measured on the H100 (PERF.md): the sweep streams at K4's rate; the tail
// gathers scattered 32-byte sectors at about a third of the card's
// streaming rate.
// Per tile the sums run in K1's order (same term, from 0, rows in order,
// then into acc) and the test uses the same f32 scalars, so on one
// partition K6 and K1 give equal masks.  A lane's arithmetic does not
// depend on which warp takes it, so no output depends on the schedule.
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

// ------------------------------------------- K4 and K6's sweep: streaming rows
// A streaming thread reads kStreamLanes consecutive lanes of each row (16
// bytes at bf16, 32 at f32) and issues the loads of kStreamAhead rows
// before it sums the first.
constexpr int kStreamLanes = 8;
constexpr int kStreamAhead = 16;

// The N lanes at p (aligned) of one row as 32-bit words, in 16-byte vectors.
template <typename T, int N>
__device__ __forceinline__ void load_words(const T* p, uint32_t w[N * sizeof(T) / 4]) {
  constexpr int kBytes = N * (int)sizeof(T);
  static_assert(kBytes % 16 == 0, "whole 16-byte vectors a row");
#pragma unroll
  for (int c = 0; c < kBytes / 16; ++c) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[c];
    w[4 * c] = u.x;
    w[4 * c + 1] = u.y;
    w[4 * c + 2] = u.z;
    w[4 * c + 3] = u.w;
  }
}

// Words of stored values -> the N lanes as floats (bf16: exact, the low
// half of a word is the lower lane).
template <typename T, int N>
__device__ __forceinline__ void words_to_floats(const uint32_t* w, float x[N]) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = __uint_as_float(w[j]);
  } else {
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xFFFF0000u);
    }
  }
}

// acc[j] = step(acc[j], x, q_r) over rows [0, rows) of the thread's N lanes
// [v0, v0 + N), in row order, q_r = sq[r].  `vec`: the N lanes are in
// range and their row segments aligned to the vector width; else scalar
// loads (a lane past V reads 0 and is never stored).
template <typename T, typename Step>
__device__ __forceinline__ void stream_rows(const T* x, int V, int v0, bool vec, int rows,
                                            const float* sq, float acc[kStreamLanes], Step step) {
  constexpr int N = kStreamLanes, kAhead = kStreamAhead;
  constexpr int kWords = N * (int)sizeof(T) / 4;
  const int64_t stride = V;
  const T* p = x + v0;
  int r = 0;
  if (vec) {
    for (; r + kAhead <= rows; r += kAhead, p += kAhead * stride) {
      uint32_t w[kAhead][kWords];
#pragma unroll
      for (int k = 0; k < kAhead; ++k) load_words<T, N>(p + k * stride, w[k]);
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        float xv[N];
        words_to_floats<T, N>(w[k], xv);
        const float qv = sq[r + k];
#pragma unroll
        for (int j = 0; j < N; ++j) acc[j] = step(acc[j], xv[j], qv);
      }
    }
    for (; r < rows; ++r, p += stride) {
      uint32_t w[kWords];
      load_words<T, N>(p, w);
      float xv[N];
      words_to_floats<T, N>(w, xv);
      const float qv = sq[r];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = step(acc[j], xv[j], qv);
    }
  } else {
    for (; r < rows; ++r, p += stride) {
      const float qv = sq[r];
#pragma unroll
      for (int j = 0; j < N; ++j) acc[j] = step(acc[j], v0 + j < V ? to_f32(p[j]) : 0.f, qv);
    }
  }
}

// True where a streaming thread's lanes can be read as vectors: the base
// and every row segment 16-byte aligned.
template <typename T>
bool stream_aligned(const void* x, int V) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && (int64_t)V * sizeof(T) % 16 == 0;
}

// The thread's N floats at out + v0, as vectors where all N are in range.
template <int N>
__device__ __forceinline__ void store_floats(float* out, int v0, int V, const float v[N]) {
  if (v0 + N <= V) {
#pragma unroll
    for (int c = 0; c < N / 4; ++c) {
      reinterpret_cast<float4*>(out + v0)[c] =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (v0 + j < V) out[v0 + j] = v[j];
    }
  }
}

// ------------------------------------------------------------------ K4
template <typename T, int kMetric>
__global__ void __launch_bounds__(kThreads)
pdx_distance_kernel(const T* __restrict__ x, const float* __restrict__ q,
                    float* __restrict__ out, int D, int V, bool aligned) {
  constexpr int N = kStreamLanes;
  extern __shared__ float sq[];
  for (int i = threadIdx.x; i < D; i += blockDim.x) sq[i] = q[i];
  __syncthreads();
  const int v0 = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  if (v0 >= V) return;
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  stream_rows<T>(x, V, v0, aligned && v0 + N <= V, D, sq, acc,
                 [](float a, float xv, float qv) { return a + term<kMetric>(xv, qv); });
  if constexpr (kMetric == kIP) {
#pragma unroll
    for (int j = 0; j < N; ++j) acc[j] = -acc[j];
  }
  store_floats<N>(out, v0, V, acc);
}

// Opts `kernel` in to `smem` bytes of dynamic shared memory where that is
// more than the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int kMetric>
cudaError_t launch_distance(const void* x, const float* q, float* out, int D, int V,
                            cudaStream_t stream) {
  const size_t smem = (size_t)D * sizeof(float);
  auto kernel = pdx_distance_kernel<T, kMetric>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int lanes_per_block = kThreads * kStreamLanes;
  kernel<<<(V + lanes_per_block - 1) / lanes_per_block, kThreads, smem, stream>>>(
      static_cast<const T*>(x), q, out, D, V, stream_aligned<T>(x, V));
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
// The workspace, int32: [0] the list's length, [1] the tail's cursor, [2]
// the sweep blocks done, then (kPrefix) nb + 1 offsets, entry b the list's
// entries before segment b, then (list_at) the list: sweep block b's
// survivors (its segment), in lane order, from b * kSegment.
constexpr int kPrefix = 3;
constexpr int kSegment = kThreads * kStreamLanes;  // lanes of a sweep block, a segment
constexpr int kTailThreads = 128;  // threads of a tail block
constexpr int kTailBlocksPerSM = 1;  // 4 warps an SM take the list's entries
constexpr int kGather = 64;        // rows of one lane's gathers in flight

__host__ __device__ constexpr int n_segments(int V) { return (V + kSegment - 1) / kSegment; }
__host__ __device__ constexpr int64_t list_at(int V) { return kPrefix + n_segments(V) + 1; }

// One row's term of a lane's tile sum, as K1 adds it: (x - q)^2 fused into
// the sum (the contraction nvcc makes of K1's sq_dev; spelled out so that
// no select or reordering around it can split the product from the add).
__device__ __forceinline__ float l2_step(float c, float x, float qv) {
  const float d = x - qv;
  return __fmaf_rn(d, d, c);
}

// The test after a d-tile, K1's scalars: alive while
// acc * (D / d_seen) <= thr * (1 + eps0 / sqrt(d_seen))^2.
__device__ __forceinline__ bool keep(float acc, int d_seen, int D, float thr, float eps0) {
  const float fd = (float)d_seen;
  const float ratio = (float)D / fd;
  const float s = 1.f + eps0 / sqrtf(fd);
  const float bound = thr * (s * s);
  return acc * ratio <= bound;
}

// The exclusive prefix of x over the block's threads (in thread order);
// *total gets the block's sum.  Every thread of the block calls it.
__device__ __forceinline__ int block_scan(int x, int* total) {
  __shared__ int warp_total[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  int incl = x;  // inclusive prefix over the warp's threads
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_total[w] : 0;
    sum += warp_total[w];
  }
  __syncthreads();  // warp_total is free for the next call
  *total = sum;
  return before + incl - x;
}

// Writes the block's live lanes (the thread's N lanes from v0) as its
// segment of the list, in lane order, and its length as offset b + 1; the
// last block to finish turns the lengths into the offsets and sets the
// list's length.  Every thread of the block calls it.
template <int N>
__device__ __forceinline__ void append_survivors(const bool live[N], int v0, int V, int* ws) {
  __shared__ bool last;
  int mine = 0;
#pragma unroll
  for (int j = 0; j < N; ++j) mine += live[j];
  int total = 0;
  int pos = blockIdx.x * kSegment + block_scan(mine, &total);
  int* list = ws + list_at(V);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (live[j]) list[pos++] = v0 + j;
  }
  int* offsets = ws + kPrefix;
  if (threadIdx.x == 0) {
    offsets[blockIdx.x + 1] = total;
    __threadfence();  // the length is visible before the block counts as done
    last = atomicAdd(ws + 2, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // every block's length is in: offsets[b] = lengths before b, in place
  __threadfence();
  int carry = 0;
  for (int b0 = 0; b0 < (int)gridDim.x; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    const int len = b < (int)gridDim.x ? __ldcg(offsets + b + 1) : 0;
    int chunk = 0;
    const int before = block_scan(len, &chunk);
    if (b < (int)gridDim.x) offsets[b + 1] = carry + before + len;
    carry += chunk;
  }
  if (threadIdx.x == 0) {
    offsets[0] = 0;
    ws[0] = carry;
  }
}

// The sweep: d-tile 0 (`rows` rows) of every lane, K4's streaming body;
// writes every lane's dists and alive and appends the survivors.
template <typename T>
__global__ void __launch_bounds__(kThreads)
prune_sweep_kernel(const T* __restrict__ x, const int* __restrict__ ids,
                   const float* __restrict__ q, const float* __restrict__ thr_ptr,
                   float* __restrict__ dists, bool* __restrict__ alive_out, int* __restrict__ ws,
                   int D, int V, int rows, float eps0, bool aligned) {
  constexpr int N = kStreamLanes;
  extern __shared__ float sq[];
  for (int i = threadIdx.x; i < rows; i += blockDim.x) sq[i] = q[i];
  __syncthreads();
  const int v0 = (blockIdx.x * blockDim.x + threadIdx.x) * N;
  float acc[N];
  bool live[N];
  bool any = false;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    acc[j] = 0.f;
    live[j] = v0 + j < V && (ids == nullptr || ids[v0 + j] >= 0);
    any |= live[j];
  }
  if (any) {  // a thread of PAD lanes reads nothing
    float c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = 0.f;
    stream_rows<T>(x, V, v0, aligned && v0 + N <= V, rows, sq, c,
                   [](float a, float xv, float qv) { return l2_step(a, xv, qv); });
    const float thr = *thr_ptr;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (live[j]) {
        acc[j] += c[j];
        live[j] = keep(acc[j], rows, D, thr, eps0);
      }
    }
  }
  if (v0 < V) {
    store_floats<N>(dists, v0, V, acc);
    if (v0 + N <= V) {
#pragma unroll
      for (int c = 0; c < N / 4; ++c) {
        reinterpret_cast<uchar4*>(alive_out + v0)[c] =
            make_uchar4(live[4 * c], live[4 * c + 1], live[4 * c + 2], live[4 * c + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (v0 + j < V) alive_out[v0 + j] = live[j];
      }
    }
  }
  append_survivors<N>(live, v0, V, ws);
}

// The segment holding list entry i: the last b < nb with offsets[b] <= i
// (offsets[0] = 0 <= i < offsets[nb], the list's length).  The sweep wrote
// the offsets before this launch, so they go through the read-only cache.
__device__ __forceinline__ int segment_of(const int* offsets, int nb, int i) {
  int lo = 0, hi = nb;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (__ldg(offsets + mid) <= i) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The tail: d-tiles 1.. of the listed lanes, one lane a thread.  A warp
// takes up to 32 consecutive entries of the list (the cursor; neighbours
// in lane order), each lane resuming from the sweep's dists; per d-tile a
// lane loads up to kGather rows before it sums them (K1's order: from 0,
// row by row, then into acc), tests, and a lane that died or finished
// writes its dists and alive and takes the warp's next entry.  Shared
// memory: q by d-tile (dim d_lo + k of tile t at t * q_stride + k).
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
prune_tail_kernel(const T* __restrict__ x, const float* __restrict__ q,
                  const float* __restrict__ thr_ptr, float* __restrict__ dists,
                  bool* __restrict__ alive_out, int* __restrict__ ws, int D, int V, int d_tile,
                  int q_stride, float eps0) {
  extern __shared__ float sq[];
  const int count = ws[0];
  if (count == 0) return;  // block-uniform: nothing survived d-tile 0
  const int n_tiles = (D + d_tile - 1) / d_tile;
  const int nb = n_segments(V);
  for (int i = threadIdx.x; i < D; i += blockDim.x) sq[(i / d_tile) * q_stride + i % d_tile] = q[i];
  __syncthreads();
  const int* offsets = ws + kPrefix;
  const float thr = *thr_ptr;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int* cursor = ws + 1;
  const int* list = ws + list_at(V);
  int v = -1, t = 0;  // the lane's entry (-1: none) and its next d-tile
  float acc = 0.f;
  bool more = true;   // the list may hold entries not yet taken (warp-uniform)
  while (true) {
    if (more) {
      const unsigned empty = __ballot_sync(0xFFFFFFFFu, v < 0);
      const int n = __popc(empty);
      if (n > 0) {
        int base = 0;
        if (lane == 0) base = atomicAdd(cursor, n);
        base = __shfl_sync(0xFFFFFFFFu, base, 0);
        const int i = base + __popc(empty & below);  // to the empty lanes in order
        if (v < 0 && i < count) {
          const int b = segment_of(offsets, nb, i);
          v = list[(int64_t)b * kSegment + i - __ldg(offsets + b)];
          acc = dists[v];
          t = 1;
        }
        more = base + n < count;
      }
    }
    if (__ballot_sync(0xFFFFFFFFu, v >= 0) == 0u) break;
    if (v >= 0) {
      const int r0 = t * d_tile, r1 = min(r0 + d_tile, D);
      const float* qt = sq + t * q_stride - r0;  // qt[r], r in [r0, r1)
      float c = 0.f;
      for (int i0 = r0; i0 < r1; i0 += kGather) {
        // every load unconditional (rows past the tile repeat its last
        // one), so the compiler issues all kGather before the first sum;
        // loads under `k < n` came out interleaved with the sums
        const int n = min(kGather, r1 - i0);
        const T* p = x + (int64_t)i0 * V + v;
        float xv[kGather];
#pragma unroll
        for (int k = 0; k < kGather; ++k) xv[k] = to_f32(p[(int64_t)min(k, n - 1) * V]);
#pragma unroll
        for (int k = 0; k < kGather; ++k) {
          const float qv = qt[i0 + min(k, n - 1)];
          c = k < n ? l2_step(c, xv[k], qv) : c;
        }
      }
      acc += c;
      const bool ok = keep(acc, r1, D, thr, eps0);
      if (!ok || ++t == n_tiles) {
        dists[v] = acc;
        alive_out[v] = ok;
        v = -1;
      }
    }
  }
}

// K6's launch shape, one rule for the launch and pdx_prune_scan_geometry.
struct PruneGeometry {
  int rows0;          // rows of d-tile 0
  int sweep_blocks;
  int tail_blocks;    // 0 where D fits one d-tile
  int q_stride;       // words of a d-tile's q in the tail's table
  size_t smem_sweep, smem_tail;
};

// What K6's launch of T asks of the runtime, kept per device so that a
// later call asks it nothing: the SMs, and the dynamic shared memory each
// kernel was opted in to so far (48 KB needs no opt-in).
struct PruneDevice {
  int device, sms;
  size_t sweep_smem, tail_smem;
};

// The current device's SMs, with both K6 kernels of T opted in to at least
// g's shared memory there.
template <typename T>
cudaError_t prune_device(const PruneGeometry& g, int* sms) {
  static std::mutex mu;
  static std::vector<PruneDevice> seen;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  PruneDevice* e = nullptr;
  for (PruneDevice& d : seen) {
    if (d.device == device) e = &d;
  }
  if (e == nullptr) {
    int n = 0;
    if ((err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
      return err;
    }
    seen.push_back({device, n, 48 * 1024, 48 * 1024});
    e = &seen.back();
  }
  if (g.smem_sweep > e->sweep_smem) {
    if ((err = allow_smem(prune_sweep_kernel<T>, g.smem_sweep)) != cudaSuccess) return err;
    e->sweep_smem = g.smem_sweep;
  }
  if (g.smem_tail > e->tail_smem) {
    if ((err = allow_smem(prune_tail_kernel<T>, g.smem_tail)) != cudaSuccess) return err;
    e->tail_smem = g.smem_tail;
  }
  *sms = e->sms;
  return cudaSuccess;
}

template <typename T>
cudaError_t prune_plan(int D, int V, int d_tile, PruneGeometry* g) {
  const int n_tiles = (D + d_tile - 1) / d_tile;
  g->rows0 = std::min(d_tile, D);
  g->sweep_blocks = n_segments(V);
  g->q_stride = d_tile % 32 == 0 ? d_tile + 1 : d_tile;
  g->smem_sweep = (size_t)g->rows0 * sizeof(float);
  g->smem_tail = (size_t)n_tiles * g->q_stride * sizeof(float);
  int sms = 0;
  const cudaError_t err = prune_device<T>(*g, &sms);
  g->tail_blocks = n_tiles > 1 ? kTailBlocksPerSM * sms : 0;
  return err;
}

template <typename T>
cudaError_t launch_prune(const void* x, const int* ids, const float* q, const float* thr,
                         float* dists, bool* alive, int* ws, int D, int V, int d_tile,
                         float eps0, cudaStream_t stream) {
  PruneGeometry g;
  cudaError_t err = prune_plan<T>(D, V, d_tile, &g);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(ws, 0, kPrefix * sizeof(int), stream)) != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  prune_sweep_kernel<T><<<g.sweep_blocks, kThreads, g.smem_sweep, stream>>>(
      xt, ids, q, thr, dists, alive, ws, D, V, g.rows0, eps0, stream_aligned<T>(x, V));
  if (g.tail_blocks > 0) {
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    prune_tail_kernel<T><<<g.tail_blocks, kTailThreads, g.smem_tail, stream>>>(
        xt, q, thr, dists, alive, ws, D, V, d_tile, g.q_stride, eps0);
  }
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

// Bytes of K6's workspace for V lanes: the list's length, the tail's
// cursor, the sweep's done count, the segments' offsets and the list
// (int32 each; see kPrefix); -1 where that passes 2^31.
extern "C" int pdx_prune_scan_workspace_bytes(int V) {
  const int64_t bytes = (list_at(V) + V) * (int64_t)sizeof(int);
  return bytes > INT32_MAX ? -1 : (int)bytes;
}

// K6.  dtype: 0 f32, 1 bf16; ids may be null (every lane real); workspace:
// pdx_prune_scan_workspace_bytes(V) bytes on the device, any contents.
// After the call workspace[0] (int32) is the lanes alive after d-tile 0,
// and the list holds them (kPrefix).
extern "C" int pdx_prune_scan(const void* x, int dtype, const int* ids, const float* q,
                              const float* thr, float* dists, bool* alive, void* workspace, int D,
                              int V, int d_tile, float eps0, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* ws = static_cast<int*>(workspace);
  switch (dtype) {
    case 0:
      return launch_prune<float>(x, ids, q, thr, dists, alive, ws, D, V, d_tile, eps0, s);
    case 1:
      return launch_prune<__nv_bfloat16>(x, ids, q, thr, dists, alive, ws, D, V, d_tile, eps0,
                                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K6's launch shape for a (D, V) partition (dtype as above) at d_tile, by
// the rule the launch follows; launches nothing.  out[0] lanes a sweep
// thread; out[1] sweep blocks; out[2] tail blocks (0: no tail); out[3]
// tail threads a block; out[4], out[5] dynamic shared memory of a sweep and
// a tail block, bytes; out[6] rows a tail lane gathers at once; out[7]
// lanes of a sweep block (a segment of the list).
extern "C" int pdx_prune_scan_geometry(int dtype, int D, int V, int d_tile, int* out) {
  PruneGeometry g{};
  cudaError_t err = dtype == 0   ? prune_plan<float>(D, V, d_tile, &g)
                    : dtype == 1 ? prune_plan<__nv_bfloat16>(D, V, d_tile, &g)
                                 : cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  out[0] = kStreamLanes;
  out[1] = g.sweep_blocks;
  out[2] = g.tail_blocks;
  out[3] = kTailThreads;
  out[4] = (int)g.smem_sweep;
  out[5] = (int)g.smem_tail;
  out[6] = kGather;
  out[7] = kSegment;
  return 0;
}

extern "C" const char* pdx_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
