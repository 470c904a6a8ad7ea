// K2 and K7: batched query-vs-tile distances on Hopper's tensor cores.
//
// K2 replaces the TPU kernel src/repro/kernels/batched_matmul.py:
// batched_distance_quant_pallas (body _bmm_quant_kernel).  Contract (plain
// version: repro_torch/kernels/ref.py:batched_distance_quant_ref):
//   T (P, D, V) f32 | bf16 | int8 mirror tiles, or int4 levels packed two
//   dims a byte (P, ceil(D/2), V), queries (B, D) f32, qn (B,) = ||q||^2,
//   scale/offset (D,) f32.  Out (B, P*V) f32, column p*V + v, every column
//   written (PAD columns too):
//       l2: ||q||^2 - 2 q.x^ + ||x^||^2     ip: -q.x^
//   with x^ = x*scale + offset (int8/int4) or x upcast (f32/bf16).  The tile norm
//   ||x^||^2 is summed in f32 beside the product while the values pass
//   through registers, so every stored byte is read once.
//
// K7 replaces batched_matmul.py:batched_distance_pallas (body _bmm_kernel),
// plain version ref.py:batched_distance_ref: one f32 or bf16 (D, V) tile,
// f32 or bf16 queries, qn (B,) and xn (V,) given (computed outside, as the
// TPU kernel's wrapper computes them outside pallas_call).  It is the same
// template with the norms read instead of summed.
//
// What bounds it on an H100: at B = 64 the product is 2*64*D flops per
// column against 1-4 bytes per tile value, so on the SIMT cores (67
// TFLOP/s f32) operations bound it; on the tensor cores memory does.  The
// product runs through wgmma in an exact bf16 split, as accurate as f32:
//   * the queries are split into bf16 planes q = q1 + q2 + q3, each the
//     bf16 rounding of what the ones before left (exact: three bf16 carry
//     all 24 significant bits of an f32; plain version ref.split_bf16);
//     for a quantized mirror the scale is folded in first, q.x^ =
//     (q*s).x + q.o, so the int8 levels go in as they are and q.o is one
//     f32 per query (ref.fold_scale).  A small first kernel
//     (split_queries) does this once per call into a workspace that the
//     caller allocates (batched_matmul_workspace_bytes): splitting in the
//     main kernel's stages instead made every block redo it for each of
//     its tiles, and took K2 0.4-1.1 ms longer on an H100;
//   * a bf16 tile and int8 levels are exact in bf16: one plane, so each
//     product q_i * x is exact and only the f32 sums round, as on the SIMT
//     cores: 3 passes;
//   * an f32 tile is split the same way, as it passes through the
//     consumers, x = x1 + x2 + x3, and the six products q_i x_j with
//     i + j <= 2 are summed (the three dropped terms are below 2^-24 of
//     the product, finer than 3xTF32); bf16 queries (K7, given as their
//     f32 values) are one plane.
// Passes are summed smallest first.  Plain TF32 is not used: it flips
// near-tie ids in the cancelling l2 form.
//
// Layout: a block owns 64 queries (one wgmma M-tile; B > 64 takes more
// tiles, B < 64 reads zero rows) x 256 lanes of one partition.  Both
// operands sit in shared memory
// MN-major with the 128-byte swizzle: a row is 64 bf16 of the query or
// lane axis and rows run along D, which is how the PDX tile (D, V) is
// stored, so the tile feeds wgmma through its transpose bit with no
// relayout.  A stage holds BK dims: 32, or 16 for an f32 tile (three
// planes).  Three warpgroups:
//   * the producer warpgroup only copies: a ring of up to 8 stages, each
//     the stage's query planes (dim-major, 64 queries a row), the tile rows
//     and, for a quantized mirror, the rows' scale and offset, all by
//     cp.async (16-byte copies, 8 for int8, zero-filled past D and V) that
//     arrive on the stage's mbarrier as they land.  A bf16 tile is copied
//     straight into wgmma's layout.  Rows whose copies would not be
//     aligned (V not a multiple of 8 values, or 4 at f32) are loaded value
//     by value instead;
//   * two consumer warpgroups, each owning 128 lanes: per stage they
//     convert their lanes of the tile (int8 or int4 -> bf16; f32 -> three
//     planes) into a 2-stage operand ring, summing the column norms on
//     the way, then issue m64n128k16 wgmma and leave it running
//     while they convert the next stage; a stage goes back to the producer
//     once the wgmma that read it is done.
// Ragged edges are zero-filled in shared memory (a dim past D adds nothing
// to the product or the norm; a lane past V is not written).  The epilogue
// adds qn, the norms and qo and writes whole f32 rows of 128 lanes, staged
// through shared memory.  Blocks are persistent (one per SM), and the copy
// ring runs on across their tiles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mbarrier.cuh"

namespace {

constexpr int kBN = 256;           // lanes per block: 2 consumer warpgroups x 128
constexpr int kAtoms = kBN / 64;   // 64-lane swizzle atoms in a tile plane
constexpr int kThreads = 384;      // consumers: threads 0-255, producer: 256-383
constexpr int kRow = 128;          // bytes of a shared-memory row (64 bf16)
constexpr int kPlaneStages = 2;    // converted tile planes handed to wgmma
constexpr int kMaxRaw = 8;         // copy stages in flight, at most
constexpr int kBudget = 218 * 1024;  // dynamic shared memory, alignment included

// Asynchronous copies global -> shared of 16 or 8 bytes; in == false
// writes zeros instead (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src),
               "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// The mbarrier receives one arrival when this thread's earlier cp.async
// copies have landed: counted among its expected arrivals (noinc), or on
// top of them.
__device__ __forceinline__ void cp_async_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint4 lds16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ uint2 lds8(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_shared8(uint32_t dst, uint2 v) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(dst), "r"(v.x), "r"(v.y) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// Shared-memory matrix descriptor: 128-byte swizzle, MN-major.  lbo is the
// step between 64-element atoms of the M/N axis, the stride (8-row groups
// along K) is 1024 bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void acc_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A (64 x 16, MN-major) * B (16 x 128, MN-major) + (add ? d : 0), bf16
// in, f32 out.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 uint32_t add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(add));
}

// Eight consecutive lanes of one tile row, as stored.
template <typename T>
struct Unit;
template <>
struct Unit<float> {
  float v[8];
};
template <>
struct Unit<__nv_bfloat16> {
  uint4 w;
};
template <>
struct Unit<int8_t> {
  uint2 w;
};
template <>  // packed int4: two dims a byte, the even one in the low nibble
struct Unit<uint8_t> {
  uint2 w;
};

// Eight f32 values -> N bf16 planes, 8 values each (the first in the low
// half): plane j is the bf16 rounding of what planes 0 ... j-1 left, an
// exact f32 difference, so three planes sum exactly to the values and one
// plane is exact for bf16 values (ref.split_bf16).
template <int N>
__device__ __forceinline__ void split(const float (&v)[8], uint4 (&pl)[N]) {
  float r[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) r[e] = v[e];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
      r[2 * i] = __fsub_rn(r[2 * i], __low2float(b));
      r[2 * i + 1] = __fsub_rn(r[2 * i + 1], __high2float(b));
    }
    pl[j] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Two bf16 from the high halves of two f32 bit patterns (exact where the
// values have at most 8 significant bits): lo in the low half.
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

// A unit's values as f32 (for the norms) and as its bf16 planes.
__device__ __forceinline__ void unpack(const Unit<float>& u, float (&v)[8], uint4 (&pl)[3]) {
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = u.v[e];
  split(v, pl);
}

__device__ __forceinline__ void unpack(const Unit<__nv_bfloat16>& u, float (&v)[8],
                                       uint4 (&pl)[1]) {
  const uint32_t w[4] = {u.w.x, u.w.y, u.w.z, u.w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
  }
  pl[0] = u.w;
}

// Byte b of w, sign-extended (prmt's sign-replicating selectors).
__device__ __forceinline__ int sext_byte(uint32_t w, int b) {
  const uint32_t sel = b | (b | 8) << 4 | (b | 8) << 8 | (b | 8) << 12;
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(sel));
  return static_cast<int>(r);
}

// int8 levels: 1.5 * 2^23 + l is exact in f32, so one integer and one
// float add convert a level, and its bf16 is the top half of its f32.
__device__ __forceinline__ void unpack(const Unit<int8_t>& u, float (&v)[8], uint4 (&pl)[1]) {
  const uint32_t w[2] = {u.w.x, u.w.y};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int l = sext_byte(w[e / 4], e % 4);
    v[e] = __int_as_float(0x4B400000 + l) - 12582912.f;
  }
  pl[0] = make_uint4(pack_hi(__float_as_uint(v[0]), __float_as_uint(v[1])),
                     pack_hi(__float_as_uint(v[2]), __float_as_uint(v[3])),
                     pack_hi(__float_as_uint(v[4]), __float_as_uint(v[5])),
                     pack_hi(__float_as_uint(v[6]), __float_as_uint(v[7])));
}

__device__ __forceinline__ void lds_unit(uint32_t a, Unit<float>& u) {
  const uint4 lo = lds16(a), hi = lds16(a + 16);
  u.v[0] = __uint_as_float(lo.x); u.v[1] = __uint_as_float(lo.y);
  u.v[2] = __uint_as_float(lo.z); u.v[3] = __uint_as_float(lo.w);
  u.v[4] = __uint_as_float(hi.x); u.v[5] = __uint_as_float(hi.y);
  u.v[6] = __uint_as_float(hi.z); u.v[7] = __uint_as_float(hi.w);
}

__device__ __forceinline__ void lds_unit(uint32_t a, Unit<__nv_bfloat16>& u) { u.w = lds16(a); }

__device__ __forceinline__ void lds_unit(uint32_t a, Unit<int8_t>& u) { u.w = lds8(a); }

__device__ __forceinline__ void lds_unit(uint32_t a, Unit<uint8_t>& u) { u.w = lds8(a); }

// Packed int4: the unit's two dims, levels nibble - 8 (exact in bf16).
__device__ __forceinline__ void unpack_int4(const Unit<uint8_t>& u, float (&v0)[8],
                                            uint4 (&p0)[1], float (&v1)[8], uint4 (&p1)[1]) {
  const uint32_t w[2] = {u.w.x, u.w.y};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const uint32_t b = w[e / 4] >> (8 * (e % 4));
    v0[e] = __int_as_float(0x4B400000 + static_cast<int>(b & 0xF) - 8) - 12582912.f;
    v1[e] = __int_as_float(0x4B400000 + static_cast<int>((b >> 4) & 0xF) - 8) - 12582912.f;
  }
  p0[0] = make_uint4(pack_hi(__float_as_uint(v0[0]), __float_as_uint(v0[1])),
                     pack_hi(__float_as_uint(v0[2]), __float_as_uint(v0[3])),
                     pack_hi(__float_as_uint(v0[4]), __float_as_uint(v0[5])),
                     pack_hi(__float_as_uint(v0[6]), __float_as_uint(v0[7])));
  p1[0] = make_uint4(pack_hi(__float_as_uint(v1[0]), __float_as_uint(v1[1])),
                     pack_hi(__float_as_uint(v1[2]), __float_as_uint(v1[3])),
                     pack_hi(__float_as_uint(v1[4]), __float_as_uint(v1[5])),
                     pack_hi(__float_as_uint(v1[6]), __float_as_uint(v1[7])));
}

template <typename T, int NA>
struct Shape {
  static constexpr int NB = sizeof(T) == 4 ? 3 : 1;        // tile planes
  static constexpr bool kDirect = sizeof(T) == 2;         // bf16: copied as is
  static constexpr bool kPacked = std::is_same<T, uint8_t>::value;  // int4, 2 dims a row
  static constexpr int BK = sizeof(T) == 4 ? 16 : 32;     // dims per stage
  static constexpr int BKs = kPacked ? BK / 2 : BK;       // stored rows per stage
  static constexpr int kChunk = sizeof(T) == 1 ? 8 : 16;  // bytes per copy
  static constexpr int kLanes = kChunk / static_cast<int>(sizeof(T));  // lanes per copy
  static constexpr int kA = BK * kRow;                     // one query plane
  static constexpr int kB = kAtoms * BK * kRow;            // one tile plane (bf16)
  static constexpr int kX = kDirect ? kB : BKs * kBN * static_cast<int>(sizeof(T));
  static constexpr int kSO = 2 * BK * 4;                   // the rows' scale, offset
  static constexpr int kStage = (NA * kA + kX + kSO + 1023) / 1024 * 1024;
  static constexpr int kPlanes = kDirect ? 0 : kPlaneStages * NB * kB;
  static constexpr int kOut = 2 * 32 * 128 * 4;  // output staging: 32 rows per warpgroup
  static constexpr int kRawFit = (kBudget - 1024 - kPlanes - kOut) / kStage;
  static constexpr int kRaw = kRawFit < kMaxRaw ? kRawFit : kMaxRaw;
  static constexpr int kSmem = 1024 + kPlanes + kOut + kRaw * kStage;
  static_assert(kRaw >= 2, "two copy stages must fit");
};

// One copy's worth of tile lanes (4 f32 or 8 narrower values from lane n of
// row, null past the stored rows), read value by value into shared memory:
// the unaligned path.
template <typename T>
__device__ __forceinline__ void store_chunk(uint32_t dst, const T* row, int n, int V) {
  if constexpr (sizeof(T) == 4) {
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = (row != nullptr && n + e < V) ? row[n + e] : 0.f;
    st_shared16(dst, make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                                __float_as_uint(f[2]), __float_as_uint(f[3])));
  } else if constexpr (sizeof(T) == 2) {
    const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
    uint32_t h[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) h[e] = (row != nullptr && n + e < V) ? r[n + e] : 0u;
    st_shared16(dst, make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16),
                                h[4] | (h[5] << 16), h[6] | (h[7] << 16)));
  } else {
    uint32_t b[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      b[e] = (row != nullptr && n + e < V) ? static_cast<uint8_t>(row[n + e]) : 0u;
    st_shared8(dst, make_uint2(b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24),
                               b[4] | (b[5] << 8) | (b[6] << 16) | (b[7] << 24)));
  }
}

// The queries as the main kernel reads them: NA bf16 planes, (NA, n_mtiles,
// Dpad, 64), dim-major within each 64-query M-tile, zero past B and D; for
// a quantized mirror the planes are of q * scale and qo (n_mtiles * 64) =
// q.offset.  One block per M-tile: thread t splits queries 8 (t % 8) ... +7
// at dims t / 8, t / 8 + 32, ...; q.o is summed per thread, then per query
// in a fixed order.
template <int NA>
__global__ void __launch_bounds__(256)
split_queries(const float* __restrict__ q, const float* __restrict__ scale,
              const float* __restrict__ offset, __nv_bfloat16* __restrict__ qa,
              float* __restrict__ qo, int B, int D, int Dpad, int n_mtiles) {
  __shared__ float part[32][65];
  const int mt = blockIdx.x, g = threadIdx.x % 8, d0 = threadIdx.x / 8;
  float o[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int d = d0; d < Dpad; d += 32) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int m = mt * 64 + 8 * g + e;
      v[e] = m < B && d < D ? q[static_cast<int64_t>(m) * D + d] : 0.f;
    }
    if (scale != nullptr && d < D) {
      const float sc = scale[d], of = offset[d];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o[e] = fmaf(v[e], of, o[e]);
        v[e] = __fmul_rn(v[e], sc);
      }
    }
    uint4 pl[NA];
    split(v, pl);
#pragma unroll
    for (int j = 0; j < NA; ++j)
      *reinterpret_cast<uint4*>(qa + ((int64_t{j} * n_mtiles + mt) * Dpad + d) * 64 + 8 * g) =
          pl[j];
  }
  if (qo == nullptr) return;
#pragma unroll
  for (int e = 0; e < 8; ++e) part[d0][8 * g + e] = o[e];
  __syncthreads();
  if (threadIdx.x < 64) {
    float sum = 0.f;
    for (int i = 0; i < 32; ++i) sum += part[i][threadIdx.x];
    qo[mt * 64 + threadIdx.x] = sum;
  }
}

// NA query planes (3 for f32 queries, 1 for bf16); the tile's planes follow
// from T.  kQuant: x^ = x*scale + offset in the norms (the product takes
// the scale folded into the queries); kGiven: norms read from xn (K7).
// Persistent: block b takes output tiles b, b + gridDim.x, ... of the
// (M-tile, partition, lane tile) grid, and the copy ring runs on across
// them, so the next tile's first stages land during a tile's epilogue.
template <typename T, int NA, bool kQuant, bool kIP, bool kGiven>
__global__ void __launch_bounds__(kThreads, 1)
bmm_wgmma(const T* __restrict__ x, const __nv_bfloat16* __restrict__ qa,
          const float* __restrict__ qn, const float* __restrict__ qo,
          const float* __restrict__ xn, const float* __restrict__ scale,
          const float* __restrict__ offset, float* __restrict__ out, int P, int B, int D,
          int Dpad, int V, int n_ntiles, int n_mtiles, int64_t ld_out, bool vec) {
  using S = Shape<T, NA>;
  constexpr int NB = S::NB;
  constexpr int BK = S::BK;
  constexpr int R = S::kRaw;
  constexpr bool kNorms = !kIP && !kGiven;
  // Six products into one accumulator lose bits to wgmma's f32 adds, which
  // drop what falls below the running sum: an f32 tile's stage (16 dims) is
  // summed on its own and added to an f32 total in registers.
  constexpr bool kPromote = NB == 3;

  extern __shared__ uint8_t dsmem[];
  __shared__ __align__(8) uint64_t full_bar[kMaxRaw];
  __shared__ __align__(8) uint64_t empty_bar[kMaxRaw];
  __shared__ float col_norm[8][kBN];

  const uint32_t planes = (smem_u32(dsmem) + 1023u) & ~1023u;  // converted tile planes
  const uint32_t staged = planes + S::kPlanes;                  // output rows
  const uint32_t ring = staged + S::kOut;                       // copy stages
  const int tid = threadIdx.x;
  const int nk = (D + BK - 1) / BK;
  const int Ds = S::kPacked ? (D + 1) / 2 : D;  // stored rows of a partition
  const int per_m = P * n_ntiles;
  const int n_tiles = n_mtiles * per_m;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 128);
      mbar_init(smem_u32(&empty_bar[s]), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int t = tid & 127;
  const int u = t & 15;   // a consumer's 8 lanes: 8u of its warpgroup's 128
  const int r0 = t >> 4;  // and its rows r0, r0 + 8, ... of each stage
  int g = 0;              // stages through the ring so far
  if (tid >= 256) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;" ::: "memory");  // copies only
    const int64_t plane_stride = static_cast<int64_t>(n_mtiles) * Dpad * 64;
    constexpr int kPerRow = kBN / S::kLanes;  // copies per tile row
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int mt = tile / per_m, p = (tile % per_m) / n_ntiles;
      const int n0 = (tile % n_ntiles) * kBN;
      const T* xp = x + static_cast<int64_t>(p) * Ds * V;
      const __nv_bfloat16* qm = qa + static_cast<int64_t>(mt) * Dpad * 64;
      for (int s = 0; s < nk; ++s, ++g) {
        const int rs = g % R;
        if (g >= R) mbar_wait(smem_u32(&empty_bar[rs]), ((g / R) - 1) & 1);
        const uint32_t base = ring + rs * S::kStage;
        const uint32_t xs = base + NA * S::kA;
        const int k0 = s * BK;
#pragma unroll
        for (int i = 0; i < NA * BK * 8 / 128; ++i) {  // query planes, swizzled
          const int c = t + 128 * i;
          const int pl = c / (BK * 8), kr = (c / 8) % BK, ch = c % 8;
          cp_async16(base + pl * S::kA + kr * kRow + ((ch ^ (kr & 7)) << 4),
                     qm + pl * plane_stride + static_cast<int64_t>(k0 + kr) * 64 + ch * 8,
                     true);
        }
        if (kQuant && kNorms && t < 2 * BK) {  // scale, then offset, of the rows
          const int k = k0 + t % BK;
          cp_async4(xs + S::kX + 4 * t, (t < BK ? scale : offset) + (k < D ? k : 0), k < D);
        }
#pragma unroll
        for (int i = 0; i < S::BKs * kPerRow / 128; ++i) {
          const int c = t + 128 * i;
          const int kr = c / kPerRow, q = c % kPerRow;
          const int k = s * S::BKs + kr, n = n0 + q * S::kLanes;  // stored row k
          uint32_t dst;
          if constexpr (S::kDirect)  // wgmma's layout: atom q / 8, chunk q % 8
            dst = xs + (q >> 3) * (BK * kRow) + kr * kRow + (((q & 7) ^ (kr & 7)) << 4);
          else
            dst = xs + kr * (kBN * static_cast<int>(sizeof(T))) + q * S::kChunk;
          const T* row = xp + static_cast<int64_t>(k < Ds ? k : 0) * V;
          if (vec) {
            const bool in = k < Ds && n < V;
            if constexpr (S::kChunk == 16)
              cp_async16(dst, row + (in ? n : 0), in);
            else
              cp_async8(dst, row + (in ? n : 0), in);
          } else {
            store_chunk<T>(dst, k < Ds ? row : nullptr, n, V);
          }
        }
        if (vec) {
          cp_async_arrive_noinc(smem_u32(&full_bar[rs]));
        } else {  // plain stores: fenced for wgmma, released by a plain arrival
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          cp_async_arrive(smem_u32(&full_bar[rs]));
          mbar_arrive(smem_u32(&full_bar[rs]));
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;" ::: "memory");
  const int h = tid >> 7;             // lanes h*128 ... h*128 + 127 of a tile
  const int atom = 2 * h + (u >> 3);  // this thread's 8 lanes in a tile plane
  const int lane = h * 128 + 8 * u;
  const int w = (tid >> 5) & 3, l = tid & 31;
  const uint32_t out_rows = staged + h * (S::kOut / 2);
  float acc[64];
  float tot[64];  // kPromote: the f32 total
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int mt = tile / per_m, p = (tile % per_m) / n_ntiles;
    const int n0 = (tile % n_ntiles) * kBN;
    // the epilogue's operands, read early: lane i < 16 holds qn and qo of
    // the warp's i-th row (rows w + 4i), each lane the given norms of its
    // 4 lanes of the store (K7)
    float qrow = 0.f, qorow = 0.f, xg[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const int m = mt * 64 + w + 4 * (l & 15);
      if (l < 16 && m < B) {
        if (!kIP) qrow = qn[m];
        if (qo != nullptr) qorow = qo[m];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int n = n0 + h * 128 + 4 * l + c;
        if (kGiven && !kIP && n < V) xg[c] = xn[n];
      }
    }
    float nrm[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 64; ++i) (kPromote ? tot[i] : acc[i]) = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const int rs = g % R;
      const int ps = g % kPlaneStages;
      mbar_wait(smem_u32(&full_bar[rs]), (g / R) & 1);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // copies -> wgmma
      const uint32_t base = ring + rs * S::kStage;
      const uint32_t xs = base + NA * S::kA;
      const uint32_t bs = S::kDirect ? xs : planes + ps * NB * S::kB;
      if (!S::kDirect || kNorms) {
        // one row's 8 lanes, converted: into the planes, and into the norms
        auto take = [&](int kr, const float (&v)[8], const uint4 (&pl)[NB]) {
          const uint32_t sw = atom * (BK * kRow) + kr * kRow + (((u & 7) ^ (kr & 7)) << 4);
          if constexpr (!S::kDirect) {
#pragma unroll
            for (int j = 0; j < NB; ++j) st_shared16(bs + j * S::kB + sw, pl[j]);
          }
          if (kNorms && kt * BK + kr < D) {
            const float sc = kQuant ? lds_f32(xs + S::kX + 4 * kr) : 1.f;
            const float of = kQuant ? lds_f32(xs + S::kX + 4 * (BK + kr)) : 0.f;
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float tv = kQuant ? fmaf(v[e], sc, of) : v[e];
              nrm[e] = fmaf(tv, tv, nrm[e]);
            }
          }
        };
#pragma unroll
        for (int i = 0; i < S::BKs / 8; ++i) {
          const int kr = r0 + 8 * i;  // stored row of the stage
          Unit<T> un;
          if constexpr (S::kDirect)
            lds_unit(xs + atom * (BK * kRow) + kr * kRow + (((u & 7) ^ (kr & 7)) << 4), un);
          else
            lds_unit(xs + kr * (kBN * static_cast<int>(sizeof(T))) +
                         lane * static_cast<int>(sizeof(T)), un);
          if constexpr (S::kPacked) {
            float v0[8], v1[8];
            uint4 p0[1], p1[1];
            unpack_int4(un, v0, p0, v1, p1);
            take(2 * kr, v0, p0);
            take(2 * kr + 1, v1, p1);
          } else {
            float v[8];
            uint4 pl[NB];
            unpack(un, v, pl);
            take(kr, v, pl);
          }
        }
        if (!S::kDirect) {  // this warpgroup's planes are all written
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync %0, 128;" ::"r"(1 + h) : "memory");
        }
      }
      if (kPromote && kt > 0) {  // stage g - 1's sum (its conversion ran beside it)
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
        acc_fence(acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
        mbar_arrive(smem_u32(&empty_bar[(g - 1) % R]));
      }
      // a descriptor's address field counts 16 bytes: an offset within
      // shared memory adds to it without carrying out
      const uint64_t da0 = smem_desc(base, S::kA);
      const uint64_t db0 = smem_desc(bs + h * 2 * BK * kRow, BK * kRow);
      acc_fence(acc);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
      bool fresh = kPromote;  // the stage's first product starts its sum
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int sum = 2; sum >= 0; --sum) {  // smallest products first
#pragma unroll
          for (int i = 0; i < NA; ++i) {
            const int j = sum - i;
            if (j < 0 || j >= NB) continue;
            wgmma_m64n128k16(acc, da0 + ((i * S::kA + kk * 16 * kRow) >> 4),
                             db0 + ((j * S::kB + kk * 16 * kRow) >> 4), fresh ? 0u : 1u);
            fresh = false;
          }
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      if constexpr (!kPromote) {
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");  // stage g - 1 read
        acc_fence(acc);
        if (kt > 0) mbar_arrive(smem_u32(&empty_bar[(g - 1) % R]));
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    acc_fence(acc);
    if constexpr (kPromote) {
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    mbar_arrive(smem_u32(&empty_bar[(g - 1) % R]));  // the tile's last stage
    const float (&sums)[64] = kPromote ? tot : acc;
    if (kNorms) {  // the 8 row phases' partial norms, summed once per column
#pragma unroll
      for (int e = 0; e < 8; ++e) col_norm[r0][lane + e] = nrm[e];
      asm volatile("bar.sync %0, 128;" ::"r"(1 + h) : "memory");
      float sum = 0.f;
#pragma unroll
      for (int f = 0; f < 8; ++f) sum += col_norm[f][h * 128 + t];
      asm volatile("bar.sync %0, 128;" ::"r"(1 + h) : "memory");
      col_norm[0][h * 128 + t] = sum;
      asm volatile("bar.sync %0, 128;" ::"r"(1 + h) : "memory");
#pragma unroll
      for (int c = 0; c < 4; ++c) xg[c] = col_norm[0][h * 128 + 4 * l + c];
    }
    // The epilogue, 32 rows at a time through shared memory so that each
    // warp stores whole rows: acc[4j + 2r + e] is row 16w + l/4 + 8r, lane
    // 8j + 2(l%4) + e of the warpgroup's 128.  A row's 16-byte chunks are
    // swizzled by the row, so both the accumulator writes and the row
    // reads avoid bank conflicts.
    float* op = out + static_cast<int64_t>(p) * V + n0 + h * 128 + 4 * l;
    const bool vec4 = n0 + h * 128 + 4 * l + 3 < V;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if ((w >> 1) == half) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = 16 * (w & 1) + (l >> 2) + 8 * r;
            const int chunk = (2 * j + ((l & 3) >> 1)) ^ (row & 7);
            const uint32_t a = out_rows + row * 512 + chunk * 16 + (l & 1) * 8;
            asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(a),
                         "f"(sums[4 * j + 2 * r]), "f"(sums[4 * j + 2 * r + 1])
                         : "memory");
          }
        }
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + h) : "memory");
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // this warp's rows w + 4i of the 32
        const int row = w + 4 * i;
        const int m = mt * 64 + 32 * half + row;
        const float qv = __shfl_sync(0xffffffffu, qrow, 8 * half + i);
        const float qov = __shfl_sync(0xffffffffu, qorow, 8 * half + i);
        if (m >= B) continue;
        const uint4 d = lds16(out_rows + row * 512 + ((l ^ (row & 7)) << 4));
        const float dv[4] = {__uint_as_float(d.x), __uint_as_float(d.y), __uint_as_float(d.z),
                             __uint_as_float(d.w)};
        float res[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float dot = dv[c] + qov;
          res[c] = kIP ? -dot : (qv - 2.f * dot) + xg[c];
        }
        float* o = op + static_cast<int64_t>(m) * ld_out;
        if (vec4 && (reinterpret_cast<uintptr_t>(o) & 15) == 0) {
          *reinterpret_cast<float4*>(o) = make_float4(res[0], res[1], res[2], res[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n0 + h * 128 + 4 * l + c < V) o[c] = res[c];
        }
      }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + h) : "memory");  // rows read
    }
  }
}

struct Args {
  const void* x;
  const void* qa;
  const float* qn;
  const float* qo;
  const float* xn;
  const float* scale;
  const float* offset;
  float* out;
  int P, B, D, Dpad, V;
  int64_t ld_out;
  bool vec;
};

template <typename T, int NA, bool kQuant, bool kIP, bool kGiven>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int smem = Shape<T, NA>::kSmem;
  auto kernel = bmm_wgmma<T, NA, kQuant, kIP, kGiven>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int n_ntiles = (a.V + kBN - 1) / kBN;
  const int n_mtiles = (a.B + 63) / 64;
  const int64_t n_tiles = static_cast<int64_t>(a.P) * n_ntiles * n_mtiles;
  if (n_tiles > INT32_MAX) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(n_tiles < sms ? n_tiles : sms);  // one block per SM
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.x), static_cast<const __nv_bfloat16*>(a.qa), a.qn, a.qo, a.xn,
      a.scale, a.offset, a.out, a.P, a.B, a.D, a.Dpad, a.V, n_ntiles, n_mtiles, a.ld_out,
      a.vec);
  return cudaGetLastError();
}

int round64(int n) { return (n + 63) / 64 * 64; }

// Bytes of the three query planes of B queries over D dims.
int64_t plane_bytes(int B, int D) { return int64_t{3} * round64(B) * round64(D) * 2; }

// Splits the queries into the workspace (planes, then q.offset for a
// quantized mirror) and points a at them.
template <int NA>
cudaError_t prepare_queries(Args& a, const float* q, void* work, cudaStream_t s) {
  const int n_mtiles = (a.B + 63) / 64;
  auto* qa = static_cast<__nv_bfloat16*>(work);
  float* qo = a.scale == nullptr
                  ? nullptr
                  : reinterpret_cast<float*>(static_cast<char*>(work) + plane_bytes(a.B, a.D));
  split_queries<NA><<<n_mtiles, 256, 0, s>>>(q, a.scale, a.offset, qa, qo, a.B, a.D, a.Dpad,
                                              n_mtiles);
  a.qa = qa;
  a.qo = qo;
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_quant(const Args& a, bool quant, bool ip, cudaStream_t s) {
  if (quant) return ip ? launch<T, 3, true, true, false>(a, s) : launch<T, 3, true, false, false>(a, s);
  return ip ? launch<T, 3, false, true, false>(a, s) : launch<T, 3, false, false, false>(a, s);
}

template <typename T, int NA>
cudaError_t dispatch_given(const Args& a, bool ip, cudaStream_t s) {
  return ip ? launch<T, NA, false, true, true>(a, s) : launch<T, NA, false, false, true>(a, s);
}

}  // namespace

// Bytes of the workspace that K2 and K7 take for B queries over D dims
// (the split queries), or -1 past 2^31.
extern "C" int batched_matmul_workspace_bytes(int B, int D) {
  const int64_t n = plane_bytes(B, D) + int64_t{4} * round64(B);
  return n > INT32_MAX ? -1 : static_cast<int>(n);
}

// K2.  dtype: 0 f32, 1 bf16, 2 int8 levels, 3 int4 levels packed two a byte
// (x has ceil(D/2) rows; D counts dims).  q (B, D) f32 queries; a quantized
// mirror gives scale, offset (D,), any other passes null for both.  work:
// batched_matmul_workspace_bytes(B, D) bytes of device memory, 16-byte
// aligned.  vec: the tile's rows can be copied in aligned 16-byte pieces
// (8-byte for int8/int4).  Launches split_queries, then the main kernel.
// Returns a cudaError_t.
extern "C" int batched_distance_quant(const void* x, int dtype, const float* q,
                                      const float* qn, const float* scale, const float* offset,
                                      void* work, float* out, int P, int B, int D, int V, int ip,
                                      int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x, nullptr, qn, nullptr, nullptr, scale, offset, out, P, B, D, round64(D), V,
         static_cast<int64_t>(P) * V, vec != 0};
  const cudaError_t err = prepare_queries<3>(a, q, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool quant = scale != nullptr, is_ip = ip != 0;
  switch (dtype) {
    case 0:
      return dispatch_quant<float>(a, quant, is_ip, s);
    case 1:
      return dispatch_quant<__nv_bfloat16>(a, quant, is_ip, s);
    case 2:
      return dispatch_quant<int8_t>(a, quant, is_ip, s);
    case 3:
      return dispatch_quant<uint8_t>(a, quant, is_ip, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7.  t_dtype: 0 f32, 1 bf16; q (B, D) f32 queries, q_planes 3, or 1
// where every query value is a bf16 value; work as for K2.  qn, xn are
// ignored for ip.  Returns a cudaError_t.
extern "C" int batched_distance(const void* x, int t_dtype, const float* q, int q_planes,
                                const float* qn, const float* xn, void* work, float* out, int B,
                                int D, int V, int ip, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Args a{x, nullptr, qn, nullptr, xn, nullptr, nullptr, out, 1, B, D, round64(D), V,
         static_cast<int64_t>(V), vec != 0};
  const bool is_ip = ip != 0;
  if (q_planes != 1 && q_planes != 3) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      q_planes == 3 ? prepare_queries<3>(a, q, work, s) : prepare_queries<1>(a, q, work, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (t_dtype * 2 + (q_planes == 1)) {
    case 0:
      return dispatch_given<float, 3>(a, is_ip, s);
    case 1:
      return dispatch_given<float, 1>(a, is_ip, s);
    case 2:
      return dispatch_given<__nv_bfloat16, 3>(a, is_ip, s);
    case 3:
      return dispatch_given<__nv_bfloat16, 1>(a, is_ip, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* batched_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
