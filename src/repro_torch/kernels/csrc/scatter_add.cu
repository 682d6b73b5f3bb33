// K5, K6 and K7: segment sums and occurrence counts with atomics.
//
// Replaces, in src/repro/kernels/scatter_add/kernel.py:
//   K5  _scatter_kernel               (segment sum of (N, D) values by id)
//   K6  _scatter_instrumented_kernel  (K5 plus K1's per-wave degrees)
//   K7  _bincount_kernel              (int32 occurrence counts, S <= 8192)
// The TPU kernels turn every update into a one-hot matrix product over a
// 2-D grid of 4096-row segment blocks x 2048-id tiles: N x S x D work for
// N x D updates.  On Hopper they become the loops they are on a GPU in
// the first place, the shared-memory atomics the paper models:
//   * K5 at d = 1 (scatter_rows_kernel): a warp takes 32 consecutive rows
//     a step, a lane to a row, and add_aggregated (warp_aggregate.cuh)
//     sums equal ids within the warp before it adds: one add per distinct
//     id a step.  At d > 1 (scatter_tiles_kernel) a warp takes a tile of
//     32 rows by up to 32 x kV columns, groups the rows by id with
//     __match_any_sync and adds each id's sum once a column.  Shared
//     route: when the S x D f32 result fits the host's per-block budget,
//     each block sums into a shared copy and flushes its non-zero entries
//     to the global result with atomicAdd.  Global route: the sums go
//     straight to the zeroed output, with f32 vector adds
//     (red.global.add.v4.f32) of four columns where the rows are 16-byte
//     aligned.  Owned route (scatter_owned_kernel), for such rows of 2048
//     values or more: a block owns a range of segments, lists their rows and sums
//     each output row in f64 in registers, 16 bytes a load, written once
//     with no atomics.  The host picks the route
//     (kernel.py:scatter_add_route).
//   * K6: one pass over the committed stream, one warp to a 1024-id wave.
//     For each 32-id commit group the warp takes the degree (K1) and adds
//     the group's rows: one add per distinct id in [0, S) and column, of
//     the sum of that id's values within the group, into the shared copy
//     or the output (the same two routes).  K1's sort (skipped when the
//     group holds one id) leaves each id as a run of lanes carrying their
//     source rows; the sort moves (id - lowest) << 5 | lane as one word
//     when the group's ids span less than 2^26.  At d = 1 a segmented scan
//     sums each run and its last lane adds it; at d > 1 the lanes take
//     columns and walk the sorted rows, so that a run's adds fall on
//     consecutive words (a lane per row would put them all in one shared
//     bank).  Lane 0 writes the wave's degree, the 32 group maxima summed
//     as integers and divided once (exact in f32).  One 1024-thread block
//     to an SM: each block flushes its copy once.
//   * K7 (bincount.cuh): a shared int[S] histogram, atomicAdd of 1 with the
//     result unused (the POPC increment class), read one id a thread while
//     the grid has a thread for each id and in 16-byte words beyond.  Up to
//     kernel.py's BINCOUNT_BLOCK_IDS ids one block stores every count (one
//     launch, no zeroed output).  Above, a kernel zeroes out while one
//     block an SM counts (a programmatic dependent launch: cheaper than a
//     fill or a memset before the count), then adds its non-zero counts.
//     Clusters that sum their copies through distributed shared memory,
//     one block an SM with twice the ids, a cooperative launch in two
//     phases and one cluster that stores were slower on the H100
//     (tools/bincount_candidates.cu, PERF.md).
//
// Semantics kept from the reference:
//   * The drop rule: an id outside [0, S), negative ids included, adds
//     nothing.  One unsigned compare checks it, before any sum, and keeps
//     every write in bounds.
//   * bf16 and f16 values are upcast to f32 before any sum.
//   * The TPU tile and segment block are blocking, not semantics: the
//     reference pads N with zero-valued rows (K5) or with id-0 rows whose
//     counts it subtracts again (K7).  These kernels stop at the last row.
//   * K6 takes the committed id stream, already padded to a whole tile with
//     unique out-of-range sentinels (ops.committed_id_stream): they add
//     nothing to the sums and count as distinct ids in the degrees, as do
//     real ids past row n.
//
// Why K5 and K6 may aggregate: the model's counters N, O and e come from
// K1's degrees of the committed stream (K6's, or the trace provider's),
// never from K5's or K6's time or atomic traffic, and the reference
// kernels sum with one-hot products, with no atomics at all.  So one add
// per distinct id per warp step (K5) or group (K6) changes no counter,
// verdict or report; it changes only the order of the f32 sums, whose
// chains are shorter now.  A sum of 0 is not flushed (an add of +0 or -0
// to the zeroed copy changes nothing).  K7 counts with the POPC increment,
// which the hardware aggregates itself.
//
// Bound on an H100: bytes.  Each value and id is read once and each output
// written once; the N x D f32 adds are far below the f32 rate.  What the
// data can make slow is the atomic unit: a float atomicAdd on shared
// memory has no single opcode (a CAS loop, chip_smoke.py lists the SASS
// each kernel compiled to), and a solid id stream sends every update to one
// address; at L2 a vector add saves only 8-31% of its four scalar adds
// (tools/bench_cas_kernels.py --routes).
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W (chip_smoke.py; ms,
// bound in brackets): K5 on 4 Mi ids x 1 f32 into 4096 segments 0.0311
// solid, 0.0212 uniform, 0.0617 skewed (0.0100), the MoE combine of
// 32,768 x 4096 bf16 rows 0.1924 (0.1002); K6 0.0349 solid, 0.0435
// uniform (0.0100); K7 on 4 Mi uniform ids into 8192 bins 0.0119, cold
// 0.0178 (0.0050), on the MoE dispatch's 65,536 ids into 128 0.0062 and
// on a decode step's 32 ids 0.0054, where one empty kernel launch takes
// 0.0050.  Scattered int32 adds reach L2's atomic unit at 48 G/s onto
// 8192 addresses (tools/bench_bincount.py).  PERF.md has every case.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "bincount.cuh"
#include "warp_aggregate.cuh"
#include "wave_degrees.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kGroupsPerWave = REPRO_LANES / REPRO_COMMIT_GROUP;

// K7: 16-byte loads a thread in flight.
constexpr int kK7Loads = 2;

// The values of a part on K5's vector route (four, one f32 vector add; 16
// or 8 bytes) and on its owned route (16 bytes).
constexpr int kVectorValues = 4;
template <typename T>
constexpr int kOwnedValues = (int)(16 / sizeof(T));

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// K5 at d = 1: a warp takes 32 consecutive rows a step, a lane to a row,
// and adds them by add_aggregated; the next step's ids and values are
// loaded before this step's adds.  Every lane runs the same steps, a lane
// past row n with the neutral id -1.
template <typename T>
__device__ __forceinline__ void scatter_rows(float* dst, const T* __restrict__ values,
                                             const int* __restrict__ ids, int n,
                                             int num_segments, unsigned warp,
                                             unsigned warps, float* scratch) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned step = warps * 32;
  // n < 2^31 (checked by the host), so row + step never wraps
  unsigned row = warp * 32 + lane;
  int id = -1;
  float v = 0.0f;
  if (row < (unsigned)n) {
    id = ids[row];
    v = to_f32(values[row]);
  }
  bool hot = false;  // add_aggregated's state
  for (unsigned base = warp * 32; base < (unsigned)n; base += step) {
    const unsigned next = row + step;
    int next_id = -1;
    float next_v = 0.0f;
    if (next < (unsigned)n) {
      next_id = ids[next];
      next_v = to_f32(values[next]);
    }
    repro_agg::add_aggregated<false>(dst, id, v, (unsigned)num_segments, hot, scratch);
    row = next;
    id = next_id;
    v = next_v;
  }
}

// Two values packed in a 32-bit word, as f32 (low half first).
__device__ __forceinline__ void unpack2(unsigned w, __nv_bfloat16, float& a, float& b) {
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack2(unsigned w, __half, float& a, float& b) {
  a = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  b = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// Adds kV consecutive values of a row, as f32, into sum (f32 or f64): one
// 16-byte load (4 f32 or 8 16-bit values), or one 8-byte load (4 16-bit
// values), when kV > 1.
template <typename T, int kV, typename Acc>
__device__ __forceinline__ void add_loaded(const T* __restrict__ p, Acc (&sum)[kV]) {
  if constexpr (kV == 1) {
    sum[0] += to_f32(*p);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(kV == 4, "four f32 to a 16-byte part");
    const float4 x = *reinterpret_cast<const float4*>(p);
    sum[0] += x.x;
    sum[1] += x.y;
    sum[2] += x.z;
    sum[3] += x.w;
  } else {
    static_assert(kV == 4 || kV == 8, "four or eight 16-bit values to a part");
    unsigned w[kV / 2];
    if constexpr (kV == 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      w[0] = raw.x;
      w[1] = raw.y;
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      w[0] = raw.x;
      w[1] = raw.y;
      w[2] = raw.z;
      w[3] = raw.w;
    }
#pragma unroll
    for (int j = 0; j < kV / 2; ++j) {
      float a, b;
      unpack2(w[j], T(), a, b);
      sum[2 * j] += a;
      sum[2 * j + 1] += b;
    }
  }
}

// Adds kV sums at dst (kV consecutive words): f32 vector adds
// (red.global.add.v4.f32) when kV > 1, which the host takes only on the
// global route with dst 16-byte aligned.
template <int kV>
__device__ __forceinline__ void add_part(float* dst, const float (&f)[kV]) {
  if constexpr (kV == 1) {
    atomicAdd(dst, f[0]);
  } else {
#pragma unroll
    for (int j = 0; j < kV; j += 4)
      atomicAdd(reinterpret_cast<float4*>(dst + j),
                make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]));
  }
}

// Adds the kV f32 at src (16-byte aligned) into sum, 16 bytes a load.
template <int kV, typename Acc>
__device__ __forceinline__ void add_written(const float* src, Acc (&sum)[kV]) {
#pragma unroll
  for (int j = 0; j < kV; j += 4) {
    const float4 x = *reinterpret_cast<const float4*>(src + j);
    sum[j] += x.x;
    sum[j + 1] += x.y;
    sum[j + 2] += x.z;
    sum[j + 3] += x.w;
  }
}

// Writes kV f32 at dst (16-byte aligned), 16 bytes a store.
template <int kV>
__device__ __forceinline__ void store_part(float* dst, const float (&f)[kV]) {
#pragma unroll
  for (int j = 0; j < kV; j += 4)
    *reinterpret_cast<float4*>(dst + j) = make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
}

// The lanes K5 gives a row of d values at kV a lane: the least power of
// two that covers the row's parts, at most 32.
__host__ __device__ __forceinline__ int lanes_per_row(int d, int kV) {
  const int parts = (d + kV - 1) / kV;
  int lanes = 32;
  while (lanes > 1 && lanes / 2 >= parts) lanes /= 2;
  return lanes;
}

// K5 at d > 1.  The work is cut into tiles of 32 consecutive rows by
// lanes_per_row x kV columns, a warp to a tile.  __match_any_sync groups a
// tile's rows by id; then, one distinct id in [0, S) at a time, the lanes
// take the tile's columns, kV to a lane (a 16-byte part of the row on the
// vector route, one value otherwise), sum that id's rows and add each sum
// once: a warp's adds fall on consecutive words (no shared bank conflict,
// no two lanes on one word), a row whose id is out of range is not even
// read, and an id's chain of adds to one word is at most one a tile (a
// chain of one add a row strays past 1e-5 on the designed streams).  A row
// narrower than the warp takes lanes_per_row lanes, so 32 / lanes_per_row
// ids go at once.
template <typename T, int kV>
__device__ __forceinline__ void scatter_tiles(float* dst, const T* __restrict__ values,
                                              const int* __restrict__ ids, int n, int d,
                                              int num_segments, unsigned warp,
                                              unsigned warps) {
  using repro_k1::kFull;
  const unsigned lane = threadIdx.x & 31;
  const int lanes = lanes_per_row(d, kV);
  const int at_once = 32 / lanes;
  const int sub = (int)lane / lanes;  // which of the ids that go at once
  const int width = lanes * kV;       // a tile's columns
  const unsigned tiles = (unsigned)((d + width - 1) / width);  // a row's
  const unsigned total = ((unsigned)n + 31) / 32 * tiles;
  for (unsigned t = warp; t < total; t += warps) {
    const int c = (int)(t % tiles) * width + (int)(lane % lanes) * kV;
    const bool column = c < d;
    const unsigned base = t / tiles * 32;
    const unsigned row = base + lane;
    const int id = row < (unsigned)n ? ids[row] : -1;
    const bool keep = (unsigned)id < (unsigned)num_segments;
    const unsigned peers = __match_any_sync(kFull, id);
    // the lowest lane of each distinct id in range
    const unsigned leaders = __ballot_sync(kFull, keep && __ffs(peers) - 1 == (int)lane);
    unsigned mine = leaders;  // this lane's next id: the lowest left
    for (int j = 0; j < sub; ++j) mine &= mine - 1;
    for (int i = 0; i < __popc(leaders); i += at_once) {
      const int src = mine ? __ffs(mine) - 1 : 0;
      const int k = __shfl_sync(kFull, id, src);
      const unsigned rows = __shfl_sync(kFull, peers, src);
      if (mine && column) {
        float sum[kV] = {};
        for (unsigned m = rows; m; m &= m - 1)
          add_loaded<T, kV>(&values[(size_t)(base + __ffs(m) - 1) * d + c], sum);
        add_part<kV>(&dst[(size_t)k * d + c], sum);
      }
      for (int j = 0; j < at_once; ++j) mine &= mine - 1;
    }
  }
}

// K5's owned route, for wide rows on the global route (the MoE combine):
// each output row is summed by one block, in registers, and written once,
// with no atomics.  One L2 add per (row, column) update, vector or not,
// is what bounds the other global routes on a combine (8 rows into each
// token's 4096 columns).
// A block owns kOwnedSegments segments at a time (fewer when the grid
// covers S with fewer): it reads every id, lists the rows whose id it owns
// in row order (a block-wide count of each 1024-row chunk's ids), sorts
// the list by segment (a count, a prefix sum and a placement in shared
// memory), and then its warps take (segment, 32 x kV columns) tiles: each
// lane sums its kV columns over the segment's rows, in f64, and writes
// them.  A list of kOwnedRows is summed before more rows are listed; a
// later sum adds to what an earlier one wrote.  Every block reads every
// id, 4 bytes a row, and the atomic tiles pay an L2 add a value: the host
// takes this route from 2048 values a row, where it won on the H100 in
// f32 and bf16 (it lost at 1024; tools/bench_cas_kernels.py --routes).
constexpr int kOwnedRows = 4096;
constexpr int kOwnedSegments = 1024;

template <typename T, int kV>
__device__ __forceinline__ void sum_owned(const T* __restrict__ values, const int* __restrict__ ids,
                                          float* __restrict__ out, int d, int s0, int segs,
                                          const int* rows, int listed, bool first, int* sorted,
                                          int* start) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  // start[g + 1] = the listed rows of segment s0 + g, then their prefix sums
  for (int i = threadIdx.x; i <= segs; i += blockDim.x) start[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < listed; i += blockDim.x) atomicAdd(&start[ids[rows[i]] - s0 + 1], 1);
  __syncthreads();
  if (warp == 0) {
    int carried = 0;
    for (int base = 0; base <= segs; base += 32) {
      int x = base + lane <= segs ? start[base + lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(repro_k1::kFull, x, o);
        if (lane >= o) x += y;
      }
      if (base + lane <= segs) start[base + lane] = x + carried;
      carried += __shfl_sync(repro_k1::kFull, x, 31);
    }
  }
  __syncthreads();
  // each row to its segment's place; afterwards start[g] is where segment
  // g ends, and so where g + 1 begins
  for (int i = threadIdx.x; i < listed; i += blockDim.x) {
    const int r = rows[i];
    sorted[atomicAdd(&start[ids[r] - s0], 1)] = r;
  }
  __syncthreads();
  const int width = 32 * kV;
  const int tiles = (d + width - 1) / width;
  for (int item = warp; item < segs * tiles; item += blockDim.x / 32) {
    const int g = item / tiles;
    const int lo = g ? start[g - 1] : 0, hi = start[g];
    const int c = item % tiles * width + lane * kV;
    if (lo == hi || c >= d) continue;
    // in f64: a segment may take thousands of rows, and a chain of f32
    // adds that long strays past 1e-5 where the sum is near 0
    double sum[kV] = {};
    for (int i = lo; i < hi; ++i) add_loaded<T, kV>(&values[(size_t)sorted[i] * d + c], sum);
    float* o = &out[(size_t)(s0 + g) * d + c];
    if (!first) add_written<kV>(o, sum);
    float f[kV];
#pragma unroll
    for (int j = 0; j < kV; ++j) f[j] = (float)sum[j];
    store_part<kV>(o, f);
  }
  __syncthreads();
}

template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
    scatter_owned_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                         float* __restrict__ out, int n, int d, int num_segments) {
  __shared__ int rows[kOwnedRows];
  __shared__ int sorted[kOwnedRows];
  __shared__ int start[kOwnedSegments + 1];
  __shared__ int warp_rows[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int span = min(kOwnedSegments, (num_segments + (int)gridDim.x - 1) / (int)gridDim.x);
  const int ranges = (num_segments + span - 1) / span;
  for (int range = blockIdx.x; range < ranges; range += gridDim.x) {
    const int s0 = range * span, segs = min(num_segments - s0, span);
    int listed = 0;
    bool first = true;
    for (int r0 = 0; r0 < n; r0 += kThreads) {
      const int r = r0 + (int)threadIdx.x;
      const int id = r < n ? ids[r] : -1;
      const bool owned = id >= s0 && id - s0 < segs;
      const unsigned mask = __ballot_sync(repro_k1::kFull, owned);
      if (lane == 0) warp_rows[warp] = __popc(mask);
      __syncthreads();
      int before = 0, chunk = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        const int k = warp_rows[w];
        before += w < warp ? k : 0;
        chunk += k;
      }
      if (listed + chunk > kOwnedRows) {
        sum_owned<T, kV>(values, ids, out, d, s0, segs, rows, listed, first, sorted, start);
        first = false;
        listed = 0;
      }
      if (owned) rows[listed + before + __popc(mask & ((1u << lane) - 1))] = r;
      listed += chunk;
      __syncthreads();
    }
    if (listed) sum_owned<T, kV>(values, ids, out, d, s0, segs, rows, listed, first, sorted, start);
  }
}

// K5.  values: (n, d) row-major; ids: n ids.  kShared: the sums go to a
// shared copy of the (S, d) result, flushed once a block; kVector (global route only): parts of four values and f32 vector adds.  The
// kernel for d = 1 (scatter_rows) and the one for d > 1 (scatter_tiles) are
// apart, so that each has the registers it needs.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                        float* __restrict__ out, int n, int num_segments) {
  __shared__ float scratch[kThreads];  // a warp's 32 words each
  extern __shared__ __align__(16) float acc[];
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < num_segments; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }
  // the warp index is uniform across a warp, so every lane of it runs the
  // same steps, as add_aggregated needs
  scatter_rows<T>(kShared ? acc : out, values, ids, n, num_segments,
                  (blockIdx.x * kThreads + threadIdx.x) / 32, gridDim.x * (kThreads / 32),
                  scratch + (threadIdx.x & ~31u));
  if constexpr (kShared) repro_agg::flush_copy(acc, out, num_segments);
}

template <typename T, bool kShared, bool kVector>
__global__ void __launch_bounds__(kThreads)
    scatter_tiles_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                         float* __restrict__ out, int n, int d, int num_segments) {
  static_assert(!(kShared && kVector), "shared memory has no vector float add");
  extern __shared__ __align__(16) float acc[];
  const int cells = num_segments * d;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }
  scatter_tiles<T, kVector ? kVectorValues : 1>(
      kShared ? acc : out, values, ids, n, d, num_segments,
      (blockIdx.x * kThreads + threadIdx.x) / 32, gridDim.x * (kThreads / 32));
  if constexpr (kShared) repro_agg::flush_copy(acc, out, cells);
}

// K6's work on one commit group: adds the sums of its rows by id into dst
// (the block's shared copy or the output), one add per distinct id in
// [0, S) and column, and returns the group's degree.  group_row is the
// stream position of the group's lane 0; v0 is the calling lane's value
// when d = 1 (0 for a row past n).  Every lane of the warp calls it
// together.
__device__ __forceinline__ unsigned scatter_group(
    float* dst, const float* __restrict__ values, int id, float v0,
    unsigned group_row, int n, int d, int num_segments) {
  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  // the group in id order: each distinct id a run of lanes, src the lane
  // (row) each lane now holds; a group of one id is one run as it stands
  int key = id, src = lane;
  unsigned heads = 1u;
  if (!__all_sync(repro_k1::kFull, id == __shfl_sync(repro_k1::kFull, id, 0))) {
    // when the ids span less than 2^26, (id - lowest) << 5 | lane is one
    // non-negative key and the sort moves one word a step, not two
    const int lowest = __reduce_min_sync(repro_k1::kFull, id);
    const unsigned offset = (unsigned)id - (unsigned)lowest;
    if (__reduce_max_sync(repro_k1::kFull, offset) < (1u << 26)) {
      key = (int)(offset << 5 | (unsigned)lane);
      repro_k1::sort_group<repro_k1::Sort::kKeys>(key, src);
      src = key & (REPRO_COMMIT_GROUP - 1);
      key = (int)(((unsigned)key >> 5) + (unsigned)lowest);
    } else {
      repro_k1::sort_group<repro_k1::Sort::kCarry>(key, src);
    }
    heads = repro_k1::run_heads(key);
  }
  const int head = repro_k1::run_head(heads);
  const unsigned ends = heads >> 1 | 0x80000000u;  // each run's last lane
  if (d == 1) {
    // a lane to a row: a segmented scan sums each run, its last lane adds it
    float v = __shfl_sync(repro_k1::kFull, v0, src);
#pragma unroll
    for (int o = 1; o < REPRO_COMMIT_GROUP; o <<= 1) {
      const float t = __shfl_up_sync(repro_k1::kFull, v, o);
      if (lane - o >= head) v += t;
    }
    if ((ends >> lane & 1u) && (unsigned)key < (unsigned)num_segments && v != 0.0f)
      atomicAdd(&dst[key], v);
  } else {
    // a lane to a column: the warp walks the rows in id order, each lane
    // sums its column over a run and adds the sum at the run's end, so a
    // run's adds fall on consecutive words (no bank conflicts) and each
    // row is read coalesced
    for (int c0 = 0; c0 < d; c0 += REPRO_COMMIT_GROUP) {
      const int c = c0 + lane;
      float sum = 0.0f;
      for (int p = 0; p < REPRO_COMMIT_GROUP; ++p) {
        const int k = __shfl_sync(repro_k1::kFull, key, p);
        const unsigned row = group_row + __shfl_sync(repro_k1::kFull, src, p);
        const bool adds = (unsigned)k < (unsigned)num_segments && c < d;
        if (adds && row < (unsigned)n) sum += values[(size_t)row * d + c];
        if (ends >> p & 1u) {  // the same on every lane
          if (adds && sum != 0.0f) atomicAdd(&dst[(unsigned)k * d + c], sum);
          sum = 0.0f;
        }
      }
    }
  }
  return __reduce_max_sync(repro_k1::kFull, (unsigned)(lane - head + 1));
}

// K6.  values: (n, d) f32 row-major; ids: the committed stream of
// num_waves * 1024 ids, whose first n rows carry values.  One pass: each
// warp takes whole waves, and for each of a wave's 32 groups adds the
// group's sums and takes its degree; lane 0 writes the wave's degree.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    scatter_instrumented_kernel(const float* __restrict__ values,
                                const int* __restrict__ ids, float* __restrict__ out,
                                float* __restrict__ deg, int n, int num_waves, int d,
                                int num_segments) {
  extern __shared__ __align__(16) float acc[];
  const int cells = num_segments * d;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }
  float* const dst = kShared ? acc : out;

  // the warp index is uniform across a warp, so every lane of it runs the
  // same waves and groups, as the warp functions need
  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  const int warps = gridDim.x * (kThreads / REPRO_COMMIT_GROUP);
  for (int w = (blockIdx.x * kThreads + threadIdx.x) / REPRO_COMMIT_GROUP;
       w < num_waves; w += warps) {
    // num_waves * 1024 < 2^31 (checked by the host)
    unsigned row = (unsigned)w * REPRO_LANES + lane;
    int id = ids[row];
    float v0 = d == 1 && row < (unsigned)n ? values[row] : 0.0f;
    unsigned sum = 0;
    for (int g = 0; g < kGroupsPerWave; ++g) {
      // the next group's id (and value, at d = 1) are loaded before this
      // group's work
      const unsigned next = row + REPRO_COMMIT_GROUP;
      int next_id = 0;
      float next_v0 = 0.0f;
      if (g + 1 < kGroupsPerWave) {
        next_id = ids[next];
        if (d == 1 && next < (unsigned)n) next_v0 = values[next];
      }
      sum += scatter_group(dst, values, id, v0, row - lane, n, d, num_segments);
      row = next;
      id = next_id;
      v0 = next_v0;
    }
    if (lane == 0) deg[w] = (float)sum / (float)kGroupsPerWave;
  }

  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const float v = acc[i];
      if (v != 0.0f) atomicAdd(&out[i], v);
    }
  }
}

// K7 (bincount.cuh): a 1024-thread block counts its share of the ids into
// its shared copy, then stores it (kStore: the grid is one block) or adds
// it into the zeroed out.
template <bool kStore>
__global__ void __launch_bounds__(kThreads, 1)
    bincount_kernel(const int* __restrict__ ids, int* __restrict__ out, int n,
                    int num_segments) {
  extern __shared__ __align__(16) int counts[];
  repro_k7::bincount_block<kStore, kK7Loads>(counts, ids, out, n, num_segments);
}

// K7's grid route zeroes out in a kernel of its own, which lets the
// counting kernel launch at once (programmatic dependent launch): the
// counting waits for it only before its flush.
__global__ void bincount_zero_kernel(int* __restrict__ out, int num_segments) {
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) out[i] = 0;
}

// As many blocks as fit on the card at once, at most per_sm_cap on each SM
// when it is given, but no more than the work needs: every block of the
// shared routes pays a flush of its whole copy.
template <typename Kernel>
int grid_for(Kernel kernel, size_t smem, long long work, int* grid, int per_sm_cap = 0) {
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm_cap > 0 && per_sm > per_sm_cap) per_sm = per_sm_cap;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (work + kThreads - 1) / kThreads;
  if (g > need) g = need;
  *grid = g > 0 ? (int)g : 1;
  return 0;
}

// K5's routes (the host's choice, kernel.py:scatter_add_route): the global
// route with scalar adds, the shared route, the global route with vector
// adds, and the owned route (no atomics).
enum Route { kGlobalScalar = 0, kSharedCopy = 1, kGlobalVector = 2, kOwned = 3 };

template <typename T>
int launch_owned(const void* values, const void* ids, void* out, int n, int d,
                 int num_segments, void* stream) {
  auto kernel = scatter_owned_kernel<T, kOwnedValues<T>>;
  if (num_segments == 0) return 0;  // no row is owned
  int grid = 0;
  // a block to each of up to S ranges of segments
  const int err = grid_for(kernel, 0, (long long)num_segments * kThreads, &grid);
  if (err) return err;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>((const T*)values, (const int*)ids,
                                                     (float*)out, n, d, num_segments);
  return (int)cudaGetLastError();
}

template <typename T, bool kShared, bool kVector>
int launch_scatter(const void* values, const void* ids, void* out, int n, int d,
                   int num_segments, void* stream) {
  constexpr int kV = kVector ? kVectorValues : 1;
  const size_t smem = kShared ? (size_t)num_segments * d * sizeof(float) : 0;
  int grid = 0, err = 0;
  if (d == 1) {  // a thread to a row
    auto kernel = scatter_rows_kernel<T, kShared>;
    if ((err = grid_for(kernel, smem, n, &grid))) return err;
    kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>((const T*)values, (const int*)ids,
                                                           (float*)out, n, num_segments);
    return (int)cudaGetLastError();
  }
  const int width = lanes_per_row(d, kV) * kV;  // scatter_tiles' tile
  auto kernel = scatter_tiles_kernel<T, kShared, kVector>;
  // a warp to a tile
  if ((err = grid_for(kernel, smem, (n + 31LL) / 32 * ((d + width - 1) / width) * 32, &grid)))
    return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>((const T*)values, (const int*)ids,
                                                         (float*)out, n, d, num_segments);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter_add_typed(const void* values, const void* ids, void* out, int n, int d,
                      int num_segments, int route, void* stream) {
  switch (route) {
    case kGlobalScalar:
      return launch_scatter<T, false, false>(values, ids, out, n, d, num_segments, stream);
    case kSharedCopy:
      return launch_scatter<T, true, false>(values, ids, out, n, d, num_segments, stream);
    case kGlobalVector:
      return launch_scatter<T, false, true>(values, ids, out, n, d, num_segments, stream);
    case kOwned:
      return launch_owned<T>(values, ids, out, n, d, num_segments, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// K6: one block of 32 warps on each SM at most (a warp for each of 32
// waves), so that the shared route flushes one copy per SM.
template <bool kShared>
int launch_instrumented(const void* values, const void* ids, void* out, void* deg, int n,
                        int num_waves, int d, int num_segments, void* stream) {
  auto kernel = scatter_instrumented_kernel<kShared>;
  const size_t smem = kShared ? (size_t)num_segments * d * sizeof(float) : 0;
  int grid = 0;
  const int err = grid_for(kernel, smem, (long long)num_waves * REPRO_COMMIT_GROUP, &grid,
                           /*per_sm_cap=*/1);
  if (err) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)values, (const int*)ids, (float*)out, (float*)deg, n, num_waves, d,
      num_segments);
  return (int)cudaGetLastError();
}

// K7: one block (kStore), or one block an SM, but no more blocks than give
// each thread one id, launched to depend on bincount_zero_kernel.  Both
// take the largest shared-memory carveout: a block of the counting kernel
// that lands on the zeroing kernel's SM then starts at once, where with
// two carveouts it waits for the SM to drain (0.0130 against 0.0116 ms on
// 4 Mi uniform ids, PERF.md).
template <bool kStore>
int launch_bincount(const void* ids, void* out, int n, int num_segments, void* stream) {
  auto kernel = bincount_kernel<kStore>;
  const size_t bytes = (size_t)num_segments * sizeof(int);  // the copy, and out
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(1);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  if (!kStore) {
    for (const void* f : {(const void*)bincount_zero_kernel, (const void*)kernel}) {
      const cudaError_t e = cudaFuncSetAttribute(
          f, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return (int)e;
    }
    int grid = 0;
    int err = grid_for(kernel, bytes, n, &grid, /*per_sm_cap=*/1);
    if (err) return err;
    config.gridDim = dim3((unsigned)grid);
    config.attrs = attr;
    config.numAttrs = 1;
    bincount_zero_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>((int*)out, num_segments);
    if ((err = (int)cudaGetLastError())) return err;
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&config, kernel, (const int*)ids, (int*)out, n, num_segments);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K5.  values: (n, d), dtype 0 = f32, 1 = bf16, 2 = f16; ids: (n,) int32;
// out: (num_segments, d) f32, zeroed by the caller; route: 0
// global, 1 shared, 2 global with vector adds (d % 4 == 0, values and
// rows 16-byte aligned), 3 owned (as 2, d >= 2048).
int repro_scatter_add(const void* values, const void* ids, void* out, int n, int d,
                      int num_segments, int dtype, int route, void* stream) {
  switch (dtype) {
    case 0:
      return scatter_add_typed<float>(values, ids, out, n, d, num_segments, route, stream);
    case 1:
      return scatter_add_typed<__nv_bfloat16>(values, ids, out, n, d, num_segments, route,
                                              stream);
    case 2:
      return scatter_add_typed<__half>(values, ids, out, n, d, num_segments, route, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// K6.  values: (n, d) f32; ids: the committed stream of n_pad >= n ids,
// n_pad a multiple of 1024; out as K5; deg: (n_pad / 1024,) f32, every
// entry written by the kernel.
int repro_scatter_add_instrumented(const void* values, const void* ids, void* out,
                                   void* deg, int n, int n_pad, int d, int num_segments,
                                   int shared, void* stream) {
  const int waves = n_pad / REPRO_LANES;
  return shared ? launch_instrumented<true>(values, ids, out, deg, n, waves, d,
                                            num_segments, stream)
                : launch_instrumented<false>(values, ids, out, deg, n, waves, d,
                                             num_segments, stream);
}

// K7.  ids: (n,) int32; out: (num_segments,) int32, zeroed here by a
// kernel of its own (what it held before the call does not matter) into
// which one block an SM adds its counts.
int repro_bincount(const void* ids, void* out, int n, int num_segments, void* stream) {
  return launch_bincount<false>(ids, out, n, num_segments, stream);
}

// K7 in one block, which stores all num_segments counts into out (what
// out held before the call does not matter).
int repro_bincount_block(const void* ids, void* out, int n, int num_segments, void* stream) {
  return launch_bincount<true>(ids, out, n, num_segments, stream);
}

}  // extern "C"
