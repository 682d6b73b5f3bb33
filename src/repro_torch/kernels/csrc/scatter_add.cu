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
//   * K5: each thread takes one (row, d) update, upcasts the value to f32
//     and atomicAdds it.  Shared route: when the S x D f32 result fits the
//     host's per-block budget, each block accumulates into a shared copy
//     and flushes its non-zero entries to the global result with atomicAdd.
//     Global route: otherwise each update goes straight to the zeroed
//     output with a global atomicAdd (a RED, its result unused).  The host
//     picks the route from S x D.
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
//   * K7: a shared int[S] histogram, atomicAdd of 1 with the result unused
//     (the POPC increment class), flushed the same way.
//
// Semantics kept from the reference:
//   * The drop rule: an id outside [0, S), negative ids included, adds
//     nothing.  One unsigned compare checks it and keeps every write in
//     bounds.
//   * The TPU tile and segment block are blocking, not semantics: the
//     reference pads N with zero-valued rows (K5) or with id-0 rows whose
//     counts it subtracts again (K7).  These kernels stop at the last row.
//   * K6 takes the committed id stream, already padded to a whole tile with
//     unique out-of-range sentinels (ops.committed_id_stream): they add
//     nothing to the sums and count as distinct ids in the degrees, as do
//     real ids past row n.
//
// Why K6 may aggregate: the model's counters N, O and e come from K1's
// degrees of the committed stream, never from K6's time or its atomic
// traffic, and the reference kernel commits with a one-hot product, with
// no atomics at all.  So one add per distinct id per group changes no
// counter, verdict or report; it changes only the order of the f32 sums,
// which are shorter now.  A sum of 0 is not added (an add of +0 or -0 to
// the zeroed copy changes nothing).
//
// Bound on an H100: bytes.  Each value and id is read once and each output
// written once; the N x D f32 adds are far below the f32 rate.  What the
// data can make slow is the atomic unit: a float atomicAdd on shared
// memory has no single opcode (a CAS loop, chip_smoke.py lists the SASS
// each kernel compiled to), and a solid id stream sends every update of K5
// to one address.  K6 sends one add per group there instead of 32 (NVIDIA
// H100 80GB HBM3, 700.00 W, chip_smoke.py: 0.0346 ms on 4 Mi solid ids,
// K5 0.7467).  On distinct ids it pays K1's sort, the scan and one shared
// CAS loop per id (0.0428 ms on 4 Mi uniform ids, K5 0.0217); the flush
// of a 4096-entry copy from 132 blocks costs 0.0073 ms alone, 0.0091 from
// 264 (tools/bench_degrees.py).  At d > 1 a wave is still one warp's work,
// so a stream of few waves leaves most of the card idle (PERF.md).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "wave_degrees.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kGroupsPerWave = REPRO_LANES / REPRO_COMMIT_GROUP;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// K5.  values: (n, d) row-major; ids: n ids.
template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                   float* __restrict__ out, int n, int d, int num_segments) {
  extern __shared__ __align__(16) float acc[];
  const int cells = num_segments * d;
  if constexpr (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) acc[i] = 0.0f;
    __syncthreads();
  }

  // n * d < 2^31 (checked by the host), so e + stride never wraps
  const unsigned total = (unsigned)n * (unsigned)d;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const unsigned row = e / (unsigned)d;
    const int id = ids[row];
    if ((unsigned)id < (unsigned)num_segments) {
      const float v = to_f32(values[e]);
      const unsigned dst = (unsigned)id * (unsigned)d + (e - row * (unsigned)d);
      if constexpr (kShared)
        atomicAdd(&acc[dst], v);
      else
        atomicAdd(&out[dst], v);
    }
  }

  if constexpr (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const float v = acc[i];
      if (v != 0.0f) atomicAdd(&out[i], v);
    }
  }
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

__global__ void __launch_bounds__(kThreads)
    bincount_kernel(const int* __restrict__ ids, int* __restrict__ out, int n,
                    int num_segments) {
  extern __shared__ __align__(16) int counts[];
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < (unsigned)n; i += stride) {
    const int id = ids[i];
    if ((unsigned)id < (unsigned)num_segments) atomicAdd(&counts[id], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) {
    const int c = counts[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
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

template <typename T, bool kShared>
int launch_scatter(const void* values, const void* ids, void* out, int n, int d,
                   int num_segments, void* stream) {
  auto kernel = scatter_kernel<T, kShared>;
  const size_t smem = kShared ? (size_t)num_segments * d * sizeof(float) : 0;
  int grid = 0;
  const int err = grid_for(kernel, smem, (long long)n * d, &grid);
  if (err) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)values, (const int*)ids, (float*)out, n, d, num_segments);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter_add_typed(const void* values, const void* ids, void* out, int n, int d,
                      int num_segments, int shared, void* stream) {
  return shared ? launch_scatter<T, true>(values, ids, out, n, d, num_segments, stream)
                : launch_scatter<T, false>(values, ids, out, n, d, num_segments, stream);
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

}  // namespace

extern "C" {

// K5.  values: (n, d), dtype 0 = f32, 1 = bf16, 2 = f16; ids: (n,) int32;
// out: (num_segments, d) f32, zeroed by the caller; shared: the route.
int repro_scatter_add(const void* values, const void* ids, void* out, int n, int d,
                      int num_segments, int dtype, int shared, void* stream) {
  switch (dtype) {
    case 0:
      return scatter_add_typed<float>(values, ids, out, n, d, num_segments, shared, stream);
    case 1:
      return scatter_add_typed<__nv_bfloat16>(values, ids, out, n, d, num_segments, shared,
                                              stream);
    case 2:
      return scatter_add_typed<__half>(values, ids, out, n, d, num_segments, shared, stream);
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

// K7.  ids: (n,) int32; out: (num_segments,) int32, zeroed by the caller.
int repro_bincount(const void* ids, void* out, int n, int num_segments, void* stream) {
  const size_t smem = (size_t)num_segments * sizeof(int);
  int grid = 0;
  const int err = grid_for(bincount_kernel, smem, n, &grid);
  if (err) return err;
  bincount_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>((const int*)ids, (int*)out,
                                                                  n, num_segments);
  return (int)cudaGetLastError();
}

}  // extern "C"
