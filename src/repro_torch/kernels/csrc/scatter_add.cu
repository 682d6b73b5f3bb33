// K5, K6 and K7: segment sums and occurrence counts with atomics.
//
// Replaces, in src/repro/kernels/scatter_add/kernel.py:
//   K5  _scatter_kernel               (segment sum of (N, D) values by id)
//   K6  _scatter_instrumented_kernel  (K5 plus K1's per-wave degrees)
//   K7  _bincount_kernel              (int32 occurrence counts, S <= 8192)
// The TPU kernels turn every update into a one-hot matrix product over a
// 2-D grid of 4096-row segment blocks x 2048-id tiles: N x S x D work for
// N x D updates.  On Hopper they become the loops they are on a GPU in the
// first place, the shared-memory atomics the paper models:
//   * K5 and K6: each thread takes one (row, d) update, upcasts the value to
//     f32 and atomicAdds it.  Shared route: when the S x D f32 result fits
//     the host's per-block budget, each block accumulates into a shared copy
//     and flushes its non-zero entries to the global result with atomicAdd.
//     Global route: otherwise each update goes straight to the zeroed output
//     with a global atomicAdd (a RED, its result unused).  The host picks the
//     route from S x D.
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
//     nothing to the sums and count as distinct ids in the degrees.  The
//     degrees are computed once per launch, by one warp per 1024-id wave:
//     the stream is in natural order, so a wave is 32 consecutive 32-id
//     commit groups.  The 32 group maxima are summed as integers and
//     divided once, so the f32 degree is exact.
//
// Bound on an H100: bytes.  Each value and id is read once and each output
// written once; the N x D f32 adds are far below the f32 rate.  What the
// data can make slow is the atomic unit: a solid id stream sends all 32
// lanes of a warp to one address, and a float atomicAdd on shared memory
// has no single opcode (chip_smoke.py lists the SASS each kernel compiled
// to).  The design hides neither on purpose: that contention is what the
// model measures.
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

// values: (n, d) row-major; ids: n ids (K5), or the committed stream of
// num_waves * 1024 ids whose first n rows carry values (K6).
template <typename T, bool kShared, bool kInstrumented>
__global__ void __launch_bounds__(kThreads)
    scatter_kernel(const T* __restrict__ values, const int* __restrict__ ids,
                   float* __restrict__ out, float* __restrict__ deg, int n,
                   int num_waves, int d, int num_segments) {
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

  if constexpr (kInstrumented) {
    // the warp index is uniform across a warp, so every lane of it runs
    // the same waves, as group_max_multiplicity needs
    const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
    const int warps = gridDim.x * (blockDim.x / REPRO_COMMIT_GROUP);
    for (int w = (blockIdx.x * blockDim.x + threadIdx.x) / REPRO_COMMIT_GROUP;
         w < num_waves; w += warps) {
      const int* wave = ids + (long long)w * REPRO_LANES;
      unsigned sum = 0;
      for (int g = 0; g < REPRO_LANES; g += REPRO_COMMIT_GROUP)
        sum += group_max_multiplicity(wave[g + lane]);
      if (lane == 0) deg[w] = (float)sum / (float)kGroupsPerWave;
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

// As many blocks as fit on the card at once, but no more than the work
// needs: every block of the shared routes pays a flush of its whole copy.
template <typename Kernel>
int grid_for(Kernel kernel, size_t smem, long long work, int* grid) {
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
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (work + kThreads - 1) / kThreads;
  if (g > need) g = need;
  *grid = g > 0 ? (int)g : 1;
  return 0;
}

template <typename T, bool kShared, bool kInstrumented>
int launch_scatter(const void* values, const void* ids, void* out, void* deg, int n,
                   int num_waves, int d, int num_segments, void* stream) {
  auto kernel = scatter_kernel<T, kShared, kInstrumented>;
  const size_t smem = kShared ? (size_t)num_segments * d * sizeof(float) : 0;
  long long work = (long long)n * d;
  if (kInstrumented && (long long)num_waves * REPRO_COMMIT_GROUP > work)
    work = (long long)num_waves * REPRO_COMMIT_GROUP;
  int grid = 0;
  const int err = grid_for(kernel, smem, work, &grid);
  if (err) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)values, (const int*)ids, (float*)out, (float*)deg, n, num_waves, d,
      num_segments);
  return (int)cudaGetLastError();
}

template <typename T>
int scatter_add_typed(const void* values, const void* ids, void* out, int n, int d,
                      int num_segments, int shared, void* stream) {
  return shared ? launch_scatter<T, true, false>(values, ids, out, nullptr, n, 0, d,
                                                 num_segments, stream)
                : launch_scatter<T, false, false>(values, ids, out, nullptr, n, 0, d,
                                                  num_segments, stream);
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
  return shared ? launch_scatter<float, true, true>(values, ids, out, deg, n, waves, d,
                                                    num_segments, stream)
                : launch_scatter<float, false, true>(values, ids, out, deg, n, waves, d,
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
