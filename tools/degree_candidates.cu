// K1 candidates, timed by bench_degrees.py: ways to take the largest
// duplicate count of a warp's 32 int32 values, each run over a stream of
// 1024-id waves by one warp to a wave, as K3 and K6 run K1.
//   0  __match_any_sync + __popc + __reduce_max_sync
//   1  a ballot "all equal to lane 0" first, then 0
//   2  a warp bitonic sort of the values (wave_degrees.cuh's, its 15 steps
//      written out), run heads by ballot, run lengths, __reduce_max_sync
//   3  the ballot first, then 2
//   4  2 with the network as two nested loops under #pragma unroll
//   5  each lane counts its value among the group's 32, read back from
//      shared memory four at a time, then __reduce_max_sync
//   6  the ballot first, then 5
//   7  up to four values peeled off by ballot (stopping at one that
//      fills fewer than four lanes), then 2
//   8  a ballot counts the lanes holding lane 0's value: 32 is the
//      degree, four or more take 0, fewer take 2 (repro_k1::
//      max_multiplicity)
//   9  8 on two groups at once, the two sorted in one network in the
//      16-bit halves of a key when both fit: group_pair_max_multiplicity,
//      as K3 runs it
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/wave_degrees.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned by_match(int x) {
  return __reduce_max_sync(0xffffffffu, (unsigned)__popc(__match_any_sync(0xffffffffu, x)));
}

__device__ __forceinline__ bool all_equal(int x) {
  return __all_sync(0xffffffffu, x == __shfl_sync(0xffffffffu, x, 0));
}

__device__ __forceinline__ unsigned by_sort(int x) {
  // the sort alone, as repro_k1::max_multiplicity runs it
  int unused = 0;
  repro_k1::sort_group<repro_k1::Sort::kKeys>(x, unused);
  return repro_k1::longest_run(repro_k1::run_heads(x));
}

__device__ __forceinline__ unsigned by_sort_loops(int key) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(0xffffffffu, key, j);
      const bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_min ? other < key : other > key) key = other;
    }
  }
  return repro_k1::longest_run(repro_k1::run_heads(key));
}

__device__ __forceinline__ unsigned by_peel(int x) {
  unsigned left = 0xffffffffu, most = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int value = __shfl_sync(0xffffffffu, x, __ffs(left) - 1);
    const unsigned same = __ballot_sync(0xffffffffu, x == value);
    const unsigned count = __popc(same);
    most = max(most, count);
    left &= ~same;
    if (left == 0) return most;
    if (count < 4) break;
  }
  return by_sort(x);
}

// scratch: the calling warp's 32 ints of shared memory
__device__ __forceinline__ unsigned by_pairs(int x, int* scratch) {
  const int lane = threadIdx.x & 31;
  scratch[lane] = x;
  __syncwarp();
  unsigned count = 0;
#pragma unroll
  for (int j = 0; j < 32; j += 4) {
    const int4 v = *reinterpret_cast<const int4*>(scratch + j);
    count += (v.x == x) + (v.y == x) + (v.z == x) + (v.w == x);
  }
  __syncwarp();
  return __reduce_max_sync(0xffffffffu, count);
}

template <int kMethod>
__device__ __forceinline__ unsigned degree(int x, int* scratch) {
  if constexpr (kMethod == 0) return by_match(x);
  if constexpr (kMethod == 1) return all_equal(x) ? 32u : by_match(x);
  if constexpr (kMethod == 2) return by_sort(x);
  if constexpr (kMethod == 3) return all_equal(x) ? 32u : by_sort(x);
  if constexpr (kMethod == 4) return by_sort_loops(x);
  if constexpr (kMethod == 5) return by_pairs(x, scratch);
  if constexpr (kMethod == 6) return all_equal(x) ? 32u : by_pairs(x, scratch);
  if constexpr (kMethod == 7) return by_peel(x);
  return repro_k1::max_multiplicity(x, repro_k1::lane0_count(x));
}

template <int kMethod>
__global__ void __launch_bounds__(kThreads)
    degree_kernel(const int* __restrict__ ids, float* __restrict__ deg, int num_waves) {
  __shared__ __align__(16) int scratch[kThreads];
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  int* mine = scratch + (threadIdx.x & ~31);
  for (int w = (blockIdx.x * kThreads + threadIdx.x) / 32; w < num_waves; w += warps) {
    const int* wave = ids + (long long)w * REPRO_LANES;
    unsigned sum = 0;
    if constexpr (kMethod == 9) {
      for (int g = 0; g < REPRO_LANES; g += 64) {
        const uint2 m = group_pair_max_multiplicity(wave[g + lane], wave[g + 32 + lane]);
        sum += m.x + m.y;
      }
    } else {
      for (int g = 0; g < REPRO_LANES; g += 32) sum += degree<kMethod>(wave[g + lane], mine);
    }
    if (lane == 0) deg[w] = (float)sum / 32.0f;
  }
}

template <int kMethod>
int launch(const int* ids, float* deg, int num_waves, cudaStream_t stream) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, degree_kernel<kMethod>,
                                                      kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const long long need = (num_waves + kThreads / 32 - 1) / (kThreads / 32);
  if (grid > need) grid = need;
  degree_kernel<kMethod><<<(unsigned)grid, kThreads, 0, stream>>>(ids, deg, num_waves);
  return (int)cudaGetLastError();
}

// a block's flush of a shared copy whose every entry is 1.0: one global
// atomicAdd per entry
__global__ void flush_kernel(float* __restrict__ out, int cells) {
  for (int i = threadIdx.x; i < cells; i += blockDim.x) atomicAdd(&out[i], 1.0f);
}

}  // namespace

extern "C" {

int bench_degrees(int method, const void* ids, void* deg, int num_waves, void* stream) {
  const int* i = (const int*)ids;
  float* d = (float*)deg;
  cudaStream_t s = (cudaStream_t)stream;
  switch (method) {
    case 0: return launch<0>(i, d, num_waves, s);
    case 1: return launch<1>(i, d, num_waves, s);
    case 2: return launch<2>(i, d, num_waves, s);
    case 3: return launch<3>(i, d, num_waves, s);
    case 4: return launch<4>(i, d, num_waves, s);
    case 5: return launch<5>(i, d, num_waves, s);
    case 6: return launch<6>(i, d, num_waves, s);
    case 7: return launch<7>(i, d, num_waves, s);
    case 8: return launch<8>(i, d, num_waves, s);
    case 9: return launch<9>(i, d, num_waves, s);
  }
  return (int)cudaErrorInvalidValue;
}

int bench_flush(void* out, int cells, int blocks, void* stream) {
  flush_kernel<<<blocks, 1024, 0, (cudaStream_t)stream>>>((float*)out, cells);
  return (int)cudaGetLastError();
}

}  // extern "C"
