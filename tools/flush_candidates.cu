// Flush candidates for K5 (d = 1, f32, shared route) and K4, timed by
// bench_cas_kernels.py --candidates.  Each kernel adds as the production
// kernel does (scatter_add.cu's scatter_rows, histogram.cu's
// hist_weighted_kernel, both through warp_aggregate.cuh's add_aggregated)
// and then flushes its shared copy in one of two ways:
//   * cluster 1: each block adds its whole copy to the output
//     (repro_agg::flush_copy, what the production kernels do);
//   * cluster 2 or 4: the blocks of a thread-block cluster sum their copies
//     through distributed shared memory, and each block adds only its
//     slice, so the cluster sends one global add per entry, not 2 or 4;
// with as many blocks on an SM as fit, or with at most blocks_per_sm.
// None of these beat the production flush on the H100 (PERF.md).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/warp_aggregate.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;  // both kernels' blocks

template <int kCluster, bool kPadded>
__device__ __forceinline__ void flush(float* acc, float* __restrict__ out, int cells) {
  if constexpr (kCluster == 1) {
    repro_agg::flush_copy<kPadded>(acc, out, cells);
  } else {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every block's copy is complete
    float* ranks[kCluster];
#pragma unroll
    for (int r = 0; r < kCluster; ++r) ranks[r] = cluster.map_shared_rank(acc, r);
    const int per = (cells + kCluster - 1) / kCluster;
    const int lo = (int)cluster.block_rank() * per, hi = min(cells, lo + per);
    for (int i = lo + (int)threadIdx.x; i < hi; i += blockDim.x) {
      const int slot = repro_agg::slot_of<kPadded>(i);
      float v = 0.0f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) v += ranks[r][slot];
      if (v != 0.0f) atomicAdd(&out[i], v);
    }
    cluster.sync();  // no block leaves while another reads its copy
  }
}

// K5 at d = 1 on the shared route, f32 values (scatter_rows' loop).
template <int kCluster>
__global__ void __launch_bounds__(kThreads)
    k5_rows_kernel(const float* __restrict__ values, const int* __restrict__ ids,
                   float* __restrict__ out, int n, int num_segments) {
  __shared__ float scratch[kThreads];
  extern __shared__ __align__(16) float acc[];
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) acc[i] = 0.0f;
  __syncthreads();
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = (blockIdx.x * kThreads + threadIdx.x) / 32;
  const unsigned step = gridDim.x * kThreads;
  unsigned row = warp * 32 + lane;
  int id = row < (unsigned)n ? ids[row] : -1;
  float v = row < (unsigned)n ? values[row] : 0.0f;
  bool hot = false;
  for (unsigned base = warp * 32; base < (unsigned)n; base += step) {
    const unsigned next = row + step;
    const int next_id = next < (unsigned)n ? ids[next] : -1;
    const float next_v = next < (unsigned)n ? values[next] : 0.0f;
    repro_agg::add_aggregated<false>(acc, id, v, (unsigned)num_segments, hot,
                                     scratch + (threadIdx.x & ~31u));
    row = next;
    id = next_id;
    v = next_v;
  }
  flush<kCluster, false>(acc, out, num_segments);
}

// K4 (hist_weighted_kernel's loop).
template <bool kReorder, int kCluster>
__global__ void __launch_bounds__(kThreads)
    k4_kernel(const int* __restrict__ img, const float* __restrict__ weights,
              float* __restrict__ out, long long n, long long num_chunks, int C, int num_bins,
              int tile) {
  __shared__ float scratch[kThreads];
  extern __shared__ __align__(16) float sums[];
  const int bins = C * num_bins;
  for (int i = threadIdx.x; i < repro_agg::padded_slot(bins); i += blockDim.x) sums[i] = 0.0f;
  __syncthreads();
  float* const warp_scratch = scratch + (threadIdx.x & ~31u);
  bool hot = false;
  for (long long chunk = blockIdx.x; chunk < num_chunks; chunk += gridDim.x) {
    const long long p = chunk * kThreads + threadIdx.x;
    const bool real = p < n;
    const float w = real ? weights[p] : 0.0f;
    int ch = kReorder ? (int)((unsigned)p % (unsigned)tile % (unsigned)C) : 0;
    bool contended = hot;
    for (int s = 0; s < C; ++s, ch = ch + 1 == C ? 0 : ch + 1) {
      const int v = real ? img[p * C + ch] : 0;
      const int flat = real ? (int)((unsigned)ch * (unsigned)num_bins + (unsigned)v) : -1;
      if (s == 0 && !contended)
        contended = (unsigned)__popc(__ballot_sync(
                        repro_k1::kFull, flat == __shfl_sync(repro_k1::kFull, flat, 0))) >=
                    repro_k1::kMatchLanes;
      if (contended)
        repro_agg::add_aggregated<true>(sums, flat, w, (unsigned)bins, hot, warp_scratch);
      else if ((unsigned)flat < (unsigned)bins)
        atomicAdd(&sums[repro_agg::padded_slot(flat)], w);
    }
  }
  flush<kCluster, true>(sums, out, bins);
}

// Launches kernel on as many blocks as fit on the card (at most
// blocks_per_sm an SM when it is > 0), no more than `work`, rounded to a
// whole number of clusters of kCluster blocks.
template <int kCluster, typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long work, int blocks_per_sm, size_t smem,
           void* stream, Args... args) {
  cudaError_t err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (blocks_per_sm > 0 && per_sm > blocks_per_sm) per_sm = blocks_per_sm;
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > work) grid = work;
  grid = (grid + kCluster - 1) / kCluster * kCluster;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3((unsigned)kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  if (kCluster > 1) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    config.attrs = attr;
    config.numAttrs = 1;
  }
  err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int kCluster>
int k5(const void* values, const void* ids, void* out, int n, int num_segments,
       int blocks_per_sm, void* stream) {
  return launch<kCluster>(k5_rows_kernel<kCluster>, (n + kThreads - 1LL) / kThreads,
                          blocks_per_sm, (size_t)num_segments * 4, stream,
                          (const float*)values, (const int*)ids, (float*)out, n,
                          num_segments);
}

template <bool kReorder, int kCluster>
int k4(const void* img, const void* weights, void* out, int n, int C, int num_bins, int tile,
       int blocks_per_sm, void* stream) {
  const int bins = C * num_bins;
  const long long chunks = (n + kThreads - 1LL) / kThreads;
  return launch<kCluster>(k4_kernel<kReorder, kCluster>, chunks, blocks_per_sm,
                          (size_t)(bins + (bins >> 5)) * 4, stream, (const int*)img,
                          (const float*)weights, (float*)out, (long long)n, chunks, C,
                          num_bins, tile);
}

template <int kCluster>
int k4_either(const void* img, const void* weights, void* out, int n, int C, int num_bins,
              int tile, int reorder, int blocks_per_sm, void* stream) {
  return reorder ? k4<true, kCluster>(img, weights, out, n, C, num_bins, tile, blocks_per_sm,
                                      stream)
                 : k4<false, kCluster>(img, weights, out, n, C, num_bins, tile, blocks_per_sm,
                                       stream);
}

}  // namespace

extern "C" {

// As repro_scatter_add at d = 1, f32, on the shared route; cluster 1, 2 or 4.
int candidate_k5(const void* values, const void* ids, void* out, int n, int num_segments,
                 int cluster, int blocks_per_sm, void* stream) {
  switch (cluster) {
    case 1: return k5<1>(values, ids, out, n, num_segments, blocks_per_sm, stream);
    case 2: return k5<2>(values, ids, out, n, num_segments, blocks_per_sm, stream);
    case 4: return k5<4>(values, ids, out, n, num_segments, blocks_per_sm, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// As repro_hist_weighted; cluster 1, 2 or 4.
int candidate_k4(const void* img, const void* weights, void* out, int n, int C, int num_bins,
                 int tile, int reorder, int cluster, int blocks_per_sm, void* stream) {
  switch (cluster) {
    case 1: return k4_either<1>(img, weights, out, n, C, num_bins, tile, reorder, blocks_per_sm, stream);
    case 2: return k4_either<2>(img, weights, out, n, C, num_bins, tile, reorder, blocks_per_sm, stream);
    case 4: return k4_either<4>(img, weights, out, n, C, num_bins, tile, reorder, blocks_per_sm, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
