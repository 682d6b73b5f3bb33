// K7 candidates, timed by bench_bincount.py --candidates.  Each counts as
// the production kernel does (src/repro_torch/kernels/csrc/bincount.cuh:
// 16-byte loads, kLoads of them in flight a thread, the POPC increment
// into a shared copy) and differs in how many blocks it runs and how it
// flushes:
//   * candidate_grid (out zeroed by the caller, or by a cudaMemsetAsync
//     in the launcher): blocks on every SM, at most blocks_per_sm on each
//     and no more than give each thread words_per_thread 16-byte words
//     (ids, where the loads are scalar or the blocks take contiguous
//     ranges of words), in thread-block clusters of 1, 2,
//     4 or 8.  A cluster's blocks sum their copies through distributed
//     shared memory (rank r takes bins [r S / c, (r + 1) S / c) of every
//     rank's copy, between two cluster.sync()) and add one global atomic
//     per non-zero bin and cluster; a cluster of 1 adds its whole copy,
//     starting at bin 0 or, rotated, at bin b S / grid, or two bins at a
//     time with one 64-bit atomic add;
//   * candidate_one: a grid of one cluster of 1, 2, 4 or 8 blocks, each
//     with 1 to 32 shared copies (one for each group of 32 / copies
//     warps), that stores every bin (out unzeroed);
//   * candidate_cooperative: one cooperative launch in two phases.  Each
//     block stores its copy to scratch (grid x S ints); after a grid-wide
//     sync each block sums a slice of the bins over all copies and stores
//     it: no global atomic and no zeroed out;
//   * candidate_pdl: the grid route with the output zeroed by a kernel of
//     its own that lets the counting kernel start before it ends
//     (programmatic dependent launch); the counting waits only before
//     its flush;
//   * candidate_red: global int32 atomic adds alone, the flush's
//     instruction (RED.E.ADD.STRONG.GPU), reds_per_thread from each
//     thread of one 1024-thread block an SM onto S addresses in no order,
//     to measure the rate of L2's atomic unit.
// PERF.md has their times.  The production kernel (scatter_add.cu's
// bincount_kernel) took candidate_pdl's design with the largest carveout;
// every other candidate lost to it or to an earlier production design
// (a memset, then a range of words a block): clusters and the cooperative
// launch by 1-4 us.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "../src/repro_torch/kernels/csrc/bincount.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 1024;
constexpr int kCopyBytes = 32 * 1024;

// The grid route's flushes (a cluster of 1): every bin from bin 0, from a
// rotated start, or two bins at once with a 64-bit atomic add.
enum Flush { kPlain = 0, kRotated = 1, kPairs = 2 };

// Counts this thread's share of ids[0, n): kLoads 0, one scalar id at a
// time, as the first CUDA version of K7 read them; otherwise 16-byte
// loads, kLoads in flight, either block by block in contiguous ranges
// (kRange, the production kernel's count_ids) or strided over the whole
// grid (thread t of T takes words t, t + T, ...).
template <int kLoads, bool kRange>
__device__ __forceinline__ void count_any(int* counts, const int* __restrict__ ids, unsigned n,
                                          unsigned num_segments) {
  const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned threads = gridDim.x * blockDim.x;
  if constexpr (kLoads == 0) {
    for (unsigned i = t; i < n; i += threads) repro_k7::count(counts, __ldg(ids + i), num_segments);
  } else if constexpr (kRange) {
    repro_k7::count_ids<kLoads>(counts, ids, n, num_segments);
  } else {
    unsigned head = (unsigned)((16 - ((uintptr_t)ids & 15)) & 15) / 4;
    if (head > n) head = n;
    const unsigned words = (n - head) / repro_k7::kWordIds;
    const unsigned tail = head + words * repro_k7::kWordIds;
    if (t < head) repro_k7::count(counts, __ldg(ids + t), num_segments);
    if (t < n - tail) repro_k7::count(counts, __ldg(ids + tail + t), num_segments);
    const int4* body = reinterpret_cast<const int4*>(ids + head);
    for (unsigned w = t; w < words; w += kLoads * threads) {
      int4 v[kLoads];
#pragma unroll
      for (int k = 0; k < kLoads; ++k) {
        const unsigned i = w + k * threads;
        v[k] = i < words ? __ldg(body + i) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int k = 0; k < kLoads; ++k) repro_k7::count4(counts, v[k], num_segments);
    }
  }
}

template <int kCluster, int kLoads, int kFlush, bool kRange>
__global__ void __launch_bounds__(kThreads, 1)
    grid_kernel(const int* __restrict__ ids, int* __restrict__ out, int n, int num_segments) {
  extern __shared__ __align__(16) int counts[];
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  count_any<kLoads, kRange>(counts, ids, (unsigned)n, (unsigned)num_segments);
  if constexpr (kCluster > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every copy of the cluster is complete
    const int per = (num_segments + kCluster - 1) / kCluster;
    const int lo = (int)cluster.block_rank() * per, hi = min(num_segments, lo + per);
    for (int i = lo + (int)threadIdx.x; i < hi; i += blockDim.x) {
      int sum = 0;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) sum += cluster.map_shared_rank(counts, r)[i];
      if (sum != 0) atomicAdd(&out[i], sum);
    }
    cluster.sync();  // no copy is read after its block leaves
  } else if constexpr (kFlush == kPairs) {
    // bins 2i and 2i + 1 in one 64-bit add: a count is below 2^31, so the
    // low word never carries into the high one (out 8-byte aligned)
    __syncthreads();
    const int pairs = num_segments / 2;
    unsigned long long* out2 = reinterpret_cast<unsigned long long*>(out);
    for (int i = threadIdx.x; i < pairs; i += blockDim.x) {
      const unsigned long long lo = (unsigned)counts[2 * i], hi = (unsigned)counts[2 * i + 1];
      if (lo | hi) atomicAdd(&out2[i], lo | hi << 32);
    }
    if (threadIdx.x == 0 && (num_segments & 1) && counts[num_segments - 1] != 0)
      atomicAdd(&out[num_segments - 1], counts[num_segments - 1]);
  } else {
    __syncthreads();
    const int start = kFlush == kRotated
                          ? (int)(blockIdx.x * (unsigned)num_segments / gridDim.x) & ~31
                          : 0;
    for (int j = threadIdx.x; j < num_segments; j += blockDim.x) {
      const int i = j + start < num_segments ? j + start : j + start - num_segments;
      const int c = counts[i];
      if (c != 0) atomicAdd(&out[i], c);
    }
  }
}

template <int kCluster, int kLoads>
__global__ void __launch_bounds__(kThreads, 1)
    one_kernel(const int* __restrict__ ids, int* __restrict__ out, int n, int num_segments,
               int copies) {
  extern __shared__ __align__(16) int counts[];
  for (int i = threadIdx.x; i < copies * num_segments; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  const int copy = (int)(threadIdx.x / 32) * copies / (int)(blockDim.x / 32);
  count_any<kLoads, false>(counts + copy * num_segments, ids, (unsigned)n,
                           (unsigned)num_segments);
  int rank = 0;
  if constexpr (kCluster > 1) {
    cg::this_cluster().sync();
    rank = (int)cg::this_cluster().block_rank();
  } else {
    __syncthreads();
  }
  const int per = (num_segments + kCluster - 1) / kCluster;
  const int lo = rank * per, hi = min(num_segments, lo + per);
  for (int i = lo + (int)threadIdx.x; i < hi; i += blockDim.x) {
    int sum = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) {
      const int* src = counts;
      if constexpr (kCluster > 1) src = cg::this_cluster().map_shared_rank(counts, r);
      for (int c = 0; c < copies; ++c) sum += src[c * num_segments + i];
    }
    out[i] = sum;
  }
  if constexpr (kCluster > 1) cg::this_cluster().sync();
}

__global__ void __launch_bounds__(kThreads, 1)
    cooperative_kernel(const int* __restrict__ ids, int* __restrict__ out,
                       int* __restrict__ scratch, int n, int num_segments) {
  extern __shared__ __align__(16) int counts[];
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  count_any<4, false>(counts, ids, (unsigned)n, (unsigned)num_segments);
  __syncthreads();
  int* mine = scratch + (size_t)blockIdx.x * num_segments;
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) mine[i] = counts[i];
  cg::this_grid().sync();
  // block b sums bins [lo, lo + per) over every block's copy, in shared
  const int per = (num_segments + gridDim.x - 1) / gridDim.x;
  const int lo = blockIdx.x * per;
  const int width = min(per, num_segments - lo);
  if (width <= 0) return;
  for (int i = threadIdx.x; i < width; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  for (int j = threadIdx.x; j < width * (int)gridDim.x; j += blockDim.x) {
    const int b = j / width, i = j - b * width;
    const int v = __ldcg(scratch + (size_t)b * num_segments + lo + i);
    if (v != 0) atomicAdd(&counts[i], v);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < width; i += blockDim.x) out[lo + i] = counts[i];
}

// Programmatic dependent launch: zero_kernel lets its dependent start at
// once, and pdl_kernel (the production kernel's count, a contiguous range
// of words a block, 2 loads in flight) waits for it, that is for out to be
// zeroed, only before its flush.
__global__ void zero_kernel(int* __restrict__ out, int num_segments) {
  asm volatile("griddepcontrol.launch_dependents;");
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < num_segments;
       i += gridDim.x * blockDim.x)
    out[i] = 0;
}

__global__ void __launch_bounds__(kThreads, 1)
    pdl_kernel(const int* __restrict__ ids, int* __restrict__ out, int n, int num_segments) {
  extern __shared__ __align__(16) int counts[];
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  repro_k7::count_ids<2>(counts, ids, (unsigned)n, (unsigned)num_segments);
  __syncthreads();
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) {
    const int c = counts[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    red_kernel(int* __restrict__ out, int num_segments, int reds_per_thread) {
  unsigned a = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u;
  for (int k = 0; k < reds_per_thread; ++k) {
    atomicAdd(&out[a % (unsigned)num_segments], 1);
    a += 40503u;
  }
}

int sms_of_device(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, int cluster, int grid, size_t smem, void* stream, Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = cluster > 1 ? 1 : 0;  // cluster 1: a plain launch
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

template <int kCluster, int kLoads, int kFlush, bool kRange = false>
int grid_route(const void* ids, void* out, int n, int num_segments, int blocks_per_sm,
               int words_per_thread, int memset, void* stream) {
  auto kernel = grid_kernel<kCluster, kLoads, kFlush, kRange>;
  const size_t smem = (size_t)num_segments * sizeof(int);
  int sms = 0, per_sm = 0;
  if (int e = sms_of_device(&sms)) return e;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm > blocks_per_sm) per_sm = blocks_per_sm;
  long long grid = (long long)sms * per_sm / kCluster * kCluster;
  // words_per_thread of 16 bytes, or of ids where the loads are scalar or
  // the blocks take ranges
  const long long per_block =
      (long long)kThreads * words_per_thread * (kLoads && !kRange ? 4 : 1);
  const long long need = ((n + per_block - 1) / per_block + kCluster - 1) / kCluster * kCluster;
  if (grid > need) grid = need;
  if (grid < kCluster) grid = kCluster;
  if (memset) {  // the launcher zeroes out, not the caller
    err = cudaMemsetAsync(out, 0, (size_t)num_segments * sizeof(int), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return launch(kernel, kCluster, (int)grid, smem, stream, (const int*)ids, (int*)out, n,
                num_segments);
}

template <int kCluster, int kFlush>
int grid_loads(const void* ids, void* out, int n, int num_segments, int blocks_per_sm,
               int loads, int words_per_thread, int memset, int range, void* stream) {
  switch (loads * 2 + (range ? 1 : 0)) {
    case 0: return grid_route<kCluster, 0, kFlush>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 2: return grid_route<kCluster, 1, kFlush>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 3: return grid_route<kCluster, 1, kFlush, true>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 4: return grid_route<kCluster, 2, kFlush>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 5: return grid_route<kCluster, 2, kFlush, true>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 8: return grid_route<kCluster, 4, kFlush>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 9: return grid_route<kCluster, 4, kFlush, true>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 16: return grid_route<kCluster, 8, kFlush>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int kCluster, int kLoads>
int one_route(const void* ids, void* out, int n, int num_segments, int max_copies,
              void* stream) {
  int copies = num_segments > 0 ? kCopyBytes / (num_segments * 4) : 1;
  copies = copies > max_copies ? max_copies : copies;
  copies = copies > 32 ? 32 : (copies < 1 ? 1 : copies);
  return launch(one_kernel<kCluster, kLoads>, kCluster, kCluster,
                (size_t)copies * num_segments * sizeof(int), stream, (const int*)ids, (int*)out,
                n, num_segments, copies);
}

}  // namespace

extern "C" {

// The grid route: out (num_segments,) int32, zeroed by the caller, or by
// cudaMemsetAsync here when memset is 1; cluster 1, 2, 4 or 8 (flush 0
// only); loads 0 (scalar), 1, 2, 4 or 8; flush 0 (plain), 1 (rotated) or
// 2 (64-bit pairs, out 8-byte aligned); range 1 (loads 1, 2 or 4): each
// block takes a contiguous range of words, as the production kernel does,
// and words_per_thread counts ids.
int candidate_grid(const void* ids, void* out, int n, int num_segments, int cluster,
                   int blocks_per_sm, int loads, int flush, int words_per_thread, int memset,
                   int range, void* stream) {
  if (cluster > 1 && (flush != kPlain || range)) return (int)cudaErrorInvalidValue;
  switch (cluster * 10 + flush) {
    case 10: return grid_loads<1, kPlain>(ids, out, n, num_segments, blocks_per_sm, loads, words_per_thread, memset, range, stream);
    case 11: return grid_loads<1, kRotated>(ids, out, n, num_segments, blocks_per_sm, loads, words_per_thread, memset, range, stream);
    case 12: return grid_loads<1, kPairs>(ids, out, n, num_segments, blocks_per_sm, loads, words_per_thread, memset, range, stream);
    case 20: return grid_route<2, 4, kPlain>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 40: return grid_route<4, 4, kPlain>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
    case 80: return grid_route<8, 4, kPlain>(ids, out, n, num_segments, blocks_per_sm, words_per_thread, memset, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// One cluster that stores every bin: cluster 1, 2, 4 or 8 blocks (loads
// 4), or one block with loads 8.
int candidate_one(const void* ids, void* out, int n, int num_segments, int cluster, int loads,
                  int max_copies, void* stream) {
  switch (cluster * 100 + loads) {
    case 104: return one_route<1, 4>(ids, out, n, num_segments, max_copies, stream);
    case 108: return one_route<1, 8>(ids, out, n, num_segments, max_copies, stream);
    case 204: return one_route<2, 4>(ids, out, n, num_segments, max_copies, stream);
    case 404: return one_route<4, 4>(ids, out, n, num_segments, max_copies, stream);
    case 804: return one_route<8, 4>(ids, out, n, num_segments, max_copies, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The cooperative candidate; scratch: (grid, num_segments) int32, where
// grid is blocks_per_sm blocks on each SM (at most what fits); the
// needed size is returned in *grid_out when scratch is null.
int candidate_cooperative(const void* ids, void* out, void* scratch, int n, int num_segments,
                          int blocks_per_sm, int* grid_out, void* stream) {
  const size_t smem = (size_t)num_segments * sizeof(int);
  int sms = 0, per_sm = 0;
  if (int e = sms_of_device(&sms)) return e;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cooperative_kernel,
                                                                  kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm > blocks_per_sm) per_sm = blocks_per_sm;
  const int grid = sms * per_sm;
  if (scratch == nullptr) {
    *grid_out = grid;
    return 0;
  }
  if (*grid_out != grid) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, cooperative_kernel, (const int*)ids, (int*)out, (int*)scratch,
                           n, num_segments);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// The grid route with programmatic dependent launch: zero_kernel, then
// pdl_kernel on one block an SM, at most one id a thread, allowed to start
// before zero_kernel ends.  out's contents before the call do not matter.
// carveout 1: both kernels prefer the largest shared-memory carveout; 2:
// the zero kernel also asks for the counting kernel's dynamic shared
// memory, so that an SM need not change its carveout between them.
int candidate_pdl(const void* ids, void* out, int n, int num_segments, int carveout,
                  void* stream) {
  cudaError_t err;
  if (carveout == 1) {
    for (const void* f : {(const void*)zero_kernel, (const void*)pdl_kernel}) {
      err = cudaFuncSetAttribute(f, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return (int)err;
    }
  }
  const size_t zero_smem = carveout == 2 ? (size_t)num_segments * sizeof(int) : 0;
  zero_kernel<<<1, kThreads, zero_smem, (cudaStream_t)stream>>>((int*)out, num_segments);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  if (int e = sms_of_device(&sms)) return e;
  long long grid = (n + kThreads - 1LL) / kThreads;
  grid = grid > sms ? sms : (grid < 1 ? 1 : grid);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((unsigned)grid);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = (size_t)num_segments * sizeof(int);
  config.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, pdl_kernel, (const int*)ids, (int*)out, n, num_segments);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// reds_per_thread global int32 atomic adds from each of one 1024-thread
// block an SM, onto num_segments addresses of out.
int candidate_red(void* out, int num_segments, int reds_per_thread, void* stream) {
  int sms = 0;
  if (int e = sms_of_device(&sms)) return e;
  red_kernel<<<sms, kThreads, 0, (cudaStream_t)stream>>>((int*)out, num_segments,
                                                          reds_per_thread);
  return (int)cudaGetLastError();
}

}  // extern "C"
