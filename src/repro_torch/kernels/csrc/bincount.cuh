// K7's block: int32 occurrence counts of int32 ids in a shared copy, then
// its flush.  Used by scatter_add.cu's bincount_kernel and by
// tools/bincount_candidates.cu.
//
//   * Loads: one id a thread while the grid has a thread for each (a short
//     stream then spreads over many SMs, whose shared atomics run side by
//     side); beyond that, 16 bytes a thread (LDG.E.128.CONSTANT, the
//     read-only path), kLoads of them issued before the first is counted.
//     Each block takes one contiguous range of the aligned body's 16-byte
//     words, and neighbouring threads read neighbouring words.  The ids
//     before the first 16-byte boundary (a view such as ids[1:] starts 4
//     bytes into a word) and the n % 4 after the last whole word are
//     counted one by one by block 0's first threads.
//   * Counting: atomicAdd of 1 with the result unused, which compiles to
//     the POPC increment (ATOMS.POPC.INC.32): the hardware merges the lanes
//     of a warp that hold one address into one increment, so a solid or
//     skewed stream needs no aggregation in software.  An id outside
//     [0, S), negatives included, fails one unsigned compare before any
//     access.
//   * Flush: kStore, the grid is one block, which stores all S counts
//     (whatever out held before); otherwise every block adds each count
//     that is not 0 to out with one global atomic, after waiting
//     (griddepcontrol.wait) for the kernel that zeroes out, which lets
//     this one start at once (programmatic dependent launch): the count
//     runs while out is zeroed.
#pragma once

#include <cstdint>

namespace repro_k7 {

constexpr int kWordIds = 4;  // ids in one 16-byte load

__device__ __forceinline__ void count(int* counts, int id, unsigned num_segments) {
  if ((unsigned)id < num_segments) atomicAdd(&counts[id], 1);
}

__device__ __forceinline__ void count4(int* counts, int4 v, unsigned num_segments) {
  count(counts, v.x, num_segments);
  count(counts, v.y, num_segments);
  count(counts, v.z, num_segments);
  count(counts, v.w, num_segments);
}

// Counts this block's share of ids[0, n) into counts.  While the grid has
// a thread for each id, thread t counts id t.  Otherwise block b of G takes
// the aligned body's 16-byte words [b W, (b + 1) W), W = ceil(words / G),
// its threads neighbouring words, kLoads at a time a thread; block 0 also
// takes the scalar head and tail.  ids is 4-byte aligned; n < 2^31
// (checked by the host).
template <int kLoads>
__device__ __forceinline__ void count_ids(int* counts, const int* __restrict__ ids, unsigned n,
                                          unsigned num_segments) {
  if (n <= gridDim.x * blockDim.x) {  // a thread for each id
    const unsigned t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < n) count(counts, __ldg(ids + t), num_segments);
    return;
  }
  unsigned head = (unsigned)((16 - ((uintptr_t)ids & 15)) & 15) / 4;
  if (head > n) head = n;
  const unsigned words = (n - head) / kWordIds;
  const unsigned tail = head + words * kWordIds;
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) count(counts, __ldg(ids + threadIdx.x), num_segments);
    if (threadIdx.x < n - tail) count(counts, __ldg(ids + tail + threadIdx.x), num_segments);
  }
  const unsigned per = (words + gridDim.x - 1) / gridDim.x;
  const unsigned lo = blockIdx.x * per, hi = min(words, lo + per);
  const int4* body = reinterpret_cast<const int4*>(ids + head);
  for (unsigned w = lo + threadIdx.x; w < hi; w += kLoads * blockDim.x) {
    int4 v[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const unsigned i = w + k * blockDim.x;
      v[k] = i < hi ? __ldg(body + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int k = 0; k < kLoads; ++k) count4(counts, v[k], num_segments);
  }
}

// Zeroes the block's copy, counts its share of the ids into it and flushes
// it (see the file's head).  counts: num_segments ints of shared memory.
template <bool kStore, int kLoads>
__device__ __forceinline__ void bincount_block(int* counts, const int* __restrict__ ids,
                                               int* __restrict__ out, int n, int num_segments) {
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  count_ids<kLoads>(counts, ids, (unsigned)n, (unsigned)num_segments);
  __syncthreads();
  // out is zeroed by the grid this one was launched to depend on; wait for
  // it to end (at once when there is none)
  if constexpr (!kStore) asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int i = threadIdx.x; i < num_segments; i += blockDim.x) {
    const int c = counts[i];
    if constexpr (kStore) {
      out[i] = c;
    } else if (c != 0) {
      atomicAdd(&out[i], c);
    }
  }
}

}  // namespace repro_k7
