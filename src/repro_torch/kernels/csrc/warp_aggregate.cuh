// Warp-aggregated f32 adds and the flush of a shared copy, for K4
// (hist_weighted_kernel) and K5 (scatter_rows_kernel, scatter_tiles_kernel).
//
// A float atomicAdd on shared memory has no opcode on Hopper: it is a CAS
// loop (ATOMS.CAST.SPIN), and the lanes of a warp that hold one address
// retry one after another.  add_aggregated sums the values of equal keys
// within the warp first and adds each sum once:
//   * a ballot counts the lanes that hold lane 0's key; when that is all
//     32 (a solid image, a solid id stream), a butterfly of five
//     __shfl_xor_sync sums them;
//   * when it is kMatchLanes (K1's threshold) or more, or when the warp's
//     last such call found a key on that many lanes (`hot`: a skewed
//     stream, whose hot key lane 0 does not always hold), the warp holds
//     few keys: __match_any_sync finds each key's lanes, and the lowest
//     of them sums their values from the warp's 32 words of shared scratch
//     (a loop of loads, all keys at once) and adds once, all keys in one
//     atomic instruction.  A butterfly a key, a ballot a key, sums carried
//     in registers between calls and four copies of K4's histogram were
//     each slower on the H100 (PERF.md);
//   * otherwise (distinct keys: uniform data) each lane adds its own value,
//     and the warp has paid one shuffle and one ballot.
// Every value is f32 before any sum.  A key outside [0, limit), negative
// ones included, is never added: it may join its own equal keys, but the
// one unsigned compare before each add drops the sum.  Every lane of the
// warp must call it together, with a neutral update (a key outside the
// range) for a lane that has none.
#pragma once

#include "wave_degrees.cuh"

namespace repro_agg {

using repro_k1::kFull;

// The sum over the warp of v, on every lane.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// The shared word of entry i in a padded copy: a word of padding after
// each 32, so that entries 32 * k apart (K4's bins of one value in the C
// channels, num_bins apart) fall in different banks.
__device__ __forceinline__ int padded_slot(int i) {
  return (int)((unsigned)i + ((unsigned)i >> 5));
}

// The word of a key's sum: the key, or padded_slot(key) in a padded copy.
template <bool kPadded>
__device__ __forceinline__ int slot_of(int key) {
  return kPadded ? padded_slot(key) : key;
}

// Adds v at dst[slot_of(key)] for each lane.  hot is the warp's state
// between calls, the same on every lane, false at first; scratch is the
// warp's 32 words of shared memory.
template <bool kPadded>
__device__ __forceinline__ void add_aggregated(float* dst, int key, float v, unsigned limit,
                                               bool& hot, float* scratch) {
  const int lane = threadIdx.x & 31;
  const bool keep = (unsigned)key < limit;
  const int key0 = __shfl_sync(kFull, key, 0);
  const unsigned same = __ballot_sync(kFull, key == key0);
  if (same == kFull) {
    const float sum = warp_sum(v);
    if (lane == 0 && keep) atomicAdd(&dst[slot_of<kPadded>(key)], sum);
    return;
  }
  if (!hot && (unsigned)__popc(same) < repro_k1::kMatchLanes) {
    if (keep) atomicAdd(&dst[slot_of<kPadded>(key)], v);
    return;
  }
  const unsigned peers = __match_any_sync(kFull, key);
  hot = __reduce_max_sync(kFull, (unsigned)__popc(peers)) >= repro_k1::kMatchLanes;
  // each key's lowest lane sums its lanes' values, in lane order, through
  // the warp's scratch words
  scratch[lane] = v;
  __syncwarp();
  float sum = 0.0f;
  if (__ffs(peers) - 1 == lane)
    for (unsigned m = peers; m; m &= m - 1) sum += scratch[__ffs(m) - 1];
  __syncwarp();
  if (keep && __ffs(peers) - 1 == lane) atomicAdd(&dst[slot_of<kPadded>(key)], sum);
}

// Adds a block's shared copy of out[0, cells) (padded_slot's layout when
// kPadded) into out, skipping zeros.  Every thread of the block calls it
// once, after its last shared add.  (A thread-block-cluster flush through
// distributed shared memory and one block an SM each cost more than they
// save: tools/flush_candidates.cu, PERF.md.)
template <bool kPadded = false>
__device__ __forceinline__ void flush_copy(const float* acc, float* __restrict__ out,
                                           int cells) {
  __syncthreads();
  for (int i = (int)threadIdx.x; i < cells; i += blockDim.x) {
    const float v = acc[slot_of<kPadded>(i)];
    if (v != 0.0f) atomicAdd(&out[i], v);
  }
}

}  // namespace repro_agg
