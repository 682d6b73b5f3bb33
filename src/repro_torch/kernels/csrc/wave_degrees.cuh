// K1: the per-wave serialization degree, as warp-level device functions.
//
// Replaces src/repro/kernels/instrumentation.py::wave_degrees, which the
// reference inlines into its instrumented Pallas kernels.  A flat index
// stream is cut into waves of LANES = 1024 indices; each wave holds 32
// commit groups of COMMIT_GROUP = 32 consecutive indices.  A group's degree
// is the largest number of its lanes that share one index; a wave's degree
// is the mean of its 32 group degrees.  The instrumented kernels sum a
// wave's 32 group maxima as integers (at most 1024) and divide by 32 once,
// so the f32 result is exact and bit-equal to the reference.
//
// Hopper mapping: one warp is one commit group.  A group's degree:
//   * a ballot counts the lanes holding lane 0's value; 32 is the degree;
//   * if that value fills kMatchLanes = 4 lanes or more, the group holds
//     few values: __match_any_sync + __popc + __reduce_max_sync;
//   * otherwise a bitonic sort of the 32 values across the warp (15
//     compare-exchange steps of __shfl_xor_sync, written out), a ballot of
//     the run heads, each lane's run length from the nearest head at or
//     below it (__clz), and __reduce_max_sync of the run lengths.
// K3 takes a wave's groups in pairs: two groups that both go to the sort,
// each spanning less than 2^16 values, are sorted in one network in the
// 16-bit halves of one key (min.u16x2 / max.u16x2).  K6 sorts (id, lane)
// pairs: the sort leaves each distinct id as a run of lanes with their
// source rows, and K6 adds one sum per run.
//
// Measured cost (tools/bench_degrees.py: CUDA-event medians of a kernel
// that takes every group's degree, one warp to a 1024-id wave, on 4 Mi
// ids; NVIDIA H100 80GB HBM3, 700.00 W), in ms for Tool 1's designed
// patterns e = 1 (32 distinct values a group) / e = 4 / e = 32 (one value):
//   (i)   MATCH.ANY + popc + REDUX           0.0399 / 0.0148 / 0.0081
//   (ii)  ballot "all equal", then (i)       0.0417 / 0.0168 / 0.0111
//   (iii) bitonic sort, run lengths, REDUX   0.0251 / 0.0249 / 0.0249
//         the same as two nested loops under #pragma unroll: 0.0485
//         (440 SASS instructions in the kernel against 272)
//   (ii)+(iii) ballot, then the sort         0.0260 / 0.0259 / 0.0118
//   ballot, then MATCH.ANY or the sort       0.0263 / 0.0170 / 0.0120
//   the same two groups at a time            0.0190 / 0.0161 / 0.0094
// and on K3's committed streams (16 Mi ids, uniform / solid image,
// `hist`): (i) 0.1386 / 0.0277, (iii) 0.0852 / 0.0853, pairs 0.0620 /
// 0.0308.  "A handful of warp instructions" was true only of a group of
// few values: MATCH.ANY's cost grows with the number of distinct values.
//
// Exact for any int32 values: negative strays, unique sentinels and flat
// indices that wrapped in int32 arithmetic compare as signed ints (or, in
// the 16-bit halves, as unsigned offsets from the group's least value),
// and equal values form one run whatever order the sort leaves them in.
#pragma once

#define REPRO_LANES 1024
#define REPRO_COMMIT_GROUP 32

namespace repro_k1 {

constexpr unsigned kFull = 0xffffffffu;

// What a sort moves: int keys; int keys, each with a payload; or two
// independent sorts of unsigned 16-bit keys, one in each half of a word.
enum class Sort { kKeys, kCarry, kHalves };

// One compare-exchange step of the bitonic network: blocks of K lanes,
// partners J lanes apart.  The lower lane of a pair keeps the smaller key
// in an ascending block, the larger in a descending one.  kCarry: a lane
// takes its partner's payload only when it takes a different key, so equal
// keys keep both payloads.  kHalves: min.u16x2 / max.u16x2 compare both
// halves of the words at once.
template <int K, int J, Sort kSort>
__device__ __forceinline__ void sort_step(int& key, int& payload, int lane) {
  const int other = __shfl_xor_sync(kFull, key, J);
  const bool keep_min = ((lane & J) == 0) == ((lane & K) == 0);
  int kept;
  if constexpr (kSort == Sort::kHalves) {
    if (keep_min)
      asm("min.u16x2 %0, %1, %2;" : "=r"(kept) : "r"(key), "r"(other));
    else
      asm("max.u16x2 %0, %1, %2;" : "=r"(kept) : "r"(key), "r"(other));
  } else {
    kept = keep_min ? min(key, other) : max(key, other);
  }
  if constexpr (kSort == Sort::kCarry) {
    const int other_payload = __shfl_xor_sync(kFull, payload, J);
    if (kept != key) payload = other_payload;
  }
  key = kept;
}

// Sorts the warp's 32 keys ascending (signed ints, or each unsigned
// half): the 15 steps of a 32-lane bitonic network, written out.  Every
// lane of the warp must call it together.
template <Sort kSort>
__device__ __forceinline__ void sort_group(int& key, int& payload) {
  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  sort_step<2, 1, kSort>(key, payload, lane);
  sort_step<4, 2, kSort>(key, payload, lane);
  sort_step<4, 1, kSort>(key, payload, lane);
  sort_step<8, 4, kSort>(key, payload, lane);
  sort_step<8, 2, kSort>(key, payload, lane);
  sort_step<8, 1, kSort>(key, payload, lane);
  sort_step<16, 8, kSort>(key, payload, lane);
  sort_step<16, 4, kSort>(key, payload, lane);
  sort_step<16, 2, kSort>(key, payload, lane);
  sort_step<16, 1, kSort>(key, payload, lane);
  sort_step<32, 16, kSort>(key, payload, lane);
  sort_step<32, 8, kSort>(key, payload, lane);
  sort_step<32, 4, kSort>(key, payload, lane);
  sort_step<32, 2, kSort>(key, payload, lane);
  sort_step<32, 1, kSort>(key, payload, lane);
}

// The lanes that start a run of equal keys, after sort_group.
__device__ __forceinline__ unsigned run_heads(int key) {
  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  const int prev = __shfl_up_sync(kFull, key, 1);
  return __ballot_sync(kFull, lane == 0 || prev != key);
}

// The lane that starts the calling lane's run.
__device__ __forceinline__ int run_head(unsigned heads) {
  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  return 31 - __clz(heads & (kFull >> (31 - lane)));
}

// The longest run, the same on every lane.
__device__ __forceinline__ unsigned longest_run(unsigned heads) {
  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  return __reduce_max_sync(kFull, (unsigned)(lane - run_head(heads) + 1));
}

// MATCH.ANY's cost grows with the number of distinct values in a group and
// the sort's does not, so a group whose lane-0 value fills kMatchLanes
// lanes or more (few values: hist2's rotation of one colour, a designed
// pattern of e >= 4) takes MATCH.ANY, and any other the sort.
constexpr unsigned kMatchLanes = 4;

// The lanes that hold lane 0's value.
__device__ __forceinline__ unsigned lane0_count(int index) {
  const int first = __shfl_sync(kFull, index, 0);
  return __popc(__ballot_sync(kFull, index == first));
}

// The degree of a group, given lane0_count: 32 ends there, MATCH.ANY or
// the sort takes the rest.  Both are exact.
__device__ __forceinline__ unsigned max_multiplicity(int index, unsigned count) {
  if (count == REPRO_COMMIT_GROUP) return count;
  if (count >= kMatchLanes)
    return __reduce_max_sync(kFull, (unsigned)__popc(__match_any_sync(kFull, index)));
  int unused = 0;
  sort_group<Sort::kKeys>(index, unused);
  return longest_run(run_heads(index));
}

}  // namespace repro_k1

// The degrees of two groups (a and b on each lane) at once, as K3 takes a
// wave's groups in pairs.  When both go to the sort and each group's values
// span less than 2^16, both are sorted in one network, (a - min a) in the
// low half of a key and (b - min b) in the high half: one shuffle and one
// min or max a step for the two.  Every lane of the warp must call it
// together.
__device__ __forceinline__ uint2 group_pair_max_multiplicity(int a, int b) {
  using namespace repro_k1;
  const unsigned ca = lane0_count(a), cb = lane0_count(b);
  if (ca < kMatchLanes && cb < kMatchLanes) {
    const unsigned oa = (unsigned)a - (unsigned)__reduce_min_sync(kFull, a);
    const unsigned ob = (unsigned)b - (unsigned)__reduce_min_sync(kFull, b);
    if (__reduce_max_sync(kFull, oa | ob) <= 0xffffu) {
      int key = (int)(oa | ob << 16), unused = 0;
      sort_group<Sort::kHalves>(key, unused);
      const unsigned diff = (unsigned)(key ^ __shfl_up_sync(kFull, key, 1));
      const bool first = (threadIdx.x & (REPRO_COMMIT_GROUP - 1)) == 0;
      return make_uint2(longest_run(__ballot_sync(kFull, first || (diff & 0xffffu))),
                        longest_run(__ballot_sync(kFull, first || (diff >> 16))));
    }
  }
  return make_uint2(max_multiplicity(a, ca), max_multiplicity(b, cb));
}
