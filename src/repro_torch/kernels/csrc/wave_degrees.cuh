// K1: the per-wave serialization degree, as a warp-level device function.
//
// Replaces src/repro/kernels/instrumentation.py::wave_degrees, which the
// reference inlines into its instrumented Pallas kernels.  A flat index
// stream is cut into waves of LANES = 1024 indices; each wave holds 32
// commit groups of COMMIT_GROUP = 32 consecutive indices.  A group's degree
// is the largest number of its lanes that share one index; a wave's degree
// is the mean of its 32 group degrees.
//
// Hopper mapping: one warp is one commit group.  __match_any_sync gives each
// lane the mask of lanes holding its index, __popc of that mask is the
// lane's duplicate count, and __reduce_max_sync takes the group's largest.
// The 32 group maxima of a wave are summed as integers (at most 1024) and
// divided by 32 once, so the f32 result is exact and bit-equal to the
// reference whatever order the groups arrive in.
//
// Bound: a handful of warp instructions per commit group, next to the
// image's bytes; it never touches device memory itself.
#pragma once

#define REPRO_LANES 1024
#define REPRO_COMMIT_GROUP 32

// The largest duplicate count of `index` across the 32 lanes of the calling
// warp.  Every lane of the warp must call it together.
__device__ __forceinline__ unsigned group_max_multiplicity(int index) {
  unsigned peers = __match_any_sync(0xffffffffu, index);
  return __reduce_max_sync(0xffffffffu, (unsigned)__popc(peers));
}
