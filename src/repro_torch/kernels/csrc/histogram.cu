// K2, K3 and K4: per-channel image histograms with shared-memory atomics.
//
// Replaces, in src/repro/kernels/histogram/kernel.py:
//   K2  _hist_kernel               (counts; `hist` and `hist2`)
//   K3  _hist_instrumented_kernel  (K2 plus K1's per-wave degrees)
//   K4  _hist_weighted_kernel      (f32 sums of a per-pixel weight)
// The TPU kernels commit each tile with a one-hot reduction into a VMEM
// accumulator.  On Hopper K2 and K3 become what they were in the paper
// (Listings 1-2): each block keeps a C x num_bins sub-histogram in shared
// memory, every thread atomicAdds its pixel's channels into it, and the
// block flushes its non-zero bins to the global result with atomicAdd.
// K4 sums its f32 weights the same way, but equal bins within a warp first
// (warp_aggregate.cuh), into a padded copy.
//
// Semantics kept from the reference:
//   * The TPU tile (2048 pixels) is semantics, not a block size: `hist2`
//     rotates pixel p's channel by its row within the tile,
//     ch = (s + p % tile) % C, and the degrees cover N padded up to a whole
//     tile.  The CUDA block size is free.
//   * Padding pixels are zeros.  K3 counts them in the degrees (as the
//     reference's kernel and committed_index_stream do) but never in the
//     histogram; K2 and K4 simply stop at the last real pixel.
//   * A value is dropped only when its flat index ch * num_bins + v falls
//     outside [0, C * num_bins): a value >= num_bins inside that range lands
//     in the next channel's bins.  The same check keeps every write in
//     bounds, and comes before any sum.  The flat index wraps like the
//     reference's int32 arithmetic.
//
// K2 keeps one shared atomic per pixel and channel step, on purpose: its
// hist/hist2 contrast is the contention the paper models and the tool
// diagnoses (a solid image sends all 32 lanes of a warp to one bin), and
// the design does nothing to hide that; the wide shared accumulator keeps
// the global atomics to one flush per block.  K4 may aggregate: the model's
// counters come from K1's degrees of the committed stream (K3's, or the
// trace provider's), never from K4's time or atomic traffic, and the
// reference sums with one-hot products, with no atomics.  Its sums are the
// same up to the order of the f32 adds.
//
// Bound on an H100: bytes.  Each pixel's C int32 channels are read once
// (67.1 MB for the 4 Mpx x 4 channel case-study image, about 20 us at
// 3.35 TB/s; K4 adds 4 bytes of weight a pixel).  What the data can make
// slow is the shared-memory atomic unit: K2 and K3 count with the POPC
// increment, and K4's f32 add is a CAS loop.  Measured on an NVIDIA H100
// 80GB HBM3 at 700.00 W (chip_smoke.py, the 4 Mpx x 4 image; ms, bound in
// brackets): K2 0.0321 solid, 0.0383 uniform (0.0200); K3 0.0425 solid,
// 0.0826 uniform (0.0201); K4 0.0575 solid and 0.1247 solid `hist2`,
// 0.0599 uniform (0.0250).  PERF.md has every case.
//
// K3's degrees: the reference commits channel step s of a 32-pixel group
// together, so commit group q of the stream is step q % C of pixel group
// q / C, and wave w holds groups 32w .. 32w + 31.  K3 gives each warp whole
// waves: it walks a wave's 32 groups in that order, does each group's 32
// count atomics exactly as K2 does (one shared atomicAdd(int) per pixel and
// step, the channel rotated by hist2's rule), takes the groups' degrees
// with K1 two at a time (group_pair_max_multiplicity), sums the 32 degrees
// in a register and writes the wave's degree itself.  Any C works the
// same, C = 3 included, where a pixel group's steps straddle two waves: a
// warp reads only the steps of its own wave.  Nothing is shared between
// warps but the histogram, so there is no per-chunk barrier and no shared
// degree sum.  At most 32 registers a thread, so that 8 blocks fit on an
// SM: the 16,384 waves of a 4 Mpx x 4 image are then two rounds of warps,
// not three or four.  What bounds K3 beyond K2 is K1 on groups of many
// values, the sort's 15 steps (wave_degrees.cuh, which lists the measured
// cost of each candidate).
#include <cuda_runtime.h>

#include "warp_aggregate.cuh"
#include "wave_degrees.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = REPRO_LANES;  // pixels a block of K2 or K4 walks per chunk
constexpr int kInstrumentedBlocksPerSm = 8;  // K3: see the note above
constexpr int kWeightedThreads = 1024;       // K4: a pixel to a thread of the chunk

// K2: one shared atomicAdd(int) per pixel and channel step.
template <bool kReorder>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* __restrict__ img, int* __restrict__ out, long long n,
                long long num_chunks, int C, int num_bins, int tile) {
  extern __shared__ __align__(16) int counts[];
  const int bins = C * num_bins;

  for (int i = threadIdx.x; i < bins; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  for (long long chunk = blockIdx.x; chunk < num_chunks; chunk += gridDim.x) {
    for (int j = 0; j < kChunk; j += kThreads) {
      const long long p = chunk * kChunk + j + threadIdx.x;
      const bool real = p < n;
      const int rot = kReorder ? (int)(p % tile) : 0;
      for (int s = 0; s < C; ++s) {
        const int ch = kReorder ? (s + rot) % C : s;
        const int v = real ? img[p * C + ch] : 0;
        const int flat = (int)((unsigned)ch * (unsigned)num_bins + (unsigned)v);
        if (real && (unsigned)flat < (unsigned)bins) atomicAdd(&counts[flat], 1);
      }
    }
  }

  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const int c = counts[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

// K4: a thread to a pixel, a block to a 1024-pixel chunk, into a padded
// shared copy (padded_slot: one value's bins in the C channels fall in C
// different banks), flushed once a block.  Step 0 of a chunk decides for
// the warp how the chunk's C steps add: when lane 0's flat index fills
// kMatchLanes lanes or more (or the warp is hot), every step goes through
// add_aggregated (the note at the top); otherwise each lane adds its own
// weight, with no warp-wide instruction between its CAS loops, as K2 adds
// its counts.  The chunk loop is uniform across the block, so every lane
// of a warp runs the same steps; a pixel past n takes the neutral flat
// index -1.
template <bool kReorder>
__global__ void __launch_bounds__(kWeightedThreads)
    hist_weighted_kernel(const int* __restrict__ img, const float* __restrict__ weights,
                         float* __restrict__ out, long long n, long long num_chunks, int C,
                         int num_bins, int tile) {
  static_assert(kChunk == kWeightedThreads, "a thread to a pixel of the chunk");
  __shared__ float scratch[kWeightedThreads];  // a warp's 32 words each
  extern __shared__ __align__(16) float sums[];
  const int bins = C * num_bins;

  for (int i = threadIdx.x; i < repro_agg::padded_slot(bins); i += blockDim.x)
    sums[i] = 0.0f;
  __syncthreads();

  float* const warp_scratch = scratch + (threadIdx.x & ~31u);
  bool hot = false;  // add_aggregated's state
  for (long long chunk = blockIdx.x; chunk < num_chunks; chunk += gridDim.x) {
    const long long p = chunk * kChunk + threadIdx.x;
    const bool real = p < n;
    const float w = real ? weights[p] : 0.0f;
    // hist2's channel (s + p % tile) % C, stepped without a division; p
    // and p * C fit 32 bits (the host checked n * C < 2^31)
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
        repro_agg::add_aggregated</*kPadded=*/true>(sums, flat, w, (unsigned)bins, hot,
                                                    warp_scratch);
      else if ((unsigned)flat < (unsigned)bins)
        atomicAdd(&sums[repro_agg::padded_slot(flat)], w);
    }
  }

  repro_agg::flush_copy</*kPadded=*/true>(sums, out, bins);
}

// K3, a warp to a wave of the committed stream (the note at the top).
template <bool kReorder>
__global__ void __launch_bounds__(kThreads, kInstrumentedBlocksPerSm)
    hist_instrumented_kernel(const int* __restrict__ img, int* __restrict__ out,
                             float* __restrict__ deg, long long n, long long num_waves,
                             int C, int num_bins, int tile) {
  extern __shared__ __align__(16) int counts[];
  const int bins = C * num_bins;
  for (int i = threadIdx.x; i < bins; i += blockDim.x) counts[i] = 0;
  __syncthreads();

  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  const long long warps = (long long)gridDim.x * (kThreads / REPRO_COMMIT_GROUP);
  // the warp index is uniform across a warp, so every lane of it runs the
  // same waves and groups, as the warp functions need
  for (long long w = ((long long)blockIdx.x * kThreads + threadIdx.x) / REPRO_COMMIT_GROUP;
       w < num_waves; w += warps) {
    const long long q0 = w * REPRO_COMMIT_GROUP;  // the wave's first group
    const long long pg = q0 / C;
    int s = (int)(q0 - pg * C);
    long long p = pg * REPRO_COMMIT_GROUP + lane;  // this lane's pixel
    int rot = kReorder ? (int)(p % tile) : 0;
    unsigned sum = 0;
    for (int g = 0; g < REPRO_COMMIT_GROUP; g += 2) {
      // two groups' count atomics, then their degrees together
      int flat[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool real = p < n;
        const int ch = kReorder ? (s + rot) % C : s;
        const int v = real ? img[p * C + ch] : 0;
        flat[h] = (int)((unsigned)ch * (unsigned)num_bins + (unsigned)v);
        if (real && (unsigned)flat[h] < (unsigned)bins) atomicAdd(&counts[flat[h]], 1);
        if (++s == C) {  // the next pixel group
          s = 0;
          p += REPRO_COMMIT_GROUP;
          if (kReorder) rot = (int)(p % tile);
        }
      }
      const uint2 m = group_pair_max_multiplicity(flat[0], flat[1]);
      sum += m.x + m.y;
    }
    if (lane == 0) deg[w] = (float)sum / (float)REPRO_COMMIT_GROUP;
  }

  __syncthreads();
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const int c = counts[i];
    if (c != 0) atomicAdd(&out[i], c);
  }
}

// As many blocks of `threads` as fit on the card at once, but no more than
// the work needs (`work` blocks).
template <typename Kernel>
int grid_for(Kernel kernel, size_t smem, long long work, unsigned* grid,
             int threads = kThreads) {
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  long long g = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (g > work) g = work;
  *grid = g > 0 ? (unsigned)g : 1u;
  return 0;
}

template <bool kReorder>
int launch(const void* img, void* out, int n, int num_chunks, int C, int num_bins, int tile,
           void* stream) {
  auto kernel = hist_kernel<kReorder>;
  const size_t smem = (size_t)C * num_bins * 4;
  unsigned grid = 0;
  const int err = grid_for(kernel, smem, num_chunks, &grid);
  if (err) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)img, (int*)out, n, num_chunks, C, num_bins, tile);
  return (int)cudaGetLastError();
}

template <bool kReorder>
int launch_weighted(const void* img, const void* weights, void* out, int n, int num_chunks,
                    int C, int num_bins, int tile, void* stream) {
  auto kernel = hist_weighted_kernel<kReorder>;
  const int bins = C * num_bins;
  const size_t smem = (size_t)(bins + (bins >> 5)) * 4;  // padded_slot(bins) words
  unsigned grid = 0;
  const int err = grid_for(kernel, smem, num_chunks, &grid, kWeightedThreads);
  if (err) return err;
  kernel<<<grid, kWeightedThreads, smem, (cudaStream_t)stream>>>(
      (const int*)img, (const float*)weights, (float*)out, n, num_chunks, C, num_bins, tile);
  return (int)cudaGetLastError();
}

template <bool kReorder>
int launch_instrumented(const void* img, void* out, void* deg, int n, int num_waves, int C,
                        int num_bins, int tile, void* stream) {
  auto kernel = hist_instrumented_kernel<kReorder>;
  const size_t smem = (size_t)C * num_bins * 4;
  unsigned grid = 0;
  const int warps_per_block = kThreads / REPRO_COMMIT_GROUP;
  const int err = grid_for(kernel, smem, (num_waves + warps_per_block - 1) / warps_per_block,
                           &grid);
  if (err) return err;
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)img, (int*)out, (float*)deg, n, num_waves, C, num_bins, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2.  img: (n, C) int32; out: (C, num_bins) int32, zeroed by the caller.
int repro_hist(const void* img, void* out, int n, int C, int num_bins, int tile,
               int reorder, void* stream) {
  const int chunks = (n + kChunk - 1) / kChunk;
  return reorder ? launch<true>(img, out, n, chunks, C, num_bins, tile, stream)
                 : launch<false>(img, out, n, chunks, C, num_bins, tile, stream);
}

// K4.  weights: (n,) f32; out: (C, num_bins) f32, zeroed by the caller.
int repro_hist_weighted(const void* img, const void* weights, void* out, int n, int C,
                        int num_bins, int tile, int reorder, void* stream) {
  const int chunks = (n + kChunk - 1) / kChunk;
  return reorder
             ? launch_weighted<true>(img, weights, out, n, chunks, C, num_bins, tile, stream)
             : launch_weighted<false>(img, weights, out, n, chunks, C, num_bins, tile, stream);
}

// K3.  n_pad: n rounded up to a whole tile (a multiple of 1024);
// deg: (n_pad * C / 1024,) f32, every entry written by the kernel.
int repro_hist_instrumented(const void* img, void* out, void* deg, int n, int n_pad,
                            int C, int num_bins, int tile, int reorder, void* stream) {
  const int waves = (int)((long long)n_pad * C / REPRO_LANES);
  return reorder ? launch_instrumented<true>(img, out, deg, n, waves, C, num_bins, tile, stream)
                 : launch_instrumented<false>(img, out, deg, n, waves, C, num_bins, tile,
                                              stream);
}

}  // extern "C"
