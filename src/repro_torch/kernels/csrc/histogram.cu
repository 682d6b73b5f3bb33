// K2, K3 and K4: per-channel image histograms with shared-memory atomics.
//
// Replaces, in src/repro/kernels/histogram/kernel.py:
//   K2  _hist_kernel               (counts; `hist` and `hist2`)
//   K3  _hist_instrumented_kernel  (K2 plus K1's per-wave degrees)
//   K4  _hist_weighted_kernel      (f32 sums of a per-pixel weight)
// The TPU kernels commit each tile with a one-hot reduction into a VMEM
// accumulator.  On Hopper they become what they were in the paper
// (Listings 1-2): each block keeps a C x num_bins sub-histogram in shared
// memory, every thread atomicAdds its pixel's channels into it, and the
// block flushes its non-zero bins to the global result with atomicAdd.
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
//     bounds.  The flat index wraps like the reference's int32 arithmetic.
//
// Bound on an H100: bytes.  Each pixel's C int32 channels are read once
// (67.1 MB for the 4 Mpx x 4 channel case-study image, about 20 us at
// 3.35 TB/s; K4 adds 4 bytes of weight a pixel).  What the data can make
// slow is the shared-memory atomic unit itself: a solid image sends all 32
// lanes of a warp to one bin, which is the contention the paper models.
// The design does nothing to hide that, on purpose; the wide shared
// accumulator keeps the global atomics to one flush per block.
//
// K3's degrees: the pixels are walked in chunks of 1024 (32 warps' worth of
// 32-pixel groups).  The reference commits channel step s of a 32-pixel
// group together, so at step s one warp's 32 flat indices are exactly one
// commit group, number pg * C + s for pixel group pg, in wave
// (pg * C + s) / 32.  A chunk of 32 pixel groups therefore covers exactly C
// whole waves, whatever C is, and the block owns them: it sums their group
// maxima as integers in shared memory and writes each wave once.
#include <cuda_runtime.h>

#include <type_traits>

#include "wave_degrees.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = REPRO_LANES;  // pixels a block walks per chunk

template <bool kReorder, bool kWeighted, bool kInstrumented>
__global__ void __launch_bounds__(kThreads)
    hist_kernel(const int* __restrict__ img, const float* __restrict__ weights,
                void* __restrict__ out, float* __restrict__ deg, long long n,
                long long num_chunks, int C, int num_bins, int tile) {
  using Acc = typename std::conditional<kWeighted, float, int>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  Acc* sh = reinterpret_cast<Acc*>(smem);
  const int bins = C * num_bins;
  unsigned* wave_sum = reinterpret_cast<unsigned*>(sh + bins);

  for (int i = threadIdx.x; i < bins; i += blockDim.x) sh[i] = Acc(0);
  if (kInstrumented)
    for (int i = threadIdx.x; i < C; i += blockDim.x) wave_sum[i] = 0u;
  __syncthreads();

  const int lane = threadIdx.x & (REPRO_COMMIT_GROUP - 1);
  for (long long chunk = blockIdx.x; chunk < num_chunks; chunk += gridDim.x) {
    for (int j = 0; j < kChunk; j += kThreads) {
      const long long p = chunk * kChunk + j + threadIdx.x;
      const bool real = p < n;
      const int rot = kReorder ? (int)(p % tile) : 0;
      float w = 0.0f;
      if (kWeighted && real) w = weights[p];
      for (int s = 0; s < C; ++s) {
        const int ch = kReorder ? (s + rot) % C : s;
        const int v = real ? img[p * C + ch] : 0;
        const int flat = (int)((unsigned)ch * (unsigned)num_bins + (unsigned)v);
        if (real && (unsigned)flat < (unsigned)bins) {
          if constexpr (kWeighted)
            atomicAdd(&sh[flat], w);
          else
            atomicAdd(&sh[flat], 1);
        }
        if constexpr (kInstrumented) {
          const unsigned m = group_max_multiplicity(flat);
          if (lane == 0) {
            const long long group = (p / REPRO_COMMIT_GROUP) * C + s;
            atomicAdd(&wave_sum[group / REPRO_COMMIT_GROUP - chunk * C], m);
          }
        }
      }
    }
    if constexpr (kInstrumented) {
      __syncthreads();
      for (int i = threadIdx.x; i < C; i += blockDim.x) {
        deg[chunk * C + i] = (float)wave_sum[i] / (float)REPRO_COMMIT_GROUP;
        wave_sum[i] = 0u;
      }
      __syncthreads();
    }
  }

  __syncthreads();
  Acc* dst = reinterpret_cast<Acc*>(out);
  for (int i = threadIdx.x; i < bins; i += blockDim.x) {
    const Acc v = sh[i];
    if (v != Acc(0)) atomicAdd(&dst[i], v);
  }
}

template <bool kReorder, bool kWeighted, bool kInstrumented>
int launch(const void* img, const void* weights, void* out, void* deg, int n,
           int num_chunks, int C, int num_bins, int tile, void* stream) {
  auto kernel = hist_kernel<kReorder, kWeighted, kInstrumented>;
  const size_t smem = (size_t)C * num_bins * 4 + (kInstrumented ? (size_t)C * 4 : 0);
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
  long long grid = (long long)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > num_chunks) grid = num_chunks;
  kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int*)img, (const float*)weights, out, (float*)deg, n, num_chunks, C,
      num_bins, tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2.  img: (n, C) int32; out: (C, num_bins) int32, zeroed by the caller.
int repro_hist(const void* img, void* out, int n, int C, int num_bins, int tile,
               int reorder, void* stream) {
  const int chunks = (n + kChunk - 1) / kChunk;
  return reorder ? launch<true, false, false>(img, nullptr, out, nullptr, n, chunks, C,
                                              num_bins, tile, stream)
                 : launch<false, false, false>(img, nullptr, out, nullptr, n, chunks, C,
                                               num_bins, tile, stream);
}

// K4.  weights: (n,) f32; out: (C, num_bins) f32, zeroed by the caller.
int repro_hist_weighted(const void* img, const void* weights, void* out, int n, int C,
                        int num_bins, int tile, int reorder, void* stream) {
  const int chunks = (n + kChunk - 1) / kChunk;
  return reorder ? launch<true, true, false>(img, weights, out, nullptr, n, chunks, C,
                                             num_bins, tile, stream)
                 : launch<false, true, false>(img, weights, out, nullptr, n, chunks, C,
                                              num_bins, tile, stream);
}

// K3.  n_pad: n rounded up to a whole tile (a multiple of 1024);
// deg: (n_pad * C / 1024,) f32, every entry written by the kernel.
int repro_hist_instrumented(const void* img, void* out, void* deg, int n, int n_pad,
                            int C, int num_bins, int tile, int reorder, void* stream) {
  const int chunks = n_pad / kChunk;
  return reorder ? launch<true, false, true>(img, nullptr, out, deg, n, chunks, C,
                                             num_bins, tile, stream)
                 : launch<false, false, true>(img, nullptr, out, deg, n, chunks, C,
                                              num_bins, tile, stream);
}

}  // extern "C"
