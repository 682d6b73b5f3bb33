// K8: causal or full self-attention with an online softmax over KV tiles.
//
// Replaces _flash_kernel in src/repro/kernels/flash_attention/kernel.py
// (reached by pl.pallas_call in flash_attention_pallas, batched by ops.py
// with vmap).  The function is the reference's:
//   * the softmax runs online over KV tiles, with the running max m, the
//     running sum l and the output accumulator in f32;
//   * a masked score is NEG_INF = -2e38, not -inf; the final divide uses
//     max(l, 1e-30); the output has the input's dtype.
// Additions that change no result:
//   * the batch axis is in the grid, so one launch covers (B, H, T, d);
//   * GQA: query head h reads KV head h / group, so K and V are never
//     expanded in memory (group = 1 is the reference's kernel exactly);
//   * causal KV tiles that lie wholly above the diagonal are skipped.  That
//     is exact: the first tile (keys from 0) holds a key every query may
//     see, so m is finite after it, and a tile of masked scores would add
//     exp(-2e38 - m) = 0 to l and acc with corr = exp(0) = 1.
//   * The reference's bq and bkv are the TPU's blocking; they change only
//     the order of the f32 sums.  The tiles here are this card's (below),
//     and a ragged last tile masks its out-of-range keys like causal ones.
//
// Two routes, picked by the input dtype:
//   * f32 inputs: CUDA-core FMA in true f32 (no TF32), q scaled by d^-0.5
//     in f32 before QK^T as in the reference.  A block takes 16 query rows
//     of one (b, h), four rows a warp; a lane takes one key of each
//     32-key tile for the scores and d/32 output columns for P V.
//   * bf16 inputs: tensor-core mma.sync.m16n8k16 in bf16 with f32
//     accumulation.  A block takes 64 query rows, 16 a warp; K and V tiles
//     of 64 keys go through shared memory; P goes from the score
//     accumulator straight into the A operand of P V in registers.  The
//     scale is applied to the f32 scores rather than to q, because a scaled
//     q would have to be rounded back to bf16 for the tensor core.  P is
//     rounded to bf16 for that product (the reference multiplies it in
//     f32): each p_j moves by at most 2^-9 of itself, so an output moves by
//     at most 2^-9 sum_j p_j |v_j| / l, the bound the checks scale to.
//
// Bound on an H100: operations.  At the serving shape (B 4, H 64, T 2048,
// d 128, causal) the useful products are about 2.7e11 flop against about
// 0.3 GB of q, k, v and output; at 989 TFLOP/s and 3.35 TB/s the products
// take three times as long as the bytes.  This first kernel keeps the
// scores out of device memory, which is what the reference's design is
// for, and reads each K/V tile once per 64 query rows; asynchronous copies
// (TMA), wgmma and warp specialisation are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;

// -------------------------------------------------------------------------
// f32 route
// -------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32Rows = 16;                     // query rows per block
constexpr int kF32RowsPerWarp = kF32Rows / (kF32Threads / 32);
constexpr int kF32Keys = 32;                     // keys per tile, one per lane

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// q, o: (B, H, T, D); k, v: (B, H / group, T, D); all contiguous.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int heads,
                     int group, int t, int causal, float scale) {
  constexpr int kCols = (D + 31) / 32;           // output columns per lane
  __shared__ float qs[kF32Rows][D];
  __shared__ float ks[kF32Keys][D + 1];          // +1: lanes read rows
  __shared__ float vs[kF32Keys][D];

  const int n_tiles_q = (t + kF32Rows - 1) / kF32Rows;
  const int q0 = (n_tiles_q - 1 - blockIdx.x) * kF32Rows;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_heads = heads / group;
  const size_t q_base = ((size_t)b * heads + h) * t * D;
  const size_t kv_base = ((size_t)b * kv_heads + h / group) * t * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kF32Rows * D; i += kF32Threads) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < t ? q[q_base + (size_t)(q0 + r) * D + c] * scale : 0.0f;
  }

  float m[kF32RowsPerWarp], l[kF32RowsPerWarp], acc[kF32RowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  const int q_last = min(q0 + kF32Rows, t) - 1;
  const int kv_end = causal ? q_last + 1 : t;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kF32Keys) {
    __syncthreads();                             // the last tile is read
    for (int i = threadIdx.x; i < kF32Keys * D; i += kF32Threads) {
      const int r = i / D, c = i % D;
      const bool in = kv0 + r < t;
      ks[r][c] = in ? k[kv_base + (size_t)(kv0 + r) * D + c] : 0.0f;
      vs[r][c] = in ? v[kv_base + (size_t)(kv0 + r) * D + c] : 0.0f;
    }
    __syncthreads();

    const int key = kv0 + lane;
    float p[kF32RowsPerWarp];
#pragma unroll
    for (int r = 0; r < kF32RowsPerWarp; ++r) {
      const int row = warp * kF32RowsPerWarp + r;
      float s = 0.0f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s = fmaf(qs[row][c], ks[lane][c], s);
      const bool ok = key < t && (!causal || key <= q0 + row);
      s = ok ? s : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(s));
      p[r] = expf(s - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
    }
#pragma unroll 4
    for (int j = 0; j < kF32Keys; ++j) {
      float vj[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = lane + 32 * c;
        vj[c] = col < D ? vs[j][col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kF32RowsPerWarp; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, vj[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kF32RowsPerWarp; ++r) {
    const int qi = q0 + warp * kF32RowsPerWarp + r;
    if (qi >= t) continue;
    const float inv_l = 1.0f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) o[q_base + (size_t)qi * D + col] = acc[r][c] * inv_l;
    }
  }
}

// -------------------------------------------------------------------------
// bf16 route: mma.sync.m16n8k16, bf16 x bf16 -> f32
// -------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kMmaRows = 64;                     // query rows per block, 16 a warp
constexpr int kMmaKeys = 64;                     // keys per K/V tile
constexpr int kPad = 8;                          // bf16 per row: no bank conflicts

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows [r0, r0 + 64) of src (row length D) into dst (row length D + kPad),
// 16 bytes a thread per step; rows at or past t are zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[D + kPad],
                                          const __nv_bfloat16* __restrict__ src, int r0,
                                          int t) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks per row
  for (int i = threadIdx.x; i < kMmaKeys * kChunks; i += kMmaThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < t) val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(&dst[r][c]) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int heads, int group, int t, int causal, float scale) {
  constexpr int kSteps = D / 16;                 // k-steps of QK^T
  constexpr int kOut = D / 8;                    // n-tiles of the output
  constexpr int kScore = kMmaKeys / 8;           // n-tiles of the scores
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaKeys][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaKeys][D + kPad];

  const int n_tiles_q = (t + kMmaRows - 1) / kMmaRows;
  const int q0 = (n_tiles_q - 1 - blockIdx.x) * kMmaRows;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kv_heads = heads / group;
  const __nv_bfloat16* qh = q + ((size_t)b * heads + h) * t * D;
  const __nv_bfloat16* kh = k + ((size_t)b * kv_heads + h / group) * t * D;
  const __nv_bfloat16* vh = v + ((size_t)b * kv_heads + h / group) * t * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;        // mma fragment coordinates
  const int row0 = q0 + warp * 16 + g;           // this thread's two rows
  const int row1 = row0 + 8;

  // q's A fragments, staged through the K buffer
  uint32_t qf[kSteps][4];
  load_tile<D>(ks, qh, q0, t);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = s * 16 + tig * 2;
    qf[s][0] = *reinterpret_cast<const uint32_t*>(&ks[warp * 16 + g][c]);
    qf[s][1] = *reinterpret_cast<const uint32_t*>(&ks[warp * 16 + g + 8][c]);
    qf[s][2] = *reinterpret_cast<const uint32_t*>(&ks[warp * 16 + g][c + 8]);
    qf[s][3] = *reinterpret_cast<const uint32_t*>(&ks[warp * 16 + g + 8][c + 8]);
  }

  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;
  float acc[kOut][4];
#pragma unroll
  for (int n = 0; n < kOut; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  const int q_last = min(q0 + kMmaRows, t) - 1;
  const int kv_end = causal ? q_last + 1 : t;
  for (int kv0 = 0; kv0 < kv_end; kv0 += kMmaKeys) {
    __syncthreads();                             // q, or the last tile, is read
    load_tile<D>(ks, kh, kv0, t);
    load_tile<D>(vs, vh, kv0, t);
    __syncthreads();

    // S = q K^T for 16 rows x 64 keys: kScore n-tiles of 8 keys
    float s[kScore][4];
#pragma unroll
    for (int n = 0; n < kScore; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
      for (int st = 0; st < kSteps; ++st) {
        const int c = st * 16 + tig * 2;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&ks[n * 8 + g][c]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&ks[n * 8 + g][c + 8]);
        mma_bf16(s[n], qf[st], b0, b1);
      }
    }

    // scale, mask, and the online softmax for rows row0 (c0, c1) and row1 (c2, c3)
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < kScore; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + n * 8 + tig * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const bool ok = key < t && (!causal || key <= row);
        s[n][e] = ok ? s[n][e] * scale : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < kScore; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * corr0 + quad_sum(sum0);
    l1 = l1 * corr1 + quad_sum(sum1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }

    // acc += P V: P's 16-key k-steps come from pairs of score n-tiles
#pragma unroll
    for (int kk = 0; kk < kMmaKeys / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int key = kk * 16 + tig * 2;
#pragma unroll
      for (int n = 0; n < kOut; ++n) {
        const int col = n * 8 + g;
        const uint32_t b0 = pack_bf16(vs[key][col], vs[key + 1][col]);
        const uint32_t b1 = pack_bf16(vs[key + 8][col], vs[key + 9][col]);
        mma_bf16(acc[n], pa, b0, b1);
      }
    }
  }

  const float inv0 = 1.0f / fmaxf(l0, 1e-30f), inv1 = 1.0f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* oh = o + ((size_t)b * heads + h) * t * D;
#pragma unroll
  for (int n = 0; n < kOut; ++n) {
    const int col = n * 8 + tig * 2;
    if (row0 < t)
      *reinterpret_cast<uint32_t*>(oh + (size_t)row0 * D + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row1 < t)
      *reinterpret_cast<uint32_t*>(oh + (size_t)row1 * D + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int group, int t, int dtype, int causal, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((t + kF32Rows - 1) / kF32Rows, heads, batch);
    flash_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), heads, group, t, causal, scale);
  } else {
    const dim3 grid((t + kMmaRows - 1) / kMmaRows, heads, batch);
    flash_bf16_kernel<D><<<grid, kMmaThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), heads, group,
        t, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o: (batch, heads, t, d); k, v: (batch, heads / group, t, d); all
// contiguous, 16-byte aligned, of one dtype: 0 = f32, 1 = bf16.
// d is 16, 32, 64 or 128.  scale is d^-0.5.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int batch,
                          int heads, int group, int t, int d, int dtype, int causal,
                          float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || group < 1 || heads % group != 0 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, k, v, o, batch, heads, group, t, dtype, causal, scale, s);
    case 32:
      return launch<32>(q, k, v, o, batch, heads, group, t, dtype, causal, scale, s);
    case 64:
      return launch<64>(q, k, v, o, batch, heads, group, t, dtype, causal, scale, s);
    case 128:
      return launch<128>(q, k, v, o, batch, heads, group, t, dtype, causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
