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
//     exp(-2e38 - m) = 0 to l and acc with corr = exp(0) = 1;
//   * the reference's bq and bkv are the TPU's blocking; they change only
//     the order of the f32 sums.  The tiles here are this card's (below),
//     and a ragged last tile masks its out-of-range keys like causal ones,
//     so T need not be a whole number of tiles.
//
// The bf16 Hopper route also has a backward, further down, with no TPU
// counterpart: its forward instantiation with kLse stores each row's
// log-sum-exp (repro_flash_attention_lse), and three launches give dq, dk
// and dv from it (repro_flash_attention_bwd).
//
// Three routes, picked by dtype and head size, none a fallback of another:
//   * f32 inputs: CUDA-core FMA in true f32 (no TF32), q scaled by d^-0.5
//     in f32 before QK^T as in the reference.  A block takes 16 query rows
//     of one (b, h), four rows a warp; a lane takes one key of each
//     32-key tile for the scores and d/32 output columns for P V.
//   * bf16 at d = 64 and 128 (every attention config of the port but one):
//     flash_bf16_sm90_kernel, the Hopper design below;
//   * bf16 at q.k 192 and v 128 (DeepSeek-V3's latent attention, its
//     prefill): flash_mla_sm90_kernel, the same design at two head sizes,
//     with V and the output at their own 128 columns (padding V to 192
//     would waste a third of the P V product and of V's bytes).  It has
//     no backward and no f32 route.  Bound by operations, as at d = 128:
//     a 16,384-token prefill of 128 heads is 1.1e13 useful flop (11.1 ms
//     at 989 TFLOP/s) against 2.7 GB of q, k, v and output (0.8 ms).
//   * bf16 at d = 16 and 32 (the reference test's shapes): mma.sync.m16n8k16
//     in flash_bf16_kernel.  A block takes 64 query rows, 16 a warp; K and
//     V tiles of 64 keys are copied through shared memory by all threads.
// Both bf16 routes scale the f32 scores rather than q, because a scaled q
// would have to be rounded back to bf16 for the tensor core.  Both round P
// to bf16 for the P V product (the reference multiplies it in f32): each
// p_j moves by at most 2^-9 of itself, so an output moves by at most
// 2^-9 sum_j p_j |v_j| / l, the bound the checks scale to.
//
// Bound on an H100: operations.  At the serving shape (B 4, H 64, T 2048,
// d 128, causal) the useful products are about 2.7e11 flop against about
// 0.3 GB of q, k, v and output; at 989 TFLOP/s and 3.35 TB/s the products
// take three times as long as the bytes.  So the design is about keeping
// the tensor cores fed.  The first kernel (mma.sync, now the d <= 32 route)
// reached 0.1 of that bound at the serving shape; the Hopper route answers
// each of its four limits:
//   * loads were synchronous and single-buffered (all threads copied K and
//     V, then __syncthreads): now one producer thread issues TMA loads
//     (cp.async.bulk.tensor) of Q once and of each K and V tile into a ring
//     of 4 stages, each reporting to a "full" mbarrier, while the consumers
//     compute; they free a stage through an "empty" mbarrier.  The tensor
//     maps are 3-D, (B H, T, d) for q and (B H / group, T, d) for k and v,
//     so a box never crosses a head, and TMA fills rows at or past T with
//     zeros: a ragged T needs no padding in memory.  A box is 64 columns
//     (128 bytes, the 128-byte swizzle's span), so a d = 128 row is two;
//   * tiles were small (64 query rows per K/V pass, about two blocks an
//     SM): now a block takes 128 query rows, two consumer warpgroups of 64
//     rows (wgmma's M) and a producer warpgroup, with its K/V ring in
//     dynamic shared memory (about 161 KB at d = 128, 145 KB at d = 64);
//   * V was gathered by 16-bit shared loads for P V: now V is wgmma's B
//     operand straight from the swizzled TMA tile, MN-major (the transpose
//     bit of a 16-bit operand);
//   * mma.sync cannot reach the card's tensor-core rate: S = Q K^T is
//     wgmma with both operands in shared memory, K-major, and O += P V is
//     wgmma with P from registers: the f32 score accumulator, packed to
//     bf16, is already in the register-A fragment layout.
// Within a warpgroup, S_i is issued before P_{i-1} V_{i-1} and the softmax
// of S_i runs while that product is on the tensor cores; between the two
// warpgroups, named barriers make them take turns to issue, so that one's
// softmax overlaps the other's products.  That needs S_i, P_{i-1} and O in
// registers at once.  setmaxnreg moves registers from the producer (24) to
// the consumers (240) at run time, but ptxas still fits the consumer code
// in the 168 registers a thread of a 384-thread block gets, and where it
// cannot, it serialises every wgmma.  So a K/V tile is 64 keys at d = 128
// (S in 32 registers) and 128 keys at d = 64.
// The online softmax runs on the accumulator layout (each thread holds two
// rows; row reductions across a quad): the max is taken on the raw f32
// scores, the scale and log2(e) fold into one FMA before ex2, masking
// (NEG_INF) happens only on tiles that cross the diagonal or the end of T,
// and m, l and acc stay in f32.  Against the mma.sync route's expf of the
// scaled scores, this moves each p_j by a few f32 ulps, far inside the
// bounds the checks hold it to.

#include <cuda.h>
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
// bf16 route at d = 16 and 32: mma.sync.m16n8k16, bf16 x bf16 -> f32
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

// -------------------------------------------------------------------------
// bf16 route at d = 64 and 128: TMA, wgmma and warp specialisation
// -------------------------------------------------------------------------

constexpr int kSm90Rows = 128;                   // query rows per block
constexpr int kSm90Consumers = 256;              // two warpgroups of 64 rows
constexpr int kSm90Threads = kSm90Consumers + 128;  // and one producer warpgroup
constexpr int kBoxCols = 64;                     // 128 bytes: the swizzle's span
constexpr int kQRegion = kSm90Rows * 128;        // bytes of one box of Q

// DK: the head size of q and k; DV: that of v and the output.  DK = DV = 64
// or 128 for every attention config of the port but one; DeepSeek-V3's
// latent attention (MLA) attends at DK = 192 (128 + its 64 rotary columns)
// and DV = 128, and V is not padded to 192.
template <int DK, int DV>
struct Sm90Layout {
  // keys per K/V tile: the most that keeps a consumer within the 168
  // registers ptxas gives a thread of a 384-thread block (at d = 128, 128
  // keys would need about 190, and ptxas then serialises the wgmma); the
  // registers follow DV (the output) and the keys, so (192, 128) is d = 128's
  static constexpr int kKeys = DK <= 64 && DV <= 64 ? 128 : 64;
  static constexpr int kKVRegion = kKeys * 128;  // bytes of one box of a K or V tile
  static constexpr int kBoxesK = DK / kBoxCols;  // boxes per row of a Q or K tile
  static constexpr int kBoxesV = DV / kBoxCols;  // boxes per row of a V tile
  // 128 KB of K and V at d = 64 and 128; 160 KB at (192, 128)
  static constexpr int kStages = 4;
  static constexpr int kQBytes = kSm90Rows * DK * 2;
  static constexpr int kTileK = kKeys * DK * 2;          // one K tile
  static constexpr int kTileV = kKeys * DV * 2;          // one V tile
  static constexpr int kStageBytes = kTileK + kTileV;    // K, then V
  static constexpr int kBarriers = 1 + 3 * kStages;      // q, full K, full V, empty
  // 1024: the 128-byte swizzle wants every box 1024-byte aligned
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes + 8 * kBarriers;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of the given parity to complete.  A wait that never
// ends is a fault of the pipeline: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0, spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (++spins == (1u << 28)) __trap();
  } while (!done);
}

// a box of `map` at (column c0, row c1, head c2) into shared memory at dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma's shared-memory descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets in 16-byte units, layout 1.
// K-major (Q, K): 8-row groups 1024 bytes apart (stride); the leading
// offset is unused.  MN-major (V): 8-key groups 1024 bytes apart (stride),
// 64-column boxes `leading` bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t leading) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(leading >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// named barriers 1 and 2: the consumer warpgroups take turns to issue
// their products (256 threads each: one warpgroup syncs, the other arrives)
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator registers across a wgmma
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_ACC8(d, i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// S (64 x N keys, f32) {=, +=} Q (64 x 16) K^T, both K-major in shared memory;
// N = 128 and N = 64
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24), WG_ACC8(d, 32),
        WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x d, f32) += P (64 x 16 keys, bf16 in registers) V (16 keys x d),
// V MN-major in shared memory; d = 128 and d = 64
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24), WG_ACC8(d, 32),
        WG_ACC8(d, 40), WG_ACC8(d, 48), WG_ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC8(d, 0), WG_ACC8(d, 8), WG_ACC8(d, 16), WG_ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_ACC8

// S (64 x 2 N keys) = Q K^T for one warpgroup: D / 16 wgmma, one group
template <int D, int N>
__device__ __forceinline__ void issue_scores(float (&sc)[N], uint32_t q_wg, uint32_t ks) {
  constexpr int kKVRegion = 2 * N * 128;         // 2 N keys of 128 bytes
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {           // a box per 4 steps, 32 bytes a step
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss(sc, sw128_desc(q_wg + (kk / 4) * kQRegion + step, 16),
             sw128_desc(ks + (kk / 4) * kKVRegion + step, 16), kk > 0);
  }
  wgmma_commit();
}

// O += P V over one tile: a wgmma per 16 keys (2048 bytes of V), one group
template <int N, int K>
__device__ __forceinline__ void issue_pv(float (&acc)[N], const uint32_t (&p)[K][4],
                                         uint32_t vs) {
  constexpr int kKVRegion = 16 * K * 128;        // 16 K keys of 128 bytes
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K; ++kk) wgmma_rs(acc, p[kk], sw128_desc(vs + kk * 2048, kKVRegion));
  wgmma_commit();
}

// 2^x on the multi-function unit (ex2.approx.ftz: relative error about 2^-22)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the running max (of the raw scores) and sum of a thread's two rows
struct Softmax {
  float m0, m1, l0, l1;
};

// The online softmax of one tile, in place: raw scores in, p = exp(scale
// (s - m)) out, with masking (NEG_INF) only where the tile crosses the
// diagonal or T.  Returns each row's correction exp(scale (m_old - m_new)).
// The scale and log2(e) fold into one FMA before ex2; the max is taken on
// the raw scores, which orders them as the scaled ones do.
template <int N>
__device__ __forceinline__ float2 softmax_tile(float (&sc)[N], Softmax& sm, bool masked,
                                               int kv0, int row0, int row1, int tig, int t,
                                               int causal, float scale_log2) {
  if (masked) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int key = kv0 + (j / 4) * 8 + tig * 2 + (j & 1);
      const int row = (j & 2) ? row1 : row0;
      if (!(key < t && (!causal || key <= row))) sc[j] = kNegInf;
    }
  }
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    mx0 = fmaxf(mx0, fmaxf(sc[j], sc[j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[j + 2], sc[j + 3]));
  }
  const float mn0 = fmaxf(sm.m0, quad_max(mx0)), mn1 = fmaxf(sm.m1, quad_max(mx1));
  const float2 corr = make_float2(ex2((sm.m0 - mn0) * scale_log2), ex2((sm.m1 - mn1) * scale_log2));
  const float b0 = mn0 * scale_log2, b1 = mn1 * scale_log2;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    sc[j] = ex2(fmaf(sc[j], scale_log2, -b0));
    sc[j + 1] = ex2(fmaf(sc[j + 1], scale_log2, -b0));
    sc[j + 2] = ex2(fmaf(sc[j + 2], scale_log2, -b1));
    sc[j + 3] = ex2(fmaf(sc[j + 3], scale_log2, -b1));
    sum0 += sc[j] + sc[j + 1];
    sum1 += sc[j + 2] + sc[j + 3];
  }
  sm.l0 = sm.l0 * corr.x + quad_sum(sum0);
  sm.l1 = sm.l1 * corr.y + quad_sum(sum1);
  sm.m0 = mn0;
  sm.m1 = mn1;
  return corr;
}

// P in bf16 as the A operand of P V: the 16-key k-step kk is score n-tiles
// 2 kk and 2 kk + 1, which is the register-A fragment of m64nNk16 as it stands
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&sc)[N], uint32_t (&p)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    p[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
    p[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
    p[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
    p[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
  }
}

// q: (B, H, T, DK); k: (B, H / group, T, DK); v: (B, H / group, T, DV); o:
// (B, H, T, DV); tq, tk, tv map q, k and v as (B H, T, d) and (B H / group,
// T, d) in boxes of 64 columns by 128 rows (q) and by a tile's keys (k, v).
// kLse: also store each row's log-sum-exp of its scaled scores, f32 (B, H, T)
// at lse, for the backward; the prefill's instantiation has no such store.
// The body of both Hopper kernels below, inlined into each.
template <int DK, int DV, bool kLse>
__device__ __forceinline__ void sm90_attention(const CUtensorMap& tq, const CUtensorMap& tk,
                                               const CUtensorMap& tv,
                                               __nv_bfloat16* __restrict__ o,
                                               float* __restrict__ lse, int heads, int group,
                                               int t, int causal, float scale) {
  using L = Sm90Layout<DK, DV>;
  constexpr int kKeys = L::kKeys;
  constexpr int kPV = kKeys / 16;                // k-steps of P V
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023) & ~1023u;
  const uint32_t q_s = base;                     // Q, kBoxesK boxes of 128 rows
  const uint32_t kv_s = base + L::kQBytes;       // stage s: K at kv_s + s stage, then V
  const uint32_t q_full = kv_s + L::kStages * L::kStageBytes;
  const uint32_t full_k = q_full + 8, full_v = full_k + 8 * L::kStages;
  const uint32_t empty = full_v + 8 * L::kStages;

  const int n_tiles_q = (t + kSm90Rows - 1) / kSm90Rows;
  const int q0 = (n_tiles_q - 1 - blockIdx.x) * kSm90Rows;  // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_head = b * heads + h;
  const int kv_head = b * (heads / group) + h / group;
  const int kv_end = causal ? min(q0 + kSm90Rows, t) : t;
  const int n_kv = (kv_end + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, kSm90Consumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, taken from lane 0 so that the compiler sees each role's
  // branch as warp-uniform
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == kSm90Consumers / 128) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kSm90Consumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxesK; ++c)
        tma_load(q_s + c * kQRegion, &tq, q_full, c * kBoxCols, q0, q_head);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % L::kStages;
        const uint32_t ks = kv_s + s * L::kStageBytes, vs = ks + L::kTileK;
        mbar_wait(empty + 8 * s, ((i / L::kStages) & 1) ^ 1);  // round 0 passes
        mbar_expect_tx(full_k + 8 * s, L::kTileK);
        for (int c = 0; c < L::kBoxesK; ++c)
          tma_load(ks + c * L::kKVRegion, &tk, full_k + 8 * s, c * kBoxCols, i * kKeys,
                   kv_head);
        mbar_expect_tx(full_v + 8 * s, L::kTileV);
        for (int c = 0; c < L::kBoxesV; ++c)
          tma_load(vs + c * L::kKVRegion, &tv, full_v + 8 * s, c * kBoxCols, i * kKeys,
                   kv_head);
      }
    }
  } else {
    // consumer warpgroup wg: query rows [first, first + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = role, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4, tig = lane % 4;      // accumulator fragment coordinates
    const int first = q0 + wg * 64;
    const int row0 = first + warp * 16 + g;      // this thread's two rows
    const int row1 = row0 + 8;
    const uint32_t q_wg = q_s + wg * 64 * 128;   // 64 rows of 128 bytes in each box
    const float scale_log2 = scale * 1.4426950408889634f;
    Softmax sm{kNegInf, kNegInf, 0.0f, 0.0f};

    // acc[4 n + e]: output column 8 n + 2 tig + (e & 1) of row0 (e < 2) or row1;
    // sc[4 n + e]: key 8 n + 2 tig + (e & 1) of the tile, the same rows
    float acc[DV / 2], sc[kKeys / 2];
    uint32_t p[kPV][4];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.0f;
    const auto masked = [&](int i) {             // the tile crosses the diagonal or T
      const int kv0 = i * kKeys;
      return kv0 + kKeys > t || (causal && kv0 + kKeys - 1 > first);
    };

    // The two warpgroups take turns to issue their products, so that one
    // runs its softmax while the other's products are on the tensor cores.
    // Each takes n_kv + 1 turns; warpgroup 0 goes first, and warpgroup 1
    // does not hand its last turn on.
    const auto turn_begin = [&] { bar_sync(1 + wg); };
    const auto turn_end = [&](bool last) {
      if (wg == 0 || !last) bar_arrive(2 - wg);
    };
    if (wg == 1) bar_arrive(1);

    // tile 0: S, softmax, P
    mbar_wait(q_full, 0);
    mbar_wait(full_k, 0);
    turn_begin();
    issue_scores<DK>(sc, q_wg, kv_s);
    turn_end(false);
    wgmma_wait<0>();
    hold(sc);
    softmax_tile(sc, sm, masked(0), 0, row0, row1, tig, t, causal, scale_log2);
    to_a_fragments(sc, p);

    // tile i: S_i is issued before P_{i-1} V_{i-1}, and the softmax of S_i
    // runs while that product is on the tensor cores
    for (int i = 1; i < n_kv; ++i) {
      const int s = i % L::kStages, sp = (i - 1) % L::kStages;
      mbar_wait(full_k + 8 * s, (i / L::kStages) & 1);
      mbar_wait(full_v + 8 * sp, ((i - 1) / L::kStages) & 1);
      turn_begin();
      issue_scores<DK>(sc, q_wg, kv_s + s * L::kStageBytes);
      hold(acc);
      issue_pv(acc, p, kv_s + sp * L::kStageBytes + L::kTileK);
      turn_end(false);
      wgmma_wait<1>();                           // S_i is done
      hold(sc);
      const float2 corr =
          softmax_tile(sc, sm, masked(i), i * kKeys, row0, row1, tig, t, causal, scale_log2);
      wgmma_wait<0>();                           // P_{i-1} V_{i-1} is done
      hold(acc);
      mbar_arrive(empty + 8 * sp);
#pragma unroll
      for (int j = 0; j < DV / 2; j += 4) {
        acc[j] *= corr.x;
        acc[j + 1] *= corr.x;
        acc[j + 2] *= corr.y;
        acc[j + 3] *= corr.y;
      }
      to_a_fragments(sc, p);
    }
    const int sl = (n_kv - 1) % L::kStages;
    mbar_wait(full_v + 8 * sl, ((n_kv - 1) / L::kStages) & 1);
    hold(acc);
    turn_begin();
    issue_pv(acc, p, kv_s + sl * L::kStageBytes + L::kTileK);
    turn_end(true);
    wgmma_wait<0>();
    hold(acc);
    mbar_arrive(empty + 8 * sl);

    const float inv0 = 1.0f / fmaxf(sm.l0, 1e-30f), inv1 = 1.0f / fmaxf(sm.l1, 1e-30f);
    __nv_bfloat16* oh = o + (size_t)q_head * t * DV;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = n * 8 + tig * 2;
      if (row0 < t)
        *reinterpret_cast<uint32_t*>(oh + (size_t)row0 * DV + col) =
            pack_bf16(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (row1 < t)
        *reinterpret_cast<uint32_t*>(oh + (size_t)row1 * DV + col) =
            pack_bf16(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
    if constexpr (kLse) {
      // m is the raw max and l the sum of exp(scale (s - m)): the log of
      // the row's sum of exp(scale s) is scale m + log l (l >= 1)
      if (tig == 0) {
        float* lh = lse + (size_t)q_head * t;
        if (row0 < t) lh[row0] = fmaf(sm.m0, scale, logf(sm.l0));
        if (row1 < t) lh[row1] = fmaf(sm.m1, scale, logf(sm.l1));
      }
    }
  }
}

// The Hopper route at d = 64 and 128 (DK = DV = D)
template <int D, bool kLse>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_bf16_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                           float* __restrict__ lse, int heads, int group, int t, int causal,
                           float scale) {
  sm90_attention<D, D, kLse>(tq, tk, tv, o, lse, heads, group, t, causal, scale);
}

// The Hopper route of latent attention's prefill: q and k at 192 columns,
// v and the output at 128.  Without a gradient: no cell trains such a model.
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_mla_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int heads, int group, int t, int causal,
                          float scale) {
  sm90_attention<192, 128, false>(tq, tk, tv, o, lse, heads, group, t, causal, scale);
}

// -------------------------------------------------------------------------
// The backward of the bf16 route at d = 64 and 128.  It has no TPU
// counterpart: the reference's kernel has no gradient.  FlashAttention-2's
// deterministic design, on this file's TMA loads and wgmma helpers, in three
// launches:
//   * flash_bwd_prep_kernel: each query row's D = rowsum(dO o O) in f32 and
//     its LSE times log2(e), into a scratch whose rows are padded to kBwdPad
//     with zeros, so that the kernels below copy whole aligned runs of them;
//   * flash_bwd_dkdv_kernel: a block to each (batch, KV head, 128 keys), a
//     warpgroup to 64 keys.  It loops over the group's query heads and the
//     64-query tiles the causal mask leaves it, and for each recomputes
//     S^T = K Q^T, P^T = exp(scale S^T - LSE), dP^T = V dO^T and
//     dS^T = P^T o (dP^T - D), and adds dV += P^T dO and dK += dS^T Q in
//     registers.  The GQA sum stays inside the block; dK and dV are stored
//     once;
//   * flash_bwd_dq_kernel: a block to each (batch, query head, 128 queries),
//     a warpgroup to 64, looping over the 64-key tiles: S = Q K^T,
//     dP = dO V^T, dS as above, dQ += dS K, stored once.
// No atomics: two runs give equal gradients.  With the keys (dK/dV) or the
// queries (dQ) as wgmma's M, every product has one of the forward's two
// forms: S-like, both operands K-major in shared memory; or O-like, the bf16
// A operand packed from an f32 accumulator in registers and B MN-major in
// shared memory.  Products take bf16 operands and sum in f32; dP and dS stay
// f32 until dS is packed to bf16 as an A operand, as P is for P V.
// Bound on an H100: operations.  The products are 8 B H T^2 d flop (half of
// it causal) against about 12 B H T d bytes read and written, far above the
// card's 295 flop a byte.  The first design reaches 0.16 of that bound at
// granite-moe's train shape (8 x 16/8 x 2048 x 64) and 0.18 at qwen3-moe's
// (4 x 64/4 x 2048 x 128): a warpgroup's products wait for its own
// elementwise work between them, and only the other warpgroup fills the
// tensor cores meanwhile.  Issuing the next tile's S and dP before this
// tile's dV and dK (FA3's pipelining) is the next step.
// A block is 256 threads, both warpgroups computing, and its thread 0 also
// issues the TMA loads into a ring of stages: the 255 registers a thread of
// a 256-thread block may hold fit dK and dV at d = 128 beside S^T and dP^T,
// where a producer warpgroup would leave the consumers 168.
// -------------------------------------------------------------------------

constexpr int kBwdThreads = 256;                 // two warpgroups
constexpr int kBwdKeys = 128;                    // dK/dV: keys a block, 64 a warpgroup
constexpr int kBwdQ = 64;                        // dK/dV: queries a tile
constexpr int kBwdRows = 128;                    // dQ: queries a block, 64 a warpgroup
constexpr int kBwdKV = 64;                       // dQ: keys a tile
constexpr int kBwdPad = 128;                     // scratch rows padded to this

template <int D>
struct BwdLayout {
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kStages = D == 128 ? 2 : 3;
  // dK/dV: K and V of the block (128 rows); each stage's Q and dO tiles (64
  // rows each); each stage's 64 LSE and 64 D values
  static constexpr int kKVTile = kBwdKeys * D * 2;
  static constexpr int kQTile = kBwdQ * D * 2;
  static constexpr int kQAux = 2 * kBwdQ * 4;
  static constexpr int kDkdvSmem =
      1024 + 2 * kKVTile + kStages * (2 * kQTile + kQAux) + 8 * (1 + 2 * kStages);
  // dQ: Q and dO of the block (128 rows) and their 128 LSE and D values;
  // each stage's K and V tiles (64 rows each)
  static constexpr int kRowTile = kBwdRows * D * 2;
  static constexpr int kRowAux = 2 * kBwdRows * 4;
  static constexpr int kKTile = kBwdKV * D * 2;
  static constexpr int kDqSmem =
      1024 + 2 * kRowTile + kRowAux + kStages * 2 * kKTile + 8 * (1 + 2 * kStages);
};

// `bytes` of global memory at src into shared memory at dst, a 1-D bulk copy
// (both 16-byte aligned, bytes a multiple of 16) reporting to bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// acc (64 x N) = A B^T over d = D, both K-major: A 64 rows of a tile at a
// whose boxes are a_rows rows, B a tile at b whose boxes are b_rows rows
template <int D, int N>
__device__ __forceinline__ void ss_product(float (&acc)[N], uint32_t a, int a_rows, uint32_t b,
                                           int b_rows) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {           // a box per 4 steps, 32 bytes a step
    const uint32_t step = (kk % 4) * 32;
    wgmma_ss(acc, sw128_desc(a + (kk / 4) * a_rows * 128 + step, 16),
             sw128_desc(b + (kk / 4) * b_rows * 128 + step, 16), kk > 0);
  }
}

// acc (64 x D) += A (64 x 64, bf16 fragments) B, B the first 64 rows of a
// tile at b, MN-major, whose 64-column boxes are b_rows rows
template <int N>
__device__ __forceinline__ void rs_product(float (&acc)[N], const uint32_t (&a)[4][4], uint32_t b,
                                           int b_rows) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs(acc, a[kk], sw128_desc(b + kk * 2048, b_rows * 128));
}

// o, dout: (B H, t, D) bf16; lse: (B H, t).  lse2 = lse log2(e) and dsum = D,
// each (B H, t_pad) with zeros past t; a warp to a row.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                          float* __restrict__ lse2, float* __restrict__ dsum, int t, int t_pad,
                          int rows) {
  const int row = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / t_pad, r = row % t_pad;
  float acc = 0.0f, l2 = 0.0f;
  if (r < t) {
    const size_t off = ((size_t)bh * t + r) * D;
#pragma unroll
    for (int c = 2 * lane; c < D; c += 64) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + off + c));
      const float2 b =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + off + c));
      acc = fmaf(a.x, b.x, fmaf(a.y, b.y, acc));
    }
    acc = warp_sum(acc);
    l2 = lse[(size_t)bh * t + r] * 1.4426950408889634f;
  }
  if (lane == 0) {
    lse2[row] = l2;
    dsum[row] = acc;
  }
}

// dk, dv: (B, H / group, T, D).  tq, tdo map q and dO as (B H, T, D) in
// boxes of 64 columns by kBwdQ rows; tk, tv map k and v as (B H / group, T,
// D) by kBwdKeys rows.  lse2, dsum: flash_bwd_prep_kernel's.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                          const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int heads, int group, int t, int t_pad,
                          int causal, float scale) {
  using L = BwdLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::kKVTile;
  const uint32_t st_s = v_s + L::kKVTile;        // stage s: Q at st_s + 2 s tile, then dO
  const uint32_t aux_s = st_s + 2 * kStages * L::kQTile;  // stage s: 64 LSE, then 64 D
  const uint32_t kv_full = aux_s + kStages * L::kQAux;
  const uint32_t full = kv_full + 8, empty = full + 8 * kStages;
  const float* aux = reinterpret_cast<const float*>(smem_raw + (aux_s - raw));

  const int kv_heads = heads / group;
  const int k0 = blockIdx.x * kBwdKeys;          // causal: the longest blocks first
  const int kv_head = blockIdx.z * kv_heads + blockIdx.y;
  const int j0 = causal ? k0 / kBwdQ : 0;        // the first query tile that sees a key
  const int per_head = (t + kBwdQ - 1) / kBwdQ - j0;
  const int n_it = group * per_head;             // (query head, query tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kBwdThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: the loads of iteration i into its stage
  const auto issue = [&](int i) {
    const int s = i % kStages;
    const int q_head = blockIdx.z * heads + blockIdx.y * group + i / per_head;
    const int q0 = (j0 + i % per_head) * kBwdQ;
    const uint32_t qs = st_s + 2 * s * L::kQTile, dos = qs + L::kQTile;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * L::kQTile + L::kQAux);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(qs + c * kBwdQ * 128, &tq, bar, c * kBoxCols, q0, q_head);
      tma_load(dos + c * kBwdQ * 128, &tdo, bar, c * kBoxCols, q0, q_head);
    }
    const size_t row = (size_t)q_head * t_pad + q0;
    bulk_load(aux_s + s * L::kQAux, lse2 + row, kBwdQ * 4, bar);
    bulk_load(aux_s + s * L::kQAux + kBwdQ * 4, dsum + row, kBwdQ * 4, bar);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(kv_full, 2 * L::kKVTile);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(k_s + c * kBwdKeys * 128, &tk, kv_full, c * kBoxCols, k0, kv_head);
      tma_load(v_s + c * kBwdKeys * 128, &tv, kv_full, c * kBoxCols, k0, kv_head);
    }
    for (int i = 0; i < min(kStages, n_it); ++i) issue(i);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;        // accumulator fragment coordinates
  const int first = k0 + wg * 64;                // this warpgroup's keys
  const int key0 = first + warp * 16 + g, key1 = key0 + 8;
  const uint32_t k_wg = k_s + wg * 64 * 128, v_wg = v_s + wg * 64 * 128;
  const float scale_log2 = scale * 1.4426950408889634f;

  // dk_acc, dv_acc[4 n + e]: column 8 n + 2 tig + (e & 1) of key0 (e < 2) or
  // key1; st, dpt[4 n + e]: query 8 n + 2 tig + (e & 1) of the tile, the same keys
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
  mbar_wait(kv_full, 0);
  __syncwarp();

  for (int i = 0; i < n_it; ++i) {
    const int s = i % kStages;
    const int q0 = (j0 + i % per_head) * kBwdQ;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    __syncwarp();
    // causal: a tile whose every query precedes this warpgroup's keys adds nothing
    if (!(causal && q0 + kBwdQ <= first)) {
      const uint32_t qs = st_s + 2 * s * L::kQTile, dos = qs + L::kQTile;
      float st[kBwdQ / 2], dpt[kBwdQ / 2];
      wgmma_fence();
      ss_product<D>(st, k_wg, kBwdKeys, qs, kBwdQ);
      ss_product<D>(dpt, v_wg, kBwdKeys, dos, kBwdQ);
      wgmma_commit();
      wgmma_wait<0>();
      hold(st);
      hold(dpt);
      const float* la = aux + s * (2 * kBwdQ);
      const float* da = la + kBwdQ;
      const bool masked = q0 + kBwdQ > t || (causal && q0 < first + 64);
#pragma unroll
      for (int j = 0; j < kBwdQ / 2; ++j) {
        const int col = (j / 4) * 8 + tig * 2 + (j & 1);
        float p = ex2(fmaf(st[j], scale_log2, -la[col]));
        if (masked) {
          const int qi = q0 + col, key = (j & 2) ? key1 : key0;
          if (qi >= t || (causal && key > qi)) p = 0.0f;
        }
        st[j] = p;
        dpt[j] = p * (dpt[j] - da[col]);
      }
      uint32_t pf[kBwdQ / 16][4], dsf[kBwdQ / 16][4];
      to_a_fragments(st, pf);
      to_a_fragments(dpt, dsf);
      hold(dv_acc);
      hold(dk_acc);
      wgmma_fence();
      rs_product(dv_acc, pf, dos, kBwdQ);
      rs_product(dk_acc, dsf, qs, kBwdQ);
      wgmma_commit();
      wgmma_wait<0>();
      hold(dv_acc);
      hold(dk_acc);
    }
    mbar_arrive(empty + 8 * s);
    if (threadIdx.x == 0 && i + kStages < n_it) {
      mbar_wait(empty + 8 * s, (i / kStages) & 1);
      issue(i + kStages);
    }
    __syncwarp();
  }

  __nv_bfloat16* dkh = dk + (size_t)kv_head * t * D;
  __nv_bfloat16* dvh = dv + (size_t)kv_head * t * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (key0 < t) {
      *reinterpret_cast<uint32_t*>(dkh + (size_t)key0 * D + col) =
          pack_bf16(dk_acc[4 * n] * scale, dk_acc[4 * n + 1] * scale);
      *reinterpret_cast<uint32_t*>(dvh + (size_t)key0 * D + col) =
          pack_bf16(dv_acc[4 * n], dv_acc[4 * n + 1]);
    }
    if (key1 < t) {
      *reinterpret_cast<uint32_t*>(dkh + (size_t)key1 * D + col) =
          pack_bf16(dk_acc[4 * n + 2] * scale, dk_acc[4 * n + 3] * scale);
      *reinterpret_cast<uint32_t*>(dvh + (size_t)key1 * D + col) =
          pack_bf16(dv_acc[4 * n + 2], dv_acc[4 * n + 3]);
    }
  }
}

// dq: (B, H, T, D).  tq, tdo map q and dO by kBwdRows rows; tk, tv map k and
// v by kBwdKV rows.
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const float* __restrict__ lse2,
                        const float* __restrict__ dsum, __nv_bfloat16* __restrict__ dq, int heads,
                        int group, int t, int t_pad, int causal, float scale) {
  using L = BwdLayout<D>;
  constexpr int kStages = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kRowTile;
  const uint32_t aux_s = do_s + L::kRowTile;     // 128 LSE, then 128 D
  const uint32_t st_s = aux_s + L::kRowAux;      // stage s: K at st_s + 2 s tile, then V
  const uint32_t q_full = st_s + 2 * kStages * L::kKTile;
  const uint32_t full = q_full + 8, empty = full + 8 * kStages;
  const float* aux = reinterpret_cast<const float*>(smem_raw + (aux_s - raw));

  const int n_tiles_q = (t + kBwdRows - 1) / kBwdRows;
  const int q0 = (n_tiles_q - 1 - blockIdx.x) * kBwdRows;  // longest first
  const int q_head = blockIdx.z * heads + blockIdx.y;
  const int kv_head = blockIdx.z * (heads / group) + blockIdx.y / group;
  const int kv_end = causal ? min(q0 + kBwdRows, t) : t;
  const int n_kv = (kv_end + kBwdKV - 1) / kBwdKV;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kBwdThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0: key tile i into its stage
  const auto issue = [&](int i) {
    const int s = i % kStages;
    const uint32_t ks = st_s + 2 * s * L::kKTile, vs = ks + L::kKTile;
    const uint32_t bar = full + 8 * s;
    mbar_expect_tx(bar, 2 * L::kKTile);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(ks + c * kBwdKV * 128, &tk, bar, c * kBoxCols, i * kBwdKV, kv_head);
      tma_load(vs + c * kBwdKV * 128, &tv, bar, c * kBoxCols, i * kBwdKV, kv_head);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, 2 * L::kRowTile + L::kRowAux);
    for (int c = 0; c < L::kBoxes; ++c) {
      tma_load(q_s + c * kBwdRows * 128, &tq, q_full, c * kBoxCols, q0, q_head);
      tma_load(do_s + c * kBwdRows * 128, &tdo, q_full, c * kBoxCols, q0, q_head);
    }
    const size_t row = (size_t)q_head * t_pad + q0;
    bulk_load(aux_s, lse2 + row, kBwdRows * 4, q_full);
    bulk_load(aux_s + kBwdRows * 4, dsum + row, kBwdRows * 4, q_full);
    for (int i = 0; i < min(kStages, n_kv); ++i) issue(i);
  }
  __syncwarp();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const int first = q0 + wg * 64;                // this warpgroup's queries
  const int row0 = first + warp * 16 + g, row1 = row0 + 8;
  const uint32_t q_wg = q_s + wg * 64 * 128, do_wg = do_s + wg * 64 * 128;
  const float scale_log2 = scale * 1.4426950408889634f;

  mbar_wait(q_full, 0);
  __syncwarp();
  const float l0 = aux[row0 - q0], l1 = aux[row1 - q0];
  const float d0 = aux[kBwdRows + row0 - q0], d1 = aux[kBwdRows + row1 - q0];
  // dq_acc[4 n + e]: column 8 n + 2 tig + (e & 1) of row0 (e < 2) or row1;
  // sc, dp[4 n + e]: key 8 n + 2 tig + (e & 1) of the tile, the same rows
  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.0f;

  for (int i = 0; i < n_kv; ++i) {
    const int s = i % kStages, kv0 = i * kBwdKV;
    mbar_wait(full + 8 * s, (i / kStages) & 1);
    __syncwarp();
    // causal: a tile whose every key follows this warpgroup's queries adds nothing
    if (!(causal && kv0 > first + 63)) {
      const uint32_t ks = st_s + 2 * s * L::kKTile, vs = ks + L::kKTile;
      float sc[kBwdKV / 2], dp[kBwdKV / 2];
      wgmma_fence();
      ss_product<D>(sc, q_wg, kBwdRows, ks, kBwdKV);
      ss_product<D>(dp, do_wg, kBwdRows, vs, kBwdKV);
      wgmma_commit();
      wgmma_wait<0>();
      hold(sc);
      hold(dp);
      const bool masked = kv0 + kBwdKV > t || (causal && kv0 + kBwdKV - 1 > first);
#pragma unroll
      for (int j = 0; j < kBwdKV / 2; ++j) {
        const bool hi = j & 2;
        float p = ex2(fmaf(sc[j], scale_log2, -(hi ? l1 : l0)));
        if (masked) {
          const int key = kv0 + (j / 4) * 8 + tig * 2 + (j & 1);
          if (key >= t || (causal && key > (hi ? row1 : row0))) p = 0.0f;
        }
        dp[j] = p * (dp[j] - (hi ? d1 : d0));
      }
      uint32_t dsf[kBwdKV / 16][4];
      to_a_fragments(dp, dsf);
      hold(dq_acc);
      wgmma_fence();
      rs_product(dq_acc, dsf, ks, kBwdKV);
      wgmma_commit();
      wgmma_wait<0>();
      hold(dq_acc);
    }
    mbar_arrive(empty + 8 * s);
    if (threadIdx.x == 0 && i + kStages < n_kv) {
      mbar_wait(empty + 8 * s, (i / kStages) & 1);
      issue(i + kStages);
    }
    __syncwarp();
  }

  __nv_bfloat16* dqh = dq + (size_t)q_head * t * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + tig * 2;
    if (row0 < t)
      *reinterpret_cast<uint32_t*>(dqh + (size_t)row0 * D + col) =
          pack_bf16(dq_acc[4 * n] * scale, dq_acc[4 * n + 1] * scale);
    if (row1 < t)
      *reinterpret_cast<uint32_t*>(dqh + (size_t)row1 * D + col) =
          pack_bf16(dq_acc[4 * n + 2] * scale, dq_acc[4 * n + 3] * scale);
  }
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no -lcuda; null if the driver lacks it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// (heads, t, d) contiguous bf16 at ptr as boxes of 64 columns x `rows` rows
// of one head, 128-byte swizzled; rows at or past t read as zeros
bool encode_map(CUtensorMap* map, const void* ptr, int d, int t, int heads, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the Hopper route's kernel at (DK, DV): flash_bf16_sm90_kernel<D, kLse> at
// DK = DV = D, flash_mla_sm90_kernel at (192, 128)
template <int DK, int DV, bool kLse>
auto sm90_kernel() {
  if constexpr (DK == DV)
    return flash_bf16_sm90_kernel<DK, kLse>;
  else
    return flash_mla_sm90_kernel;
}

template <int DK, int DV, bool kLse>
int launch_sm90(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                int heads, int group, int t, int causal, float scale, cudaStream_t stream) {
  using L = Sm90Layout<DK, DV>;
  const auto kernel = sm90_kernel<DK, DV, kLse>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, q, DK, t, batch * heads, kSm90Rows) ||
      !encode_map(&tk, k, DK, t, batch * (heads / group), L::kKeys) ||
      !encode_map(&tv, v, DV, t, batch * (heads / group), L::kKeys))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((t + kSm90Rows - 1) / kSm90Rows, heads, batch);
  kernel<<<grid, kSm90Threads, L::kSmem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, heads, group, t, causal, scale);
  return (int)cudaGetLastError();
}

// the backward's three launches on one stream; scratch holds 2 B H t_pad f32
// (lse2, then dsum), t_pad = t rounded up to kBwdPad
template <int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
               const float* lse, void* dq, void* dk, void* dv, float* scratch, int batch,
               int heads, int group, int t, int causal, float scale, cudaStream_t stream) {
  using L = BwdLayout<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         L::kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kDqSmem);
  if (err != cudaSuccess) return (int)err;
  const int q_heads = batch * heads, kv_heads = batch * (heads / group);
  CUtensorMap tq_dkdv, tdo_dkdv, tk_dkdv, tv_dkdv, tq_dq, tdo_dq, tk_dq, tv_dq;
  if (!encode_map(&tq_dkdv, q, D, t, q_heads, kBwdQ) ||
      !encode_map(&tdo_dkdv, dout, D, t, q_heads, kBwdQ) ||
      !encode_map(&tk_dkdv, k, D, t, kv_heads, kBwdKeys) ||
      !encode_map(&tv_dkdv, v, D, t, kv_heads, kBwdKeys) ||
      !encode_map(&tq_dq, q, D, t, q_heads, kBwdRows) ||
      !encode_map(&tdo_dq, dout, D, t, q_heads, kBwdRows) ||
      !encode_map(&tk_dq, k, D, t, kv_heads, kBwdKV) ||
      !encode_map(&tv_dq, v, D, t, kv_heads, kBwdKV))
    return (int)cudaErrorInvalidValue;
  const int t_pad = (t + kBwdPad - 1) / kBwdPad * kBwdPad;
  const int rows = q_heads * t_pad;
  float* lse2 = scratch;
  float* dsum = scratch + (size_t)rows;
  flash_bwd_prep_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout), lse, lse2,
      dsum, t, t_pad, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dq_kernel<D><<<dim3((t + kBwdRows - 1) / kBwdRows, heads, batch), kBwdThreads,
                           L::kDqSmem, stream>>>(tq_dq, tk_dq, tv_dq, tdo_dq, lse2, dsum,
                                                 static_cast<__nv_bfloat16*>(dq), heads, group,
                                                 t, t_pad, causal, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<dim3((t + kBwdKeys - 1) / kBwdKeys, heads / group, batch),
                             kBwdThreads, L::kDkdvSmem, stream>>>(
      tq_dkdv, tk_dkdv, tv_dkdv, tdo_dkdv, lse2, dsum, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, group, t, t_pad, causal, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int heads,
           int group, int t, int dtype, int causal, float scale, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((t + kF32Rows - 1) / kF32Rows, heads, batch);
    flash_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), heads, group, t, causal, scale);
  } else if constexpr (D == 64 || D == 128) {
    return launch_sm90<D, D, false>(q, k, v, o, nullptr, batch, heads, group, t, causal,
                                    scale, stream);
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

// q: (batch, heads, t, d); k: (batch, heads / group, t, d); v: (batch,
// heads / group, t, dv); o: (batch, heads, t, dv); all contiguous, 16-byte
// aligned, of one dtype: 0 = f32, 1 = bf16.  d = dv is 16, 32, 64 or 128,
// and (d, dv) = (192, 128) takes bf16 alone.  scale is usually d^-0.5.  bf16
// at d = dv = 64 or 128, and at (192, 128), runs the Hopper route; a tensor
// map it cannot encode returns cudaErrorInvalidValue.
int repro_flash_attention(const void* q, const void* k, const void* v, void* o, int batch,
                          int heads, int group, int t, int d, int dv, int dtype, int causal,
                          float scale, void* stream) {
  if ((dtype != 0 && dtype != 1) || group < 1 || heads % group != 0 || t < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dv != d) {
    if (d != 192 || dv != 128 || dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_sm90<192, 128, false>(q, k, v, o, nullptr, batch, heads, group, t, causal,
                                        scale, s);
  }
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

// K8's bf16 Hopper route (d = 64 or 128) as repro_flash_attention runs it,
// also storing each query row's f32 log-sum-exp of its scaled scores at lse,
// (batch, heads, t): the forward the backward below needs.
int repro_flash_attention_lse(const void* q, const void* k, const void* v, void* o, float* lse,
                              int batch, int heads, int group, int t, int d, int causal,
                              float scale, void* stream) {
  if (group < 1 || heads % group != 0 || t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_sm90<64, 64, true>(q, k, v, o, lse, batch, heads, group, t, causal, scale,
                                       s);
    case 128:
      return launch_sm90<128, 128, true>(q, k, v, o, lse, batch, heads, group, t, causal,
                                         scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The gradients dq (batch, heads, t, d) and dk, dv (batch, heads / group, t,
// d) of that forward, from its q, k, v, output o and lse and the output's
// gradient dout; all bf16 but lse, contiguous, 16-byte aligned, d 64 or
// 128.  scratch: 2 batch heads t_pad f32, t_pad = t rounded up to 128.
int repro_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* dout, const float* lse, void* dq, void* dk, void* dv,
                              float* scratch, int batch, int heads, int group, int t, int d,
                              int causal, float scale, void* stream) {
  if (group < 1 || heads % group != 0 || t < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, lse, dq, dk, dv, scratch, batch, heads, group, t,
                            causal, scale, s);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, lse, dq, dk, dv, scratch, batch, heads, group, t,
                             causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// bytes of dynamic shared memory a block of the backward's dK/dV kernel
// (kernel 0) or dQ kernel (kernel 1) takes at head size d (64 or 128)
int repro_flash_attention_bwd_smem(int d, int kernel) {
  switch (d) {
    case 64:
      return kernel ? BwdLayout<64>::kDqSmem : BwdLayout<64>::kDkdvSmem;
    case 128:
      return kernel ? BwdLayout<128>::kDqSmem : BwdLayout<128>::kDkdvSmem;
    default:
      return 0;
  }
}

// bytes of dynamic shared memory a block of the bf16 route takes at head
// sizes (d, dv): the Hopper route's Q and K/V ring, 0 on the mma.sync route
int repro_flash_attention_smem(int d, int dv) {
  if (d == 192 && dv == 128) return Sm90Layout<192, 128>::kSmem;
  if (dv != d) return 0;
  switch (d) {
    case 64:
      return Sm90Layout<64, 64>::kSmem;
    case 128:
      return Sm90Layout<128, 128>::kSmem;
    default:
      return 0;
  }
}

}  // extern "C"
