// The chunked SSD of Mamba-2 (state-space duality, arXiv:2405.21060) for
// Hopper: three kernels launched by one call, repro_ssd.
//
// Replaces no TPU kernel: the reference computes the SSD outside any Pallas
// kernel (src/repro/models/mamba2.py, _ssd_chunked, in jnp.einsum).  It was
// added because the port's plain version (models/mamba2.py, _ssd_chunked's
// plain route) stores the segment-sum decay exp(cum_l - cum_m) of every
// chunk and head, an f32 (B, chunks, H, L, L) tensor (4.3 GB a layer at
// 32k tokens, chunk 256, 128 heads), passes over it four times, and walks
// the chunks in a host loop.  Here that decay lives only in registers.
//
// Inputs, for one sequence b, chunk c of L positions, head h (P = 64):
//   x (B, T, H, P) bf16, dt (B, T, H) f32, a (H,) f32, B and C (B, T, N)
//   bf16, each read with its strides (x, B and C are views of the causal
//   conv's output).  cum_l is the inclusive cumsum of dt a over the chunk.
// The three stages:
//   1. ssd_chunk_state: a block per (head group, chunk, sequence).  It
//      stores cum (B, chunks, H, L) and each head's chunk state
//        S = sum_j exp(cum_last - cum_j) dt_j x_j B_j^T        (P x N, f32)
//   2. ssd_state_pass: a thread per (sequence, head, four of p x n) walks
//      the chunks in order: h_in[c] = h, stored as three bf16 planes (the
//      form stage 3 multiplies it in); h = exp(cum_last[c]) h + S[c].  It
//      writes the final state (B, H, P, N) f32.
//   3. ssd_chunk_scan: a block per (64-row tile, head group, chunk and
//      sequence) computes its tile of C B^T once for all its heads, then
//      for each head
//        y_l = exp(cum_l) C_l h_in^T + sum_{m <= l} exp(cum_l - cum_m)
//              (C_l . B_m) dt_m x_m
//      with the pair factor formed in registers; tiles above the diagonal
//      are skipped.  y is (B, T, H, P) f32.
// cum is summed one position after another, as the plain version's
// torch.cumsum sums it, so every exponential takes the plain version's
// argument; its recurrence (exp(w) h + s, a product then a sum) is kept
// exactly in stage 2.  A ragged last chunk is masked in each kernel: rows
// past T read as zeros, as the plain version's padding does (dt = 0 leaves
// cum flat and adds nothing).
//
// Precision: the SSD is f32 work.  x, B and C are bf16 and enter the
// tensor-core products as they are; each f32 factor (x_j times its f32
// weight in stage 1, the pair factor and h_in in stage 3) enters as the sum
// of three bf16 terms (hi, mid, lo: 24 bits, an f32's significand), each
// product of a bf16 pair is exact and sums in f32, so every product equals
// its f32 value to about 2^-24 relative.  No TF32; no fast-math exponential
// (expf, whose error does not grow with |argument|: cum reaches hundreds of
// nats).  mma.sync.m16n8k16 bf16 -> f32 throughout.  Against the plain
// version on the card: within 2e-6 of max |y| at the test shapes.
//
// Bound on an H100 at 32k tokens (chunk 256, N 128, H 128): bytes.  Read
// once and written once, x, dt, B, C, y (f32) and the final state are about
// 1.6 GB (0.49 ms at 3.35 TB/s), against 0.21 TFLOP of model products
// (0.21 ms at 989 TFLOP/s); as designed, x is read twice, S written and
// read, h_in's planes written and read (about 3.8 GB), and the three-term
// products are about 0.63 TFLOP.  So the design keeps the decay, the pair
// factors and the products' operands on chip: a block holds its chunk's B
// (stage 1) or its tile of C B^T (stage 3) in shared memory for eight
// heads, two warpgroups taking the heads in turns (named barriers, so one
// loads while the other multiplies), and adjacent blocks share x and h_in
// through L2.  Stage 1 loads the next k-tile's x while its products run;
// stage 3 takes two exponentials a 16-column block below the diagonal
// (exp(cum_l - cum_e) exp(cum_e - cum_m), both at most 1) and eight on it.
// At 32k tokens the three take 4.6 ms a layer (0.11 of the bound; the
// plain version 37 ms), most of it stage 3's copies of h_in's planes and x
// from L2, which its four row tiles each read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 64;                           // head size
constexpr int kRows = 64;                        // a scan block's rows; a state block's k-tile
constexpr int kHeads = 8;                        // heads a block
constexpr int kGroups = 2;                       // warpgroups a block, taking the heads in turns
constexpr int kThreads = 128 * kGroups;
constexpr int kPad = 8;                          // bf16 a shared row: ldmatrix without conflicts
constexpr int kXLd = kP + kPad;
constexpr int kPassThreads = 256;

struct SsdArgs {
  const __nv_bfloat16* x;
  long long sxb, sxt, sxh;
  const float* dt;
  long long sdb, sdt, sdh;
  const float* a;
  const __nv_bfloat16* bm;
  long long sbb, sbt;
  const __nv_bfloat16* cm;
  long long scb, sct;
  float* cum;                                    // (B, nc, H, L)
  float* states;                                 // (B, nc, H, P, N): S
  __nv_bfloat16* hin;                            // (B, nc, H, 3, P, N): h_in's bf16 planes
  float* y;                                      // (B, T, H, P)
  float* final_state;                            // (B, H, P, N)
  int t, heads, nc;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane i gives a row address of matrix i / 8
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 128 threads of warpgroup g wait for each other (barrier 0 is the block's)
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
}

// v = hi + mid + lo to about 2^-24 |v|: each difference is exact in f32
__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&t)[3]) {
  t[0] = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(t[0]);
  t[1] = __float2bfloat16_rn(r);
  t[2] = __float2bfloat16_rn(r - __bfloat162float(t[1]));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// rows [pos0, pos0 + rows) of a (T, W) bf16 matrix with row stride `stride`
// into dst (row length W + kPad), 16 bytes a thread a step; rows at or past
// t are zeros
template <int W>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, long long pos0, int rows, int t,
                                          int tid, int nthreads) {
  constexpr int kChunks = W / 8;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks, c8 = (i % kChunks) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (pos0 + r < t) v = *reinterpret_cast<const uint4*>(src + (pos0 + r) * stride + c8);
    *reinterpret_cast<uint4*>(dst + r * (W + kPad) + c8) = v;
  }
}

template <int L, int N>
constexpr size_t state_smem() {
  return (size_t)L * (N + kPad) * 2 + 2 * (size_t)kHeads * L * 4 +
         (size_t)kGroups * 3 * kRows * kXLd * 2;
}

template <int L, int N>
__host__ __device__ constexpr int scan_region() {  // bf16 elements a warpgroup
  return L * kXLd > 3 * kP * (N + kPad) ? L * kXLd : 3 * kP * (N + kPad);
}

template <int L, int N>
constexpr size_t scan_smem() {
  return (size_t)kRows * (L + 8) * 4 + 3 * (size_t)kHeads * L * 4 +
         (size_t)kRows * (N + kPad) * 2 + (size_t)kGroups * scan_region<L, N>() * 2;
}

// ---------------------------------------------------------------------------
// 1. cum and each chunk's state
// ---------------------------------------------------------------------------

template <int L, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_state_kernel(const SsdArgs p) {
  constexpr int kNLd = N + kPad;
  constexpr int kPlane = kRows * kXLd;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* bs = reinterpret_cast<__nv_bfloat16*>(smem);                 // [L][kNLd]
  float* cm = reinterpret_cast<float*>(bs + L * kNLd);               // [L][kHeads]: dt a, then cum
  float* wv = cm + kHeads * L;                                       // [L][kHeads]: dt, then w
  auto* planes = reinterpret_cast<__nv_bfloat16*>(wv + kHeads * L);  // [kGroups][3][kRows][kXLd]

  const int h0 = blockIdx.x * kHeads, c = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long pos0 = (long long)c * L;

  load_rows<N>(bs, p.bm + b * p.sbb, p.sbt, pos0, L, p.t, tid, kThreads);
  for (int i = tid; i < L * kHeads; i += kThreads) {  // i = r kHeads + hh
    const int r = i / kHeads, h = h0 + i % kHeads;
    float d = 0.0f, da = 0.0f;
    if (h < p.heads && pos0 + r < p.t) {
      d = p.dt[b * p.sdb + (pos0 + r) * p.sdt + h * p.sdh];
      da = d * p.a[h];
    }
    wv[i] = d;
    cm[i] = da;
  }
  __syncthreads();

  // thread hh: its head's inclusive cumsum, one position after another in
  // f32, the order of the plain version's torch.cumsum over a dimension
  // that is not the innermost (a sequential scan a column), so that every
  // decay exp(cum_l - cum_m) takes the plain version's argument
  if (tid < kHeads) {
    float run = 0.0f;
#pragma unroll 8
    for (int r = 0; r < L; ++r) {
      run += cm[r * kHeads + tid];
      cm[r * kHeads + tid] = run;
    }
  }
  __syncthreads();
  // w_j = exp(cum_last - cum_j) dt_j; cum out, a head's positions in a row
  for (int i = tid; i < L * kHeads; i += kThreads) {
    const int hh = i / L, r = i % L, h = h0 + hh;
    const float cv = cm[r * kHeads + hh];
    wv[r * kHeads + hh] *= expf(cm[(L - 1) * kHeads + hh] - cv);
    if (h < p.heads) p.cum[(((size_t)b * p.nc + c) * p.heads + h) * L + r] = cv;
  }
  __syncthreads();

  // S (P x N) = (x o w)^T B: warp wq of a warpgroup takes rows p of
  // [16 wq, 16 wq + 16) and every n; x o w goes through shared memory as
  // three bf16 planes, a 64-position k-tile at a time.  A warpgroup walks
  // its (head, k-tile) items in turn, the next item's x loaded into
  // registers while this one's products run
  constexpr int kTiles = L / kRows, kLoads = kRows * (kP / 8) / 128;
  const int grp = warp / 4, wq = warp % 4, lt = tid % 128;
  const int g = lane / 4, tg = lane % 4, mi = lane / 8, mr = lane % 8;
  __nv_bfloat16* pl = planes + grp * 3 * kPlane;
  const int heads_here = min(kHeads, p.heads - h0);
  const int items = (heads_here - grp + kGroups - 1) / kGroups * kTiles;
  uint4 raw[kLoads];
  auto fetch = [&](int item) {
    const int h = h0 + grp + kGroups * (item / kTiles), k0 = (item % kTiles) * kRows;
    const __nv_bfloat16* xh = p.x + b * p.sxb + h * p.sxh;
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = lt + 128 * q, r = i / (kP / 8), c8 = (i % (kP / 8)) * 8;
      const long long pos = pos0 + k0 + r;
      raw[q] = pos < p.t ? *reinterpret_cast<const uint4*>(xh + pos * p.sxt + c8)
                         : make_uint4(0, 0, 0, 0);
    }
  };
  if (items > 0) fetch(0);
  float acc[N / 8][4];
  for (int item = 0; item < items; ++item) {
    const int hh = grp + kGroups * (item / kTiles), k0 = (item % kTiles) * kRows;
    if (k0 == 0) {
#pragma unroll
      for (int n = 0; n < N / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
    }
    group_sync(grp);                             // the last item's planes are read
#pragma unroll
    for (int q = 0; q < kLoads; ++q) {
      const int i = lt + 128 * q, r = i / (kP / 8), c8 = (i % (kP / 8)) * 8;
      const float w = wv[(k0 + r) * kHeads + hh];
      const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(&raw[q]);
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat16 s0[3], s1[3];
        split3(__bfloat162float(xv[2 * e]) * w, s0);
        split3(__bfloat162float(xv[2 * e + 1]) * w, s1);
        hi[e] = pack(s0[0], s1[0]);
        mid[e] = pack(s0[1], s1[1]);
        lo[e] = pack(s0[2], s1[2]);
      }
      const int at = r * kXLd + c8;
      *reinterpret_cast<uint4*>(pl + at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(pl + kPlane + at) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
      *reinterpret_cast<uint4*>(pl + 2 * kPlane + at) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    if (item + 1 < items) fetch(item + 1);
    group_sync(grp);
#pragma unroll
    for (int ks = 0; ks < kRows / 16; ++ks) {
      // A = (x o w)^T: the planes hold it k-major ([position][p])
      uint32_t af[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        ldsm_t(af[q], pl + q * kPlane + (ks * 16 + mr + (mi >> 1) * 8) * kXLd + wq * 16 +
                          (mi & 1) * 8);
#pragma unroll
      for (int np = 0; np < N / 16; ++np) {
        uint32_t bf[4];
        ldsm_t(bf, bs + (k0 + ks * 16 + mr + (mi & 1) * 8) * kNLd + np * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int q = 2; q >= 0; --q) {           // lo, mid, hi
          mma_bf16(acc[2 * np], af[q], bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], af[q], bf[2], bf[3]);
        }
      }
    }
    if (k0 + kRows == L) {
      float* sh = p.states + (((size_t)b * p.nc + c) * p.heads + h0 + hh) * (kP * N);
      const int r0 = wq * 16 + g;
#pragma unroll
      for (int n = 0; n < N / 8; ++n) {
        const int col = n * 8 + tg * 2;
        *reinterpret_cast<float2*>(sh + r0 * N + col) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(sh + (r0 + 8) * N + col) = make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// 2. the recurrence across chunks
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads) ssd_state_pass_kernel(const SsdArgs p, int L,
                                                                      int pn) {
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4, h = blockIdx.y, b = blockIdx.z;
  if (e >= pn) return;
  const float* last = p.cum + ((size_t)b * p.nc * p.heads + h) * L + (L - 1);
  const float* s = p.states + ((size_t)b * p.nc * p.heads + h) * pn + e;
  __nv_bfloat16* hin = p.hin + ((size_t)b * p.nc * p.heads + h) * 3 * pn + e;
  const size_t cum_step = (size_t)p.heads * L, state_step = (size_t)p.heads * pn;
  constexpr int kAhead = 8;                      // chunks whose loads are in flight at once
  float4 hcur = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // h_in of a chunk, as three bf16 planes; then h = exp(cum_last) h + S
  auto step = [&](int c, float decay, float4 chunk) {
    __nv_bfloat16 s0[3], s1[3], s2[3], s3[3];
    split3(hcur.x, s0);
    split3(hcur.y, s1);
    split3(hcur.z, s2);
    split3(hcur.w, s3);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      *reinterpret_cast<uint2*>(hin + c * 3 * state_step + q * pn) =
          make_uint2(pack(s0[q], s1[q]), pack(s2[q], s3[q]));
    hcur.x = __fadd_rn(__fmul_rn(decay, hcur.x), chunk.x);
    hcur.y = __fadd_rn(__fmul_rn(decay, hcur.y), chunk.y);
    hcur.z = __fadd_rn(__fmul_rn(decay, hcur.z), chunk.z);
    hcur.w = __fadd_rn(__fmul_rn(decay, hcur.w), chunk.w);
  };
  int c = 0;
  for (; c + kAhead <= p.nc; c += kAhead) {
    float decay[kAhead];
    float4 chunk[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      decay[u] = expf(last[(c + u) * cum_step]);
      chunk[u] = *reinterpret_cast<const float4*>(s + (c + u) * state_step);
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) step(c + u, decay[u], chunk[u]);
  }
  for (; c < p.nc; ++c)
    step(c, expf(last[c * cum_step]), *reinterpret_cast<const float4*>(s + c * state_step));
  *reinterpret_cast<float4*>(p.final_state + ((size_t)b * p.heads + h) * pn + e) = hcur;
}

// ---------------------------------------------------------------------------
// 3. each chunk's output
// ---------------------------------------------------------------------------

template <int L, int N>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_scan_kernel(const SsdArgs p) {
  constexpr int kNLd = N + kPad, kCbLd = L + 8;   // f32 rows of C B^T: 8 banks apart
  constexpr int kRegion = scan_region<L, N>();
  constexpr int kPlane = kP * kNLd;
  static_assert(L * kNLd <= kGroups * kRegion, "B's rows fit the warpgroups' regions");
  extern __shared__ __align__(16) unsigned char smem[];
  float* cb = reinterpret_cast<float*>(smem);                        // [kRows][kCbLd]
  float* cmv = cb + kRows * kCbLd;                                   // [kHeads][L]: cum
  float* dtv = cmv + kHeads * L;                                     // [kHeads][L]: dt
  float* fdv = dtv + kHeads * L;                                     // [kHeads][L]: see below
  auto* cs = reinterpret_cast<__nv_bfloat16*>(fdv + kHeads * L);     // [kRows][kNLd]: C
  auto* region = cs + kRows * kNLd;                                  // [kGroups][kRegion]
  __nv_bfloat16* bs = region;                                        // [row0 + kRows][kNLd], first

  const int row0 = blockIdx.x * kRows, h0 = blockIdx.y * kHeads;
  const int b = blockIdx.z / p.nc, c = blockIdx.z % p.nc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tg = lane % 4, mi = lane / 8, mr = lane % 8;
  const long long pos0 = (long long)c * L;

  load_rows<N>(cs, p.cm + b * p.scb, p.sct, pos0 + row0, kRows, p.t, tid, kThreads);
  load_rows<N>(bs, p.bm + b * p.sbb, p.sbt, pos0, row0 + kRows, p.t, tid, kThreads);
  for (int i = tid; i < L * kHeads; i += kThreads) {
    const int hh = i / L, r = i % L, h = h0 + hh;
    cmv[i] = h < p.heads ? p.cum[(((size_t)b * p.nc + c) * p.heads + h) * L + r] : 0.0f;
  }
  for (int i = tid; i < L * kHeads; i += kThreads) {
    const int r = i / kHeads, hh = i % kHeads, h = h0 + hh;
    dtv[hh * L + r] = h < p.heads && pos0 + r < p.t
                          ? p.dt[b * p.sdb + (pos0 + r) * p.sdt + h * p.sdh]
                          : 0.0f;
  }
  __syncthreads();
  // fd_m = exp(cum_e - cum_m) dt_m, e the last column of m's 16-column
  // block: below the diagonal block, exp(cum_l - cum_m) is taken as
  // exp(cum_l - cum_e) fd_m / dt_m, two factors of at most 1, so that a
  // thread takes two exponentials a block and not eight
  for (int i = tid; i < L * kHeads; i += kThreads)
    fdv[i] = expf(cmv[i | 15] - cmv[i]) * dtv[i];

  // C B^T for the tile's rows, up to the diagonal: warp w takes row strip
  // w % 4 and every other 16-column block
  {
    const int s = warp % 4;
    uint32_t cf[N / 16][4];
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks)
      ldsm(cf[ks], cs + (s * 16 + mr + (mi & 1) * 8) * kNLd + ks * 16 + (mi >> 1) * 8);
    const int blocks = (row0 + s * 16) / 16 + 1;
    for (int q = warp / 4; q < blocks; q += 2) {
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        uint32_t bf[4];
        ldsm(bf, bs + (q * 16 + mr + (mi >> 1) * 8) * kNLd + ks * 16 + (mi & 1) * 8);
        mma_bf16(acc[0], cf[ks], bf[0], bf[1]);
        mma_bf16(acc[1], cf[ks], bf[2], bf[3]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int col = q * 16 + u * 8 + tg * 2;
        *reinterpret_cast<float2*>(cb + (s * 16 + g) * kCbLd + col) =
            make_float2(acc[u][0], acc[u][1]);
        *reinterpret_cast<float2*>(cb + (s * 16 + g + 8) * kCbLd + col) =
            make_float2(acc[u][2], acc[u][3]);
      }
    }
  }
  __syncthreads();                               // C B^T is whole; B's rows are free

  // each warpgroup its heads in turn: warp wq takes the tile's rows
  // [16 wq, 16 wq + 16), every p
  const int grp = warp / 4, wq = warp % 4, lt = tid % 128;
  __nv_bfloat16* hs = region + grp * kRegion;    // [3][kP][kNLd]: h_in's planes
  __nv_bfloat16* xs = hs;                        // [row0 + kRows][kXLd]: x, after them
  const int lr0 = row0 + wq * 16 + g, lr1 = lr0 + 8;
  const int kmax = (row0 + wq * 16) / 16;        // the diagonal's 16-column block
  for (int hh = grp; hh < kHeads && h0 + hh < p.heads; hh += kGroups) {
    const int h = h0 + hh;
    group_sync(grp);                             // the last head's x is read
    load_rows<N>(hs, p.hin + (((size_t)b * p.nc + c) * p.heads + h) * 3 * kP * N, N, 0,
                 3 * kP, 3 * kP, lt, 128);
    group_sync(grp);

    // y = exp(cum_l) C_l h_in^T: A = C, B = h_in^T (h_in is [p][n], n-major)
    float acc[kP / 8][4];
#pragma unroll
    for (int n = 0; n < kP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < N / 16; ++ks) {
      uint32_t af[4];
      ldsm(af, cs + (wq * 16 + mr + (mi & 1) * 8) * kNLd + ks * 16 + (mi >> 1) * 8);
#pragma unroll
      for (int np = 0; np < kP / 16; ++np) {
#pragma unroll
        for (int q = 2; q >= 0; --q) {
          uint32_t bf[4];
          ldsm(bf, hs + q * kPlane + (np * 16 + mr + (mi >> 1) * 8) * kNLd + ks * 16 +
                       (mi & 1) * 8);
          mma_bf16(acc[2 * np], af, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], af, bf[2], bf[3]);
        }
      }
    }
    const float cl0 = cmv[hh * L + lr0], cl1 = cmv[hh * L + lr1];
    const float e0 = expf(cl0), e1 = expf(cl1);
#pragma unroll
    for (int n = 0; n < kP / 8; ++n) {
      acc[n][0] *= e0;
      acc[n][1] *= e0;
      acc[n][2] *= e1;
      acc[n][3] *= e1;
    }

    group_sync(grp);                             // h_in's planes are read
    load_rows<kP>(xs, p.x + b * p.sxb + h * p.sxh, p.sxt, pos0, row0 + kRows, p.t, lt, 128);
    group_sync(grp);

    // y += pair x over the 16-column blocks up to the diagonal: the pair
    // factor exp(cum_l - cum_m) (C_l . B_m) dt_m, 0 for m > l, is built in
    // the A-fragment layout (rows lr0, lr1; columns 2 tg, 2 tg + 1 and 8
    // more), then multiplied as three bf16 terms.  On the diagonal block
    // each entry takes its own exponential (there cum_e - cum_l may be
    // large and positive); below it, exp(cum_l - cum_e) fd_m
    for (int kk = 0; kk <= kmax; ++kk) {
      const bool diag = kk == kmax;
      const float ce = cmv[hh * L + kk * 16 + 15];
      const float r0 = diag ? 0.0f : expf(cl0 - ce), r1 = diag ? 0.0f : expf(cl1 - ce);
      uint32_t pa[3][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = kk * 16 + half * 8 + tg * 2;
        const float2 s0 = *reinterpret_cast<const float2*>(cb + (lr0 - row0) * kCbLd + m);
        const float2 s1 = *reinterpret_cast<const float2*>(cb + (lr1 - row0) * kCbLd + m);
        float v[4];
        if (diag) {
          const float cm0 = cmv[hh * L + m], cm1 = cmv[hh * L + m + 1];
          const float d0 = dtv[hh * L + m], d1 = dtv[hh * L + m + 1];
          v[0] = m <= lr0 ? expf(cl0 - cm0) * s0.x * d0 : 0.0f;
          v[1] = m + 1 <= lr0 ? expf(cl0 - cm1) * s0.y * d1 : 0.0f;
          v[2] = m <= lr1 ? expf(cl1 - cm0) * s1.x * d0 : 0.0f;
          v[3] = m + 1 <= lr1 ? expf(cl1 - cm1) * s1.y * d1 : 0.0f;
        } else {
          const float f0 = fdv[hh * L + m], f1 = fdv[hh * L + m + 1];
          v[0] = r0 * s0.x * f0;
          v[1] = r0 * s0.y * f1;
          v[2] = r1 * s1.x * f0;
          v[3] = r1 * s1.y * f1;
        }
        __nv_bfloat16 v00[3], v01[3], v10[3], v11[3];
        split3(v[0], v00);
        split3(v[1], v01);
        split3(v[2], v10);
        split3(v[3], v11);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          pa[q][half * 2] = pack(v00[q], v01[q]);
          pa[q][half * 2 + 1] = pack(v10[q], v11[q]);
        }
      }
#pragma unroll
      for (int np = 0; np < kP / 16; ++np) {
        uint32_t bf[4];                          // B = x, [m][p]
        ldsm_t(bf, xs + (kk * 16 + mr + (mi & 1) * 8) * kXLd + np * 16 + (mi >> 1) * 8);
#pragma unroll
        for (int q = 2; q >= 0; --q) {
          mma_bf16(acc[2 * np], pa[q], bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa[q], bf[2], bf[3]);
        }
      }
    }

    const long long q0 = pos0 + lr0, q1 = pos0 + lr1;
#pragma unroll
    for (int n = 0; n < kP / 8; ++n) {
      const int col = n * 8 + tg * 2;
      if (q0 < p.t)
        *reinterpret_cast<float2*>(p.y + ((b * (long long)p.t + q0) * p.heads + h) * kP + col) =
            make_float2(acc[n][0], acc[n][1]);
      if (q1 < p.t)
        *reinterpret_cast<float2*>(p.y + ((b * (long long)p.t + q1) * p.heads + h) * kP + col) =
            make_float2(acc[n][2], acc[n][3]);
    }
  }
}

template <int L, int N>
int launch(const SsdArgs& args, int batch, cudaStream_t stream) {
  const size_t s1 = state_smem<L, N>(), s3 = scan_smem<L, N>();
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state_kernel<L, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s1);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<L, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3);
  if (err != cudaSuccess) return (int)err;
  const int groups = (args.heads + kHeads - 1) / kHeads;
  ssd_chunk_state_kernel<L, N><<<dim3(groups, args.nc, batch), kThreads, s1, stream>>>(args);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_state_pass_kernel<<<dim3(kP * N / (4 * kPassThreads), args.heads, batch), kPassThreads,
                          0, stream>>>(args, L, kP * N);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ssd_chunk_scan_kernel<L, N>
      <<<dim3(L / kRows, groups, batch * args.nc), kThreads, s3, stream>>>(args);
  return (int)cudaGetLastError();
}

template <int L>
int launch_n(const SsdArgs& args, int batch, int n, cudaStream_t stream) {
  switch (n) {
    case 64:
      return launch<L, 64>(args, batch, stream);
    case 128:
      return launch<L, 128>(args, batch, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The chunked SSD, three launches on `stream`.  x (batch, t, heads, 64)
// bf16, dt (batch, t, heads) f32 and B, C (batch, t, n) bf16 by their
// element strides (each row's last dim contiguous; x, B and C 16-byte
// aligned with strides of whole 8-element groups), a (heads,) f32.  cum
// (batch, chunks, heads, chunk) and states (batch, chunks, heads, 64, n)
// f32 and hin (batch, chunks, heads, 3, 64, n) bf16 are scratch; y (batch, t, heads, 64) and final_state (batch, heads,
// 64, n) f32 are the results.  n is 64 or 128, chunk 64, 128 or 256.
int repro_ssd(const void* x, long long sxb, long long sxt, long long sxh, const void* dt,
              long long sdb, long long sdt, long long sdh, const void* a, const void* bm,
              long long sbb, long long sbt, const void* cm, long long scb, long long sct,
              void* cum, void* states, void* hin, void* y, void* final_state, int batch, int t,
              int heads, int n, int chunk, void* stream) {
  if (batch < 1 || t < 1 || heads < 1) return (int)cudaErrorInvalidValue;
  const int nc = (t + chunk - 1) / chunk;
  if (nc > 65535 || batch > 65535 || heads > 65535 || (long long)batch * nc > 65535)
    return (int)cudaErrorInvalidValue;
  SsdArgs args{static_cast<const __nv_bfloat16*>(x), sxb, sxt, sxh,
               static_cast<const float*>(dt), sdb, sdt, sdh,
               static_cast<const float*>(a),
               static_cast<const __nv_bfloat16*>(bm), sbb, sbt,
               static_cast<const __nv_bfloat16*>(cm), scb, sct,
               static_cast<float*>(cum), static_cast<float*>(states),
               static_cast<__nv_bfloat16*>(hin), static_cast<float*>(y), static_cast<float*>(final_state), t, heads, nc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk) {
    case 64:
      return launch_n<64>(args, batch, n, s);
    case 128:
      return launch_n<128>(args, batch, n, s);
    case 256:
      return launch_n<256>(args, batch, n, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
