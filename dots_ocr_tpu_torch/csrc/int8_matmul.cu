// W8A16 matmul for Hopper (sm_90a): bf16 activations against int8
// weight-only weights with a float32 scale per output column.
//
// No Pallas kernel to replace: the JAX package computes the same function
// as einsum(x, q.astype(bf16)) * s (dots_ocr_tpu/models/layers.py:62-67,
// linear; :101-108, unembed), and XLA fuses the convert into the dot's
// operand read. Written as eager torch, the int8 -> bf16 convert writes a
// bf16 copy of the whole weight on every call (37% of a graphed decode
// step's device time before this kernel). Same function, two layouts:
//   linear  (KN): x [M, K] bf16 . q [K, N] int8 (N contiguous), the float32
//                 sum times scale[n], plus the optional bias[n] (float32
//                 or bf16), rounded to bf16;
//   unembed (NK): x [M, K] bf16 . q [N, K]^T (K contiguous: the tied
//                 embedding [vocab, d]), the float32 sum times scale[n],
//                 returned as float32.
// int8 -> bf16 is exact, so the only difference from the plain version
// (ops/int8_matmul.py) is the order of the float32 sums. Scale, bias and
// the cast run in the epilogue, in that order.
//
// What bounds it on this card: the flagship decoder's block linears and
// tied lm_head hold 1.54 GB of int8 weights. A weight byte is used for
// 2 * M FLOPs, so up to M ~ 150 (every decode step of up to 64 slots) the
// read of the weights bounds it (1.54 GB a step: 0.46 ms at 3.35 TB/s);
// the larger shapes of a k = 2 verify (M = 192) and the prefill chunks
// (M = 2,048) are on the compute side.
//
// The int8 -> bf16 convert: the byte b ^ 0x80 = b + 128 is placed in the
// low bits of the float 2^23 (0x4B000000) and 2^23 + 128 subtracted, which
// gives b exactly; the float's top half is then b as bf16 (|b| <= 128 has
// at most 8 significant bits). An xor, four byte permutes, four float
// subtracts and two permutes convert four weights.
//
// Two regimes, picked by the wrapper from M alone (w8a16_plan in
// ops/int8_matmul.py):
// (a) M <= 192 (decode and verify steps), w8a16_split_kernel: mma.sync
//     m16n8k16 bf16 with float32 sums. A CTA computes a BM x 128 output
//     tile (BM = 16, 32 or 64 by M, so a decode step of a few rows does not
//     pay 64 rows of tensor work) over a contiguous range of the
//     contraction's units, through a cp.async ring of 16-byte copies (the
//     weight unit: [K, N] 64 rows of 128 bytes, 4 stages; [N, K] 128 rows
//     of 128 bytes, whole cache lines, 3 stages, which took the lm_head from
//     1.9 to 2.6 TB/s against 64-byte rows; x's slice of BM rows), by 4
//     warps of 32 output columns each, in passes of 64 contraction rows.
//     The weight bytes never pass through a bf16 tile in shared memory:
//     each thread builds its B fragments in registers. An mma's k order and
//     n order may be permuted as long as A and B agree and the output
//     columns are put back, so thread (g, c) takes k = 16c + 4s + 0..3 in
//     slice s of a pass (its two slices' a0/a2 then come from one 16-byte
//     load of x's row, conflict-free in the padded rows) and, in
//     n8-tile j, the column 4g + j of its warp's 32: for [K, N] it loads
//     four 4-byte words (the four k rows at columns 4g..4g+3) and one 4 x 4
//     byte transpose gives all four n8-tiles' fragments; for [N, K] each
//     column's four k bytes are one word. Each thread then holds 8
//     consecutive output columns of its two rows. So that wk / wv (N = 256:
//     2 column tiles) and down (12 tiles) still spread over the SMs, the
//     units are split over the C ranks of a thread block cluster (C <= 8,
//     from the plan; a shape with few column tiles also takes a smaller row
//     tile); each rank writes its float32 tile into its own shared memory,
//     and after a cluster barrier every rank adds an even share of the tile
//     over all ranks in rank order through distributed shared memory
//     (every rank's values loaded before the first add), applies the
//     epilogue and stores: one launch, no float32 partials in device
//     memory, and repeated calls agree bit for bit. A cluster of one rank
//     (the lm_head: 1,187 column tiles) stores from its registers.
// (b) M > 192 (prefill chunks), w8a16_wgmma_kernel: meant to be bound by
//     the tensor cores. A 128 x 128 output tile per CTA of two warpgroups;
//     per 128-wide block of the contraction, x's 128 x 128 bf16 slice
//     (128-byte swizzled) and the 16 KB weight tile arrive by cp.async
//     through a 3-stage ring, two blocks ahead; the threads convert the
//     weight tile into a swizzled K-major bf16 B tile (two, so the next
//     block's convert runs under this block's products), and each
//     warpgroup runs wgmma m64n64k16 (A and B
//     from shared memory) into one float32 accumulator. Converting into a
//     bf16 shared-memory tile rather than computing the transposed product
//     with the converted weight as the register operand A keeps one tile
//     layout for both weight layouts (the [N, K] unembed only skips the
//     transpose) and x in the operand that wgmma reads from shared memory
//     without a register copy. A shape with too few tiles for the card
//     (down and wq/wo at 2,048 rows: 192 tiles, one CTA an SM; wk/wv: 32)
//     splits the contraction over a cluster as regime (a) does. What holds
//     it on the card (PERF.md, kernel_ab.py's ablation): with its products
//     taken out it keeps 84-100% of its time at 2,048 rows, so the cp.async
//     loads of x and the weight tiles, not the tensor cores, bound it; a
//     4-stage ring of 64-wide blocks and 256-column tiles ran no faster,
//     and the third stage of 128-wide blocks (two blocks' loads in flight,
//     not one) took 5% off down and nothing off the others. cuBLAS's bf16
//     GEMM at these shapes takes 0.35-0.4x its time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first src_bytes come from src and the rest are zero.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// 4 x 4 byte transpose: w[i] holds row i's bytes of 4 columns; t[j] gets
// column j's bytes of the 4 rows (row i in byte i).
__device__ __forceinline__ void transpose4x4(const uint32_t (&w)[4], uint32_t (&t)[4]) {
  const uint32_t a = __byte_perm(w[0], w[1], 0x5140), b = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t c = __byte_perm(w[0], w[1], 0x7362), d = __byte_perm(w[2], w[3], 0x7362);
  t[0] = __byte_perm(a, b, 0x5410);
  t[1] = __byte_perm(a, b, 0x7632);
  t[2] = __byte_perm(c, d, 0x5410);
  t[3] = __byte_perm(c, d, 0x7632);
}

// Four signed bytes -> four bf16, exactly: byte i of w becomes element i
// (.x holds elements 0 and 1, .y 2 and 3, the lower element in the low half).
__device__ __forceinline__ uint2 s8x4_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;  // b + 128 in each byte
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632),
                    __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632));
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The bias of two consecutive output columns n, n + 1 as float32 (exact
// from bf16).
__device__ __forceinline__ float2 bias2(const void* bias, int bias_bf16, int n) {
  if (bias_bf16) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(static_cast<const uint16_t*>(bias) + n));
    return make_float2(bf_lo(w), bf_hi(w));
  }
  return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(bias) + n));
}

// The epilogue of four consecutive output columns n..n+3 of one row:
// sum * scale (+ bias), stored as bf16 or float32.
__device__ __forceinline__ void store4(float4 v, const float* __restrict__ scale,
                                       const void* __restrict__ bias, int bias_bf16, void* out,
                                       int out_f32, size_t row, int N, int n) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale + n));
  v.x = __fmul_rn(v.x, s.x);
  v.y = __fmul_rn(v.y, s.y);
  v.z = __fmul_rn(v.z, s.z);
  v.w = __fmul_rn(v.w, s.w);
  if (bias != nullptr) {
    const float2 b0 = bias2(bias, bias_bf16, n), b1 = bias2(bias, bias_bf16, n + 2);
    v.x = __fadd_rn(v.x, b0.x);
    v.y = __fadd_rn(v.y, b0.y);
    v.z = __fadd_rn(v.z, b1.x);
    v.w = __fadd_rn(v.w, b1.y);
  }
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + row * N + n) = v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + row * N + n) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// ---------------------------------------------------------------------------
// Regime (a): the cluster split at M <= 192.

constexpr int SP_THREADS = 128;  // 4 warps, 32 output columns each
constexpr int SP_BN = 128;       // output columns of a CTA
constexpr int SP_HALF = 64;      // contraction rows of one pass of the fragment mapping
constexpr int SP_RP = SP_BN + 4;         // floats of a row of the reduction tile (padded)
constexpr int SP_MAX_CLUSTER = 8;

// A unit, the contraction rows of a ring stage: 64 for [K, N] (4 stages),
// 128 for [N, K] (3 stages), so that a [N, K] row's bytes of a stage are a
// whole 128-byte line. x's rows (UNIT bf16) and [N, K] weight rows are
// padded by 16 bytes, which keeps the fragment loads conflict-free.
template <bool NK>
struct SplitLayout {
  static constexpr int UNIT = NK ? 128 : 64;
  static constexpr int STAGES = NK ? 3 : 4;
  static constexpr int XP = 2 * UNIT + 16;   // bytes of an x row in a stage
  static constexpr int NKP = UNIT + 16;      // bytes of a [N, K] weight row in a stage
  static constexpr int W = NK ? SP_BN * NKP : UNIT * SP_BN;  // a weight unit
};

template <bool NK, int MT>
struct SplitSmem {
  static constexpr int BM = 16 * MT;
  static constexpr int STAGE = SplitLayout<NK>::W + BM * SplitLayout<NK>::XP;
  static constexpr int RING = SplitLayout<NK>::STAGES * STAGE;
  static constexpr int RED = BM * SP_RP * 4;
  static constexpr int BYTES = RING > RED ? RING : RED;
};

// Byte offset of 16-byte chunk `ch` of row `row` of a [K, N] weight unit
// (128 bytes a row): the chunk is XOR-ed with 2 * (row / 16 % 4), so that
// the fragment loads of a warp (rows 64 half + 16c + r for c = 0..3, words
// 4g of its 32 columns) hit 32 distinct banks.
__device__ __forceinline__ uint32_t kn_off(int row, int ch) {
  return static_cast<uint32_t>(row * 128 + ((ch ^ (((row >> 4) & 3) << 1)) << 4));
}

// grid (C, row tiles, column tiles), cluster (C, 1, 1): rank r takes the
// units [r U / C, (r + 1) U / C) of the U = K / UNIT.
template <bool NK, int MT>
__global__ void __launch_bounds__(SP_THREADS)
w8a16_split_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, const void* __restrict__ bias,
                   void* __restrict__ out, int M, int K, int N, int out_f32, int bias_bf16) {
  using L = SplitSmem<NK, MT>;
  constexpr int BM = L::BM;
  using S = SplitLayout<NK>;
  constexpr int W = S::W, UNIT = S::UNIT, STAGES = S::STAGES, XP = S::XP, NKP = S::NKP;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.z * SP_BN;
  const int units = K / UNIT;
  const int u0 = rank * units / n_ranks, steps = (rank + 1) * units / n_ranks - u0;

  auto load = [&](int step, int stage) {
    const int k0 = (u0 + step) * UNIT;
    uint8_t* const st = smem + stage * L::STAGE;
    const uint32_t wb = smem_u32(st), xb = smem_u32(st + W);
#pragma unroll
    for (int it = 0; it < UNIT * SP_BN / 16 / SP_THREADS; ++it) {  // 16-byte chunks
      const int i = tid + it * SP_THREADS;
      if constexpr (NK) {
        const int row = i >> 3, ch = i & 7;  // row: output column n0 + row
        cp_async16(wb + row * NKP + ch * 16, q + (size_t)(n0 + row) * K + k0 + ch * 16, 16);
      } else {
        const int row = i >> 3, ch = i & 7;  // row: contraction row k0 + row
        cp_async16(wb + kn_off(row, ch), q + (size_t)(k0 + row) * N + n0 + ch * 16, 16);
      }
    }
#pragma unroll
    for (int i = tid; i < BM * (UNIT / 8); i += SP_THREADS) {
      const int row = i / (UNIT / 8), ch = i % (UNIT / 8);
      const bool ok = m0 + row < M;
      const uint16_t* src = ok ? x + (size_t)(m0 + row) * K + k0 + ch * 8 : x;
      cp_async16(xb + row * XP + ch * 16, src, ok ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  const int cb = warp * 32;  // the warp's columns in the tile
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // this stage landed; every warp is done with the stage refilled next
    if (step + STAGES - 1 < steps) load(step + STAGES - 1, (step + STAGES - 1) % STAGES);
    cp_async_commit();
#pragma unroll
    for (int half = 0; half < UNIT / SP_HALF; ++half) {
      const uint8_t* st = smem + (step % STAGES) * L::STAGE;
      const uint8_t* xs = st + W + 2 * SP_HALF * half;
      uint4 wv[4];  // [N, K]: column cb + 4g + j's bytes 16c .. 16c + 15 of the half
      if constexpr (NK) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = *reinterpret_cast<const uint4*>(st + (cb + 4 * g + j) * NKP + SP_HALF * half +
                                                  16 * c);
      }
#pragma unroll
      for (int sp = 0; sp < 2; ++sp) {
        // B fragments of the four n8-tiles in slices 2 sp and 2 sp + 1:
        // t[j] = column cb + 4g + j's bytes at k = 16c + 4s + 0..3.
        uint2 b[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = 2 * sp + h;
          uint32_t t[4];
          if constexpr (NK) {
#pragma unroll
            for (int j = 0; j < 4; ++j) t[j] = word(wv[j], s);
          } else {
            uint32_t w[4];
            const int ch = (cb + 4 * g) >> 4;
#pragma unroll
            for (int p = 0; p < 4; ++p)
              w[p] = *reinterpret_cast<const uint32_t*>(
                  st + kn_off(SP_HALF * half + 16 * c + 4 * s + p, ch) + 4 * (g & 3));
            transpose4x4(w, t);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) b[h][j] = s8x4_bf16(t[j]);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // x's rows g and g + 8 at k = 16c + 8 sp .. + 7: both slices' A.
          const uint4 lo = *reinterpret_cast<const uint4*>(xs + (16 * mt + g) * XP + 32 * c + 16 * sp);
          const uint4 hi =
              *reinterpret_cast<const uint4*>(xs + (16 * mt + g + 8) * XP + 32 * c + 16 * sp);
          const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y}, a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(acc[mt][j], a0, b[0][j].x, b[0][j].y);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma(acc[mt][j], a1, b[1][j].x, b[1][j].y);
        }
      }
    }
  }

  if (n_ranks == 1) {  // the epilogue straight from the registers
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * mt + g + 8 * h;
        if (row >= M) continue;
        const int col = n0 + cb + 8 * c;
        store4(make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h], acc[mt][2][2 * h],
                           acc[mt][3][2 * h]),
               scale, bias, bias_bf16, out, out_f32, (size_t)row, N, col);
        store4(make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1], acc[mt][2][2 * h + 1],
                           acc[mt][3][2 * h + 1]),
               scale, bias, bias_bf16, out, out_f32, (size_t)row, N, col + 4);
      }
    return;
  }
  // The rank's float32 tile into its shared memory (the ring is free now).
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* r = red + (16 * mt + g + 8 * h) * SP_RP + cb + 8 * c;
      *reinterpret_cast<float4*>(r) = make_float4(acc[mt][0][2 * h], acc[mt][1][2 * h],
                                                  acc[mt][2][2 * h], acc[mt][3][2 * h]);
      *reinterpret_cast<float4*>(r + 4) = make_float4(acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                                                      acc[mt][2][2 * h + 1],
                                                      acc[mt][3][2 * h + 1]);
    }
  cluster.sync();
  // This rank's share of the tile's 4-column groups, summed over the ranks
  // in rank order; every rank's tile is read before the first add, so the
  // distributed shared memory loads overlap.
  constexpr int GROUPS = BM * SP_BN / 4;
  const int lo = rank * GROUPS / n_ranks, hi = (rank + 1) * GROUPS / n_ranks;
  for (int gi = lo + tid; gi < hi; gi += SP_THREADS) {
    const int row = gi / (SP_BN / 4), col = (gi % (SP_BN / 4)) * 4;
    if (m0 + row >= M) continue;
    const int off = row * SP_RP + col;
    float4 p[SP_MAX_CLUSTER];
#pragma unroll
    for (int r = 0; r < SP_MAX_CLUSTER; ++r)
      if (r < n_ranks)
        p[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + off);
    float4 v = p[0];
#pragma unroll
    for (int i = 1; i < SP_MAX_CLUSTER; ++i)
      if (i < n_ranks) {
        v.x = __fadd_rn(v.x, p[i].x);
        v.y = __fadd_rn(v.y, p[i].y);
        v.z = __fadd_rn(v.z, p[i].z);
        v.w = __fadd_rn(v.w, p[i].w);
      }
    store4(v, scale, bias, bias_bf16, out, out_f32, (size_t)(m0 + row), N, n0 + col);
  }
  cluster.sync();  // no rank leaves while another still reads its tile
}

// ---------------------------------------------------------------------------
// Regime (b): wgmma at M > 192.

constexpr int WG_THREADS = 256;          // two warpgroups, 64 rows each
constexpr int WG_BM = 128, WG_BN = 128;  // output tile of a CTA
constexpr int WG_KB = 128;               // contraction rows of a block
constexpr int WG_X = WG_BM * WG_KB * 2;  // x's slice: 128 rows x 128 bf16, swizzled
constexpr int WG_W = WG_KB * WG_BN;      // the weight tile: 128 x 128 bytes
constexpr int WG_STAGE = WG_X + WG_W;
constexpr int WG_STAGES = 3;             // ring stages: two blocks' loads in flight
constexpr int WG_B = WG_BN * WG_KB * 2;  // a converted B tile: 128 n x 128 k bf16
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 2 * WG_B + 1024;  // + the swizzle atom's alignment
constexpr int WG_RP = WG_BN + 4;  // floats of a row of the cluster reduction's tile (padded)
constexpr int WG_MAX_CLUSTER = 8;

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy wgmma reads through.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// wgmma m64n64k16, bf16 x bf16 -> f32, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Byte offset of 16-byte chunk `ch` of row `row` in a 128-row swizzled
// tile: 64-column (128-byte) blocks of 128 x 128 bytes, chunk ^= row % 8.
__device__ __forceinline__ uint32_t swz128(int row, int ch) {
  return static_cast<uint32_t>((ch >> 3) * (128 * 128) + row * 128 +
                               (((ch & 7) ^ (row & 7)) << 4));
}

// Byte offset of 16-byte chunk `ch` of row `row` of a weight tile (128
// bytes a row): chunks XOR-swizzled by the row's quad, so the convert's
// threads read distinct banks.
__device__ __forceinline__ uint32_t w_off(int row, int ch) {
  return static_cast<uint32_t>(row * 128 + ((ch ^ ((row >> 2) & 7)) << 4));
}

// Shared memory (1,024-byte aligned): WG_STAGES ring stages (x's swizzled
// slice, then the weight tile), then two converted B tiles. Block kb's
// wgmma reads stage kb % WG_STAGES and B tile kb % 2 while the threads
// convert block kb + 1 into the other, and blocks kb + 1 and kb + 2 load.
// grid (C x column tiles, row tiles), cluster (C, 1, 1): rank r takes the
// contraction's blocks [r nkb / C, (r + 1) nkb / C); with C > 1 the ranks'
// float32 tiles are added in rank order through distributed shared memory,
// as in the split regime.
template <bool NK>
__global__ void __launch_bounds__(WG_THREADS, 1)
w8a16_wgmma_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, const void* __restrict__ bias,
                   void* __restrict__ out, int M, int K, int N, int out_f32, int bias_bf16) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t b_tiles = base + WG_STAGES * WG_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;  // warpgroup, warp in it
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.x / n_ranks * WG_BN, m0 = blockIdx.y * WG_BM;
  const int kb0 = rank * (K / WG_KB) / n_ranks;
  const int nkb = (rank + 1) * (K / WG_KB) / n_ranks - kb0;  // this rank's blocks

  auto load = [&](int kb_local, int stage) {
    const int kb = kb0 + kb_local;
    const uint32_t st = base + stage * WG_STAGE;
#pragma unroll
    for (int it = 0; it < WG_BM * 16 / WG_THREADS; ++it) {
      const int i = tid + it * WG_THREADS, row = i >> 4, ch = i & 15;
      const bool ok = m0 + row < M;
      const uint16_t* src = ok ? x + (size_t)(m0 + row) * K + kb * WG_KB + ch * 8 : x;
      cp_async16(st + swz128(row, ch), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < WG_W / 16 / WG_THREADS; ++it) {
      const int i = tid + it * WG_THREADS, row = i >> 3, ch = i & 7;
      const int8_t* src = NK ? q + (size_t)(n0 + row) * K + kb * WG_KB + ch * 16
                             : q + (size_t)(kb * WG_KB + row) * N + n0 + ch * 16;
      cp_async16(st + WG_X + w_off(row, ch), src, 16);
    }
  };

  // The convert of block kb's weight tile into B tile kb % 2 ([n][k], K-major).
  auto convert = [&](int kb) {
    const unsigned char* wt = sm + (kb % WG_STAGES) * WG_STAGE + WG_X;
    unsigned char* bt = sm + WG_STAGES * WG_STAGE + (kb & 1) * WG_B;
    if constexpr (NK) {
      // Thread takes 16-byte chunks (n, 16 k bytes): two chunks of bf16.
#pragma unroll
      for (int it = 0; it < WG_W / 16 / WG_THREADS; ++it) {
        const int i = tid + it * WG_THREADS, n = i >> 3, ch = i & 7;
        const uint4 v = *reinterpret_cast<const uint4*>(wt + w_off(n, ch));
        const uint2 e0 = s8x4_bf16(v.x), e1 = s8x4_bf16(v.y);
        const uint2 e2 = s8x4_bf16(v.z), e3 = s8x4_bf16(v.w);
        *reinterpret_cast<uint4*>(bt + swz128(n, 2 * ch)) = make_uint4(e0.x, e0.y, e1.x, e1.y);
        *reinterpret_cast<uint4*>(bt + swz128(n, 2 * ch + 1)) = make_uint4(e2.x, e2.y, e3.x, e3.y);
      }
    } else {
      // Thread (kq, c16) takes k rows 4 kq .. 4 kq + 3 and columns
      // 16 c16 .. 16 c16 + 15, transposed 4 x 4 bytes at a time.
      const int kq = (lane & 15) + 16 * (warp & 1), c16 = (lane >> 4) + 2 * (warp >> 1);
      uint4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = *reinterpret_cast<const uint4*>(wt + w_off(4 * kq + i, c16));
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        const uint32_t wq[4] = {word(w[0], j4), word(w[1], j4), word(w[2], j4), word(w[3], j4)};
        uint32_t t[4];
        transpose4x4(wq, t);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint2*>(bt + swz128(16 * c16 + 4 * j4 + j, kq >> 1) + (kq & 1) * 8) =
              s8x4_bf16(t[j]);
      }
    }
    fence_async_proxy();
  };

  // acc[h][4 j + e]: row 64 wg + 16 wr + g (+ 8 for e >= 2), column
  // 64 h + 8 j + 2c + (e & 1) of the CTA's tile.
  float acc[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  // One commit group a block (empty past the last), so that waiting for
  // block kb + 1 leaves exactly block kb + 2's group in flight.
#pragma unroll
  for (int s = 0; s < WG_STAGES; ++s) {
    if (s < nkb) load(s, s);
    cp_async_commit();
  }
  cp_async_wait<WG_STAGES - 1>();
  fence_async_proxy();
  __syncthreads();
  convert(0);
  __syncthreads();
  for (int kb = 0; kb < nkb; ++kb) {
    const uint32_t xs = base + (kb % WG_STAGES) * WG_STAGE + wg * 64 * 128;
    const uint32_t bt = b_tiles + (kb & 1) * WG_B;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WG_KB / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (128 * 128) + (kk & 3) * 32;
      const uint64_t da = make_desc(xs + off, 16, 1024);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_m64n64k16_ss(acc[h], da, make_desc(bt + h * 64 * 128 + off, 16, 1024), 1);
    }
    wgmma_commit();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[h][i]);
    if (kb + 1 < nkb) {
      cp_async_wait<WG_STAGES - 2>();  // block kb + 1's stage; kb + 2's may still load
      fence_async_proxy();
      __syncthreads();
      convert(kb + 1);  // B tile (kb + 1) % 2: block kb - 1's wgmma has completed
    }
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(acc[h][i]);
    // Block kb + 1's B tile is complete, and every warpgroup is done with
    // block kb's stage, which takes block kb + WG_STAGES.
    __syncthreads();
    if (kb + WG_STAGES < nkb) load(kb + WG_STAGES, kb % WG_STAGES);
    cp_async_commit();
  }

  const int g = lane >> 2;
  if (n_ranks > 1) {
    // The rank's float32 tile into its shared memory (the ring is free now),
    // then its share of the tile's 4-column groups summed over the ranks.
    cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(sm);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2)
          *reinterpret_cast<float2*>(red + (64 * wg + 16 * wr + g + 8 * e2) * WG_RP + 64 * h +
                                     8 * j + 2 * c) =
              make_float2(acc[h][4 * j + 2 * e2], acc[h][4 * j + 2 * e2 + 1]);
    cluster.sync();
    constexpr int GROUPS = WG_BM * WG_BN / 4;
    const int lo = rank * GROUPS / n_ranks, hi = (rank + 1) * GROUPS / n_ranks;
    for (int gi = lo + tid; gi < hi; gi += WG_THREADS) {
      const int row = gi / (WG_BN / 4), col = (gi % (WG_BN / 4)) * 4;
      if (m0 + row >= M) continue;
      const int off = row * WG_RP + col;
      float4 p[WG_MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < WG_MAX_CLUSTER; ++r)
        if (r < n_ranks)
          p[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, r) + off);
      float4 v = p[0];
#pragma unroll
      for (int r = 1; r < WG_MAX_CLUSTER; ++r)
        if (r < n_ranks) {
          v.x = __fadd_rn(v.x, p[r].x);
          v.y = __fadd_rn(v.y, p[r].y);
          v.z = __fadd_rn(v.z, p[r].z);
          v.w = __fadd_rn(v.w, p[r].w);
        }
      store4(v, scale, bias, bias_bf16, out, out_f32, (size_t)(m0 + row), N, n0 + col);
    }
    cluster.sync();  // no rank leaves while another still reads its tile
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = m0 + 64 * wg + 16 * wr + g + 8 * e2;
        if (row >= M) continue;
        const int col = n0 + 64 * h + 8 * j + 2 * c;
        const float2 s = __ldg(reinterpret_cast<const float2*>(scale + col));
        float v0 = __fmul_rn(acc[h][4 * j + 2 * e2], s.x);
        float v1 = __fmul_rn(acc[h][4 * j + 2 * e2 + 1], s.y);
        if (bias != nullptr) {
          const float2 b = bias2(bias, bias_bf16, col);
          v0 = __fadd_rn(v0, b.x);
          v1 = __fadd_rn(v1, b.y);
        }
        if (out_f32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + (size_t)row * N + col) =
              make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<uint16_t*>(out) + (size_t)row * N +
                                             col) = __floats2bfloat162_rn(v0, v1);
        }
      }
}

// cudaFuncSetAttribute for `bytes` of dynamic shared memory, once per
// device for kernel `which` (it costs host time on every launch otherwise).
template <typename F>
cudaError_t allow_smem(F kernel, int bytes, int which) {
  constexpr int MAX_DEVICES = 64;
  static bool done[8][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[which][dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[which][dev] = true;
  return err;
}

template <bool NK, int MT>
cudaError_t launch_split(const uint16_t* x, const int8_t* q, const float* scale, const void* bias,
                         void* out, int M, int K, int N, int out_f32, int bias_bf16, int cluster,
                         cudaStream_t stream, int which) {
  using L = SplitSmem<NK, MT>;
  if (cluster < 1 || cluster > SP_MAX_CLUSTER || cluster > K / SplitLayout<NK>::UNIT)
    return cudaErrorInvalidValue;
  const cudaError_t set = allow_smem(w8a16_split_kernel<NK, MT>, L::BYTES, which);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (M + L::BM - 1) / L::BM, N / SP_BN);
  cfg.blockDim = dim3(SP_THREADS);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w8a16_split_kernel<NK, MT>, x, q, scale, bias, out, M, K, N,
                            out_f32, bias_bf16);
}

template <bool NK>
cudaError_t launch_wgmma(const uint16_t* x, const int8_t* q, const float* scale, const void* bias,
                         void* out, int M, int K, int N, int out_f32, int bias_bf16, int cluster,
                         cudaStream_t stream, int which) {
  if (cluster < 1 || cluster > WG_MAX_CLUSTER || cluster > K / WG_KB) return cudaErrorInvalidValue;
  const cudaError_t set = allow_smem(w8a16_wgmma_kernel<NK>, WG_SMEM, which);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * (N / WG_BN), (M + WG_BM - 1) / WG_BM);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = WG_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w8a16_wgmma_kernel<NK>, x, q, scale, bias, out, M, K, N,
                            out_f32, bias_bf16);
}

template <bool NK>
cudaError_t dispatch(const uint16_t* x, const int8_t* q, const float* scale, const void* bias,
                     void* out, int M, int K, int N, int out_f32, int bias_bf16, int rows_tile,
                     int cluster, cudaStream_t st) {
  constexpr int W = NK ? 4 : 0;  // allow_smem's slots: 0-3 [K, N], 4-7 [N, K]
  switch (rows_tile) {
    case 0:
      return launch_wgmma<NK>(x, q, scale, bias, out, M, K, N, out_f32, bias_bf16, cluster, st,
                              W);
    case 16:
      return launch_split<NK, 1>(x, q, scale, bias, out, M, K, N, out_f32, bias_bf16, cluster,
                                 st, W + 1);
    case 32:
      return launch_split<NK, 2>(x, q, scale, bias, out, M, K, N, out_f32, bias_bf16, cluster,
                                 st, W + 2);
    case 64:
      return launch_split<NK, 4>(x, q, scale, bias, out, M, K, N, out_f32, bias_bf16, cluster,
                                 st, W + 3);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// x [M, K] bf16; q int8 [K, N] (nk 0) or [N, K] (nk 1); scale [N] float32;
// bias [N] float32 (bias_bf16 0) or bf16 (1), or null; out [M, N] bf16
// (out_f32 0) or float32. rows_tile 16, 32 or 64: regime (a) at that tile
// height; rows_tile 0: regime (b); either with clusters of `cluster` CTAs
// over the contraction. Needs K a multiple of 128 and N of 128.
extern "C" int dots_w8a16_matmul(const void* x, const void* q, const void* scale,
                                 const void* bias, void* out, int M, int K, int N, int nk,
                                 int out_f32, int bias_bf16, int rows_tile, int cluster,
                                 void* stream) {
  if (M < 1 || K < WG_KB || K % WG_KB != 0 || N < SP_BN || N % SP_BN != 0 ||
      (rows_tile == 0 && (M + WG_BM - 1) / WG_BM > 65535) ||
      (rows_tile != 0 && ((M + rows_tile - 1) / rows_tile > 65535 || N / SP_BN > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* qp = static_cast<const int8_t*>(q);
  const auto* sp = static_cast<const float*>(scale);
  const cudaError_t err =
      nk ? dispatch<true>(xp, qp, sp, bias, out, M, K, N, out_f32, bias_bf16, rows_tile, cluster,
                          st)
         : dispatch<false>(xp, qp, sp, bias, out, M, K, N, out_f32, bias_bf16, rows_tile,
                           cluster, st);
  return static_cast<int>(err);
}
