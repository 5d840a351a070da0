// Grouped int4 weight-only matmul for Hopper (sm_90a): W4A16 (bf16
// activations) and W4A8 (activations quantized per row to int8).
//
// Replaces the Pallas kernel dots_ocr_tpu/ops/int4_matmul.py:
// int4_matmul -> _int4_kernel (line 109; the pl.pallas_call at line 232),
// reached through int4_linear (line 252). Same function:
//   y[M, N] = sum_g (x[:, g] . q[g, :]) * s[g, :]
// over 128-row input groups g, with the weights nibble-packed along the
// contraction axis as pack_int4 packs them: packed[i, n] holds q[i, n] + 8
// in its low nibble and q[i + K/2, n] in its high nibble; scales s
// [K/128, N] float32; the output is bf16. W4A8 first quantizes each row of x
// to int8 (a_scale = amax / 127, or 1 for an all-zero row; xq = round(x /
// a_scale), no clip) and multiplies the float32 sum by a_scale last.
//
// The TPU's workarounds are not carried over. The +8 bias with its rank-1
// 8 * s * rowsum(x) correction, and the high nibble read as 16 * q_hi
// against s / 16, exist because Mosaic has no shifts on i8 vectors; here
// the nibbles are unpacked to signed values directly with byte-wise SIMD
// ops, so each group product is the signed one.
//
// What bounds it on this card: the decoder's block linears hold 1.31 G
// int4 weights, 0.655 GB of packed bytes plus 41 MB of f32 scales. A packed
// byte carries two weights, each used for 2 * M FLOPs: 4 * M FLOPs per
// byte streamed. At M = 64 (a 64-slot decode step) that is 256 FLOP/byte,
// under the H100's bf16 ridge of ~295: the kernel streams the 0.655 GB of
// packed weights per step and is bound by that read. At M >= 192 (a k = 2
// verify step, a prefill chunk of up to 4,096 rows) it is on the compute
// side, where the tensor cores set the ceiling and the unpack is overhead.
//
// W4A8, exact by contract: group g's term is fl(float(I_g) * s_g), I_g the
// exact int32 sum of its int8 x int4 products; the terms are added into a
// float32 accumulator one after another in the Pallas order (every low
// group, then every high group), multiplied by a_scale, rounded to bf16, so
// kernel and plain version agree bit for bit. The integer sums may come
// from any block in any order: only the chain of float32 adds is ordered.
// A pre-pass (quantize_rows_kernel, a block a row) quantizes the rows into
// the wrapper's one scratch buffer. Two regimes, picked by the wrapper from
// the row count alone (int4_w4a8_plan in ops/int4_matmul.py):
// (a) M <= 192 (decode and verify steps), int4_w4a8_cluster_kernel: the
//     read of the packed weights bounds it (at M = 64 a down call moves
//     ~8.7 MB: 2.6 us at 3.35 TB/s). A thread block cluster of C CTAs
//     (C <= 8) shares a 64-row x BN-column output tile (BN 32 or 64, from the
//     plan); rank r takes the contiguous packed-row blocks [r nkb / C,
//     (r + 1) nkb / C). Each CTA reads each of its packed tiles once,
//     through a cp.async ring (at least three stages, every step of the
//     rank where they fit) with the block's low and high x slices and the
//     two groups' scales, unpacks both nibbles of that one copy into two
//     128-byte-swizzled K-major s8 B tiles, and runs one group on each
//     warpgroup (wgmma m64nBNk32 s8); it scales each group's sums once and
//     keeps the terms in its own shared memory. After a cluster barrier the
//     cluster's threads, an even share of the tile's outputs a rank, run the
//     float32 chain over every rank's terms in the Pallas order, read through
//     distributed shared memory (mapa + ld.shared::cluster, up to 16 bytes a
//     load) a batch ahead of the adds.
// (b) M > 192 (prefill chunks), int4_w4a8_wgmma_kernel: the tensor cores
//     bound it. A 128 x WBN tile per CTA (WBN 128, or 64 where 128-column
//     tiles leave SMs idle): a producer warpgroup keeps a four-stage ring of
//     (xq slice, packed tile, the group's scales) in flight with cp.async
//     and full/empty mbarriers; two consumer warpgroups unpack each group's
//     nibbles to a K-major 128-byte-swizzled s8 B tile (double-buffered, so
//     the next group's unpack runs under this group's wgmma), run wgmma
//     m64nWBNk32 s8 into a per-group s32 accumulator and add fl(I * s) into
//     the float32 one. The walk is the Pallas order: every low group, then
//     every high group, whose packed tiles are read again (from L2). Column
//     tiles vary fastest in the grid, so a wave of CTAs shares x's rows.
//
// W4A16, two regimes picked by the wrapper from M alone (int4_regime in
// ops/int4_matmul.py):
// (a) M <= 192 (decode and verify steps), int4_splitk_kernel: the read of
//     the packed weights bounds it, and a 64 x 128 output tile per block
//     gives the down projection 12 blocks for 132 SMs, so the contraction is
//     split. A unit is 64 packed rows (half of low group kb and half of high
//     group kb); split s of a block column takes units [s u, (s + 1) u),
//     u from int4_split_plan (static shapes: ~2 blocks an SM). 256 threads
//     (2 x 4 warps of 32 x 32), a three-stage cp.async ring of 16-byte
//     copies (the packed unit, 8 KB, in chunks XOR-swizzled by row quad so
//     the unpack's reads hit distinct banks; x's low and high 64-column
//     slices; the two groups' scales for the block's columns), each group
//     unpacked in turn (4 x 4 byte transposes, nibbles to bf16 exactly) into
//     one k-contiguous bf16 B tile, ldmatrix operands, mma.sync bf16
//     m16n8k16 with float32 sums, each group's partial scaled into the
//     float32 accumulator by s[g, n]. Splits write float32 partials;
//     int4_reduce_kernel adds them in split order (no atomics: repeated
//     calls agree bit for bit) and rounds to bf16. One split writes bf16
//     directly. 99 KB of shared memory: two blocks an SM. What limits it
//     (PERF.md): x's slices, re-read from L2 by every column tile, move
//     twice the packed bytes at M = 64, and the second launch.
// (b) M > 192 (prefill chunks), int4_wgmma_kernel: the tensor cores bound
//     it. A 128 x 128 output tile per block of two warpgroups; per packed
//     block of 128 rows, the packed tile (16 KB) and x's two 128 x 128 bf16
//     slices (low and high group) arrive by cp.async a block ahead in
//     128-byte-swizzled shared memory; each group's nibbles are unpacked to
//     a swizzled K-major bf16 B tile (two, so the next group's unpack runs
//     under this group's products), and each warpgroup runs wgmma m64n64k16
//     (A and B from shared memory) into a per-group float32 accumulator that
//     is scaled into the main one by s[g, n] in float32 (not folded into
//     bf16 weights: q s rounded to bf16 would move outputs near zero past
//     the plain version's tolerance). 225 KB: one block an SM; the two
//     accumulators take 128 registers a thread, which keeps the tile at
//     128 x 128, so x is re-read by every column tile.
// Both W4A16 kernels add the groups in another order than the Pallas body
// (low and high group of each packed block in turn, splits last); the
// products are exact in float32, so only the order of float32 sums differs.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KB = 128;  // packed rows per step: one low and one high group

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// float(i) exactly for |i| < 2^22 with an integer and a float add (full
// rate), not a conversion (16 a clock an SM): 1.5 * 2^23 + i has ulp 1.
__device__ __forceinline__ float exact_float(int i) {
  return __fsub_rn(__int_as_float(0x4B400000 + i), 12582912.f);
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

// q + 8 in each byte, from the low nibbles (stored biased) or the high
// nibbles (two's complement: h ^ 8 == q + 8).
__device__ __forceinline__ uint32_t biased_nibbles(uint32_t t, bool high) {
  return high ? (((t >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u) : (t & 0x0F0F0F0Fu);
}

// Four signed bytes q from the low nibbles (stored biased: (q + 8) ^ 8 is
// q's two's complement nibble) or the high nibbles (two's complement), each
// nibble sign-extended by a multiply that cannot carry between bytes
// (8 * 30 = 0xF0).
__device__ __forceinline__ uint32_t s8_nibbles(uint32_t t, bool high) {
  const uint32_t q = high ? ((t >> 4) & 0x0F0F0F0Fu) : ((t & 0x0F0F0F0Fu) ^ 0x08080808u);
  return q | ((q & 0x08080808u) * 30u);
}

// Four biased nibbles u -> four bf16 q = u - 8, exactly: 0x43uu is the
// bf16 value 128 + u, and 128 + u - 136 is exact.
__device__ __forceinline__ uint2 nibbles_bf16(uint32_t u) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t p0 = __byte_perm(u, 0x43434343u, 0x5140), p1 = __byte_perm(u, 0x43434343u, 0x7362);
  __nv_bfloat162 v0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p0), bias);
  __nv_bfloat162 v1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p1), bias);
  return make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
}

// W4A8's pre-pass: one block per row of x [M, K] bf16 -> xq [M, K] int8 and
// a_scale [M] f32, with true division and round-half-to-even (as the plain
// version's torch.round and the Pallas body's jnp.round). A row's 16-byte
// chunks are spread over the block and loaded four at a time, so the row
// takes a few load latencies, not one per chunk; the second pass reads
// them again from the cache.
constexpr int QR_THREADS = 256;

__global__ void __launch_bounds__(QR_THREADS)
quantize_rows_kernel(const uint16_t* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ a_scale, int K) {
  __shared__ float warp_amax[QR_THREADS / 32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const uint16_t* xr = x + (size_t)blockIdx.x * K;
  float amax = 0.f;
#pragma unroll 4
  for (int k = threadIdx.x * 8; k < K; k += QR_THREADS * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fmaxf(fabsf(bf_lo(w[e])), fabsf(bf_hi(w[e]))));
  }
  amax = warp_max(amax);
  if (lane == 0) warp_amax[warp] = amax;
  __syncthreads();
  amax = warp_amax[0];
#pragma unroll
  for (int i = 1; i < QR_THREADS / 32; ++i) amax = fmaxf(amax, warp_amax[i]);
  const float s = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
#pragma unroll 4
  for (int k = threadIdx.x * 8; k < K; k += QR_THREADS * 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(xr + k);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = (uint32_t)__float2int_rn(__fdiv_rn(bf_lo(w[e]), s)) & 0xffu;
      const uint32_t hi = (uint32_t)__float2int_rn(__fdiv_rn(bf_hi(w[e]), s)) & 0xffu;
      q[e >> 1] |= (lo | (hi << 8)) << (16 * (e & 1));
    }
    *reinterpret_cast<uint2*>(xq + (size_t)blockIdx.x * K + k) = make_uint2(q[0], q[1]);
  }
  if (threadIdx.x == 0) a_scale[blockIdx.x] = s;
}

// ---------------------------------------------------------------------------
// W4A16, regime (a): split-K at small M.

constexpr int SK_THREADS = 256;            // 2 x 4 warps of 32 x 32
constexpr int SK_BM = 64, SK_BN = 128;     // output tile of a block
constexpr int SK_UNIT = 64;                // packed rows of a unit
constexpr int SK_PITCH = SK_UNIT * 2 + 16;  // bytes of an x or B row (64 bf16, padded)
constexpr int SK_X = SK_BM * SK_PITCH;      // one x slice
constexpr int SK_P = SK_UNIT * SK_BN;       // one packed unit
constexpr int SK_S = 2 * SK_BN * 4;         // the low and high groups' scales
constexpr int SK_STAGE = SK_P + 2 * SK_X + SK_S;
constexpr int SK_B = SK_BN * SK_PITCH;      // the unpacked B tile, k contiguous
constexpr int SK_STAGES = 3;
constexpr int SK_SMEM = SK_STAGES * SK_STAGE + SK_B;

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

// cp.async.wait_group with a count known at run time (up to 7).
__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Byte offset of 16-byte chunk `ch` of row `row` of a packed tile (128
// bytes a row): chunks XOR-swizzled by the row's quad, so the unpack's
// threads, one row quad each, read distinct banks.
__device__ __forceinline__ uint32_t packed_off(int row, int ch) {
  return static_cast<uint32_t>(row * 128 + ((ch ^ ((row >> 2) & 7)) << 4));
}

// Shared memory: SK_STAGES ring stages (the packed unit, x's low and high
// slices, the two groups' scales for the block's columns), then one
// unpacked B tile (a group at a time).
__global__ void __launch_bounds__(SK_THREADS, 2)
int4_splitk_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ packed,
                   const float* __restrict__ scales, float* __restrict__ part,
                   uint16_t* __restrict__ out, int M, int K, int N, int units_per_split,
                   int n_split) {
  constexpr int P = SK_PITCH;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const Bs = smem + SK_STAGES * SK_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, row within it
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * SK_BN, m0 = blockIdx.y * SK_BM, split = blockIdx.z;
  const int half = K / 2, groups_half = half / KB;
  const int u0 = split * units_per_split;
  const int steps = min(units_per_split, half / SK_UNIT - u0);

  auto load = [&](int step, int stage) {
    const int r0 = (u0 + step) * SK_UNIT, kb = r0 / KB;
    const uint32_t base = smem_u32(smem + stage * SK_STAGE);
#pragma unroll
    for (int it = 0; it < SK_P / 16 / SK_THREADS; ++it) {
      const int i = tid + it * SK_THREADS, row = i >> 3, ch = i & 7;
      cp_async16(base + packed_off(row, ch), packed + (size_t)(r0 + row) * N + n0 + ch * 16, 16);
    }
#pragma unroll
    for (int it = 0; it < 2 * SK_BM * 8 / SK_THREADS; ++it) {
      const int i = tid + it * SK_THREADS;
      const int hi = i / (SK_BM * 8), row = (i >> 3) % SK_BM, ch = i & 7;
      const bool ok = m0 + row < M;
      const uint16_t* src = ok ? x + (size_t)(m0 + row) * K + hi * half + r0 + ch * 8 : x;
      cp_async16(base + SK_P + hi * SK_X + row * P + ch * 16, src, ok ? 16 : 0);
    }
    if (tid < SK_S / 16) {  // 32 copies a group's 128 scales
      const int hi = tid >> 5, ch = tid & 31;
      cp_async16(base + SK_P + 2 * SK_X + tid * 16,
                 scales + (size_t)(hi * groups_half + kb) * N + n0 + ch * 4, 16);
    }
  };

  // The unpack: thread (kq, c8) takes packed rows 4 kq .. 4 kq + 3 of the
  // unit and columns 8 c8 .. 8 c8 + 7.
  const int kq = lane & 15, c8 = (lane >> 4) + 2 * warp;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < SK_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();  // this stage landed; every thread is done with the last unit
    if (step + SK_STAGES - 1 < steps)
      load(step + SK_STAGES - 1, (step + SK_STAGES - 1) % SK_STAGES);
    cp_async_commit();
    const uint8_t* st = smem + (step % SK_STAGES) * SK_STAGE;
    const float* sc = reinterpret_cast<const float*>(st + SK_P + 2 * SK_X);
#pragma unroll
    for (int nib = 0; nib < 2; ++nib) {
      // This group's nibbles as bf16, B[n][k] (k = the unit's packed row).
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const uint2*>(st + packed_off(4 * kq + i, c8 >> 1) +
                                               (c8 & 1) * 8);
      if (nib == 1) __syncthreads();  // every warp is done reading the low group's B
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint32_t wq[4] = {q ? w[0].y : w[0].x, q ? w[1].y : w[1].x, q ? w[2].y : w[2].x,
                                q ? w[3].y : w[3].x};
        uint32_t t[4];
        transpose4x4(wq, t);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint2*>(Bs + (8 * c8 + 4 * q + j) * P + 8 * kq) =
              nibbles_bf16(biased_nibbles(t[j], nib != 0));
      }
      __syncthreads();
      float pt[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) pt[mt][nt][i] = 0.f;
      const uint32_t xa = smem_u32(st + SK_P + nib * SK_X);
      const uint32_t wb = smem_u32(Bs);
#pragma unroll
      for (int kk = 0; kk < SK_UNIT / 16; ++kk) {
        uint32_t a[2][4], b[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          ldsm_x4(a[mt], xa + (wm * 32 + mt * 16 + ((mat & 1) << 3) + mrow) * P +
                             (2 * kk + (mat >> 1)) * 16);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          ldsm_x4(b[np], wb + (wn * 32 + np * 16 + ((mat >> 1) << 3) + mrow) * P +
                             (2 * kk + (mat & 1)) * 16);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            mma(pt[mt][nt], a[mt], b[nt >> 1][2 * (nt & 1)], b[nt >> 1][2 * (nt & 1) + 1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float2 sv = *reinterpret_cast<const float2*>(sc + nib * SK_BN + wn * 32 + nt * 8 +
                                                           2 * c);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[mt][nt][i] = fmaf(pt[mt][nt][i], (i & 1) ? sv.y : sv.x, acc[mt][nt][i]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        const int col = n0 + wn * 32 + nt * 8 + 2 * c;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (n_split == 1) {
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(part + ((size_t)split * M + row) * N + col) =
              make_float2(v0, v1);
        }
      }
}

// The splits' partials [n_split, M * N] added in split order, to bf16.
__global__ void int4_reduce_kernel(const float* __restrict__ part, uint16_t* __restrict__ out,
                                   int mn, int n_split) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= mn) return;
  float4 s = *reinterpret_cast<const float4*>(part + i);
  for (int k = 1; k < n_split; ++k) {
    const float4 v = *reinterpret_cast<const float4*>(part + (size_t)k * mn + i);
    s.x = __fadd_rn(s.x, v.x);
    s.y = __fadd_rn(s.y, v.y);
    s.z = __fadd_rn(s.z, v.z);
    s.w = __fadd_rn(s.w, v.w);
  }
  const __nv_bfloat162 lo = __floats2bfloat162_rn(s.x, s.y), hi = __floats2bfloat162_rn(s.z, s.w);
  *reinterpret_cast<uint2*>(out + i) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

// ---------------------------------------------------------------------------
// W4A16, regime (b): wgmma at large M.

constexpr int WG_THREADS = 256;          // two warpgroups, 64 rows each
constexpr int WG_BM = 128, WG_BN = 128;  // output tile of a block
constexpr int WG_X = WG_BM * KB * 2;     // one x slice: 128 rows x 128 bf16, swizzled
constexpr int WG_P = KB * WG_BN;         // one packed block: 128 rows x 128 bytes
constexpr int WG_STAGE = WG_P + 2 * WG_X;
constexpr int WG_B = WG_BN * KB * 2;     // an unpacked B tile: 128 n x 128 k bf16
constexpr int WG_SMEM = 2 * WG_STAGE + 2 * WG_B + 1024;  // + the swizzle atom's alignment

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

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Shared memory (1,024-byte aligned): two ring stages (x's low and high
// slices, swizzled, then the packed block), then two unpacked B tiles. The
// groups run in order (low and high group of packed block 0, then of block
// 1, ...); group i's wgmma reads B tile i % 2 while the threads unpack group
// i + 1 into the other.
__global__ void __launch_bounds__(WG_THREADS, 1)
int4_wgmma_kernel(const uint16_t* __restrict__ x, const int8_t* __restrict__ packed,
                  const float* __restrict__ scales, uint16_t* __restrict__ out, int M, int K,
                  int N) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t b_tiles = base + 2 * WG_STAGE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c = lane & 3;
  const int wg = warp >> 2, wr = warp & 3;  // warpgroup, warp in it
  const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.y * WG_BM;
  const int half = K / 2, nkb = half / KB, n_groups = 2 * nkb;

  auto load = [&](int kb, int stage) {
    const uint32_t st = base + stage * WG_STAGE;
#pragma unroll
    for (int it = 0; it < 2 * WG_BM * 16 / WG_THREADS; ++it) {
      const int i = tid + it * WG_THREADS;
      const int hi = i / (WG_BM * 16), row = (i >> 4) % WG_BM, ch = i & 15;
      const bool ok = m0 + row < M;
      const uint16_t* src =
          ok ? x + (size_t)(m0 + row) * K + hi * half + kb * KB + ch * 8 : x;
      cp_async16(st + hi * WG_X + swz128(row, ch), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < WG_P / 16 / WG_THREADS; ++it) {
      const int i = tid + it * WG_THREADS, row = i >> 3, ch = i & 7;
      cp_async16(st + 2 * WG_X + packed_off(row, ch),
                 packed + (size_t)(kb * KB + row) * N + n0 + ch * 16, 16);
    }
  };

  // The unpack of group gi into B tile gi % 2: thread (kq, c16) takes
  // packed rows 4 kq .. 4 kq + 3 and columns 16 c16 .. 16 c16 + 15.
  const int kq = (lane & 15) + 16 * (warp & 1), c16 = (lane >> 4) + 2 * (warp >> 1);
  auto unpack = [&](int gi) {
    const unsigned char* pk = sm + ((gi >> 1) & 1) * WG_STAGE + 2 * WG_X;
    unsigned char* bt = sm + 2 * WG_STAGE + (gi & 1) * WG_B;
    uint4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = *reinterpret_cast<const uint4*>(pk + packed_off(4 * kq + i, c16));
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      const uint32_t wq[4] = {word(w[0], j4), word(w[1], j4), word(w[2], j4), word(w[3], j4)};
      uint32_t t[4];
      transpose4x4(wq, t);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint2*>(bt + swz128(16 * c16 + 4 * j4 + j, kq >> 1) + (kq & 1) * 8) =
            nibbles_bf16(biased_nibbles(t[j], (gi & 1) != 0));
    }
    fence_async_proxy();
  };

  // acc[h][4 j + e]: row 64 wg + 16 wr + g (+ 8 for e >= 2), column
  // 64 h + 8 j + 2c + (e & 1) of the block's tile.
  float acc[2][32], accg[2][32];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;

  load(0, 0);
  cp_async_commit();
  if (nkb > 1) load(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  fence_async_proxy();
  __syncthreads();
  unpack(0);
  __syncthreads();
  for (int gi = 0; gi < n_groups; ++gi) {
    const int kb = gi >> 1, nib = gi & 1;
    const uint32_t xs = base + (kb & 1) * WG_STAGE + nib * WG_X + wg * 64 * 128;
    const uint32_t bt = b_tiles + (gi & 1) * WG_B;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      const uint32_t off = (kk >> 2) * (128 * 128) + (kk & 3) * 32;
      const uint64_t da = make_desc(xs + off, 16, 1024);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        wgmma_m64n64k16_ss(accg[h], da, make_desc(bt + h * 64 * 128 + off, 16, 1024),
                           kk > 0 ? 1 : 0);
    }
    wgmma_commit();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) fence_operand(accg[h][i]);
    if (gi + 1 < n_groups) {
      if (nib == 1) {  // the next group is the next block's low one: its stage must be here
        cp_async_wait<0>();
        fence_async_proxy();
        __syncthreads();
      }
      unpack(gi + 1);  // B tile (gi + 1) % 2: group gi - 1's wgmma has completed
    }
    const int grp = nib * nkb + kb;
    float2 sv[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sv[h][j] = __ldg(reinterpret_cast<const float2*>(scales + (size_t)grp * N + n0 +
                                                         64 * h + 8 * j + 2 * c));
    wgmma_wait0();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_operand(accg[h][i]);
        acc[h][i] = fmaf(accg[h][i], (i & 1) ? sv[h][i >> 2].y : sv[h][i >> 2].x, acc[h][i]);
      }
    // Group gi + 1's B tile is complete, and every warpgroup is done with
    // group gi's operands: after a block's high group its stage takes the
    // block two ahead.
    __syncthreads();
    if (nib == 1 && kb + 2 < nkb) {
      load(kb + 2, kb & 1);
      cp_async_commit();
    }
  }

  const int g = lane >> 2;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int row = m0 + 64 * wg + 16 * wr + g + 8 * e2;
        if (row >= M) continue;
        const int col = n0 + 64 * h + 8 * j + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(acc[h][4 * j + 2 * e2], acc[h][4 * j + 2 * e2 + 1]);
      }
}

// ---------------------------------------------------------------------------
// s8 wgmma (both W4A8 regimes).

__device__ __forceinline__ void fence_operand(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// wgmma m64n32k32, s8 x s8 -> s32, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// wgmma m64n128k32, s8 x s8 -> s32, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,"
      "%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,"
      "%56,%57,%58,%59,%60,%61,%62,%63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// wgmma m64n64k32, s8 x s8 -> s32, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,"
      "%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,"
      "%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <int WBN>
__device__ __forceinline__ void wgmma_s8(int (&d)[WBN / 2], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
  if constexpr (WBN == 128) {
    wgmma_m64n128k32_s8(d, desc_a, desc_b, scale_d);
  } else if constexpr (WBN == 64) {
    wgmma_m64n64k32_s8(d, desc_a, desc_b, scale_d);
  } else {
    wgmma_m64n32k32_s8(d, desc_a, desc_b, scale_d);
  }
}

// ---------------------------------------------------------------------------
// W4A8, regime (a): the ordered split over a cluster at M <= 192.

constexpr int MAX_SMEM = 232448;     // 227 KB: a block's dynamic shared memory on Hopper
constexpr int CL_THREADS = 256;      // two warpgroups: warpgroup u runs group u (low, high) of a step
constexpr int CL_BM = 64;            // rows of a tile
constexpr int CL_X = CL_BM * KB;     // one x slice: 64 rows x 128 bytes, 128-byte swizzled
constexpr int CL_MAX_STAGES = 8;     // all of a rank's steps in flight where they fit

// The cluster kernel's shared memory for a BN-column tile (mirrored by
// _w4a8_layout in ops/int4_matmul.py), from a 1,024-byte aligned base:
// `stages` ring stages (x's low and high slices, swizzled for wgmma; the
// packed tile; the two groups' scales for the tile's columns), the two
// unpacked s8 B tiles (low group, high group; swizzled), the terms of the
// rank's 2 * per_rank groups, the tile's row scales, the chain's table.
template <int BN>
struct ClusterLayout {
  static constexpr int PCH = BN / 16;          // 16-byte chunks of a packed row
  static constexpr int PK = KB * BN;           // one packed tile (quad_chunk order)
  static constexpr int SC = 2 * BN * 4;        // the low and high groups' scales for the tile
  static constexpr int STAGE = (2 * CL_X + PK + SC + 1023) / 1024 * 1024;
  static constexpr int B = BN * KB;            // one unpacked B tile: BN n x 128 k, swizzled
  static constexpr int TP = BN + 8;            // term row pitch, floats (float2 stores hit distinct banks)
  static constexpr int TERM = CL_BM * TP;      // one group's terms, floats
  static int smem(int stages, int per_rank, int groups) {
    return 1024 + stages * STAGE + 2 * B + 2 * per_rank * TERM * 4 + CL_BM * 4 + groups * 4;
  }
  // The deepest ring that fits: every step of a rank in flight where the
  // shared memory allows, 0 where not even min(3, per_rank) stages fit.
  static int stages(int per_rank, int groups) {
    for (int st = per_rank < CL_MAX_STAGES ? per_rank : CL_MAX_STAGES; st >= 1; --st)
      if (smem(st, per_rank, groups) <= MAX_SMEM) return st >= (per_rank < 3 ? per_rank : 3) ? st : 0;
    return 0;
  }
};

__device__ __forceinline__ uint32_t mapa_cluster(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// Byte offset of 16-byte chunk `ch` of packed row `row` in the cluster
// kernel's packed tile: the four rows of a row quad q hold their chunk ch
// in four consecutive 16-byte slots (row i of the quad at slot i ^ (q & 3),
// chunk ch at ch ^ ((q >> 2) & 1)), so the unpack's lanes, one quad each,
// read eight distinct bank groups in every quarter warp.
template <int PCH>
__device__ __forceinline__ uint32_t quad_chunk(int row, int ch) {
  const int q = row >> 2, i = row & 3;
  return static_cast<uint32_t>(((q * PCH + (ch ^ ((q >> 2) & 1))) * 4 + (i ^ (q & 3))) * 16);
}

// VEC consecutive floats of another rank's shared memory (a shared::cluster address).
template <int VEC>
__device__ __forceinline__ void ld_cluster(float (&v)[VEC], uint32_t addr) {
  if constexpr (VEC == 4) {
    asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(addr)
                 : "memory");
  } else if constexpr (VEC == 2) {
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(v[0]), "=f"(v[1])
                 : "r"(addr)
                 : "memory");
  } else {
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v[0]) : "r"(addr) : "memory");
  }
}

// The ordered chain of a tile's outputs, VEC columns an item: rank `rank`
// takes an even, contiguous share of the rows * BN / VEC items, a thread
// one item at a time. For each item, its n_groups terms (group q at the
// table's rank and offset) are loaded 48 floats ahead of the float32 adds,
// which run in the Pallas order; then * a_scale, bf16.
template <int BN, int VEC>
__device__ __forceinline__ void w4a8_chain(const int* table, uint32_t terms_u32,
                                           const float* row_scale,
                                           uint16_t* __restrict__ out, int m0, int n0, int N,
                                           int rows, int n_groups, int rank, int C, int tid) {
  using L = ClusterLayout<BN>;
  constexpr int BATCH = 48 / VEC, PER_ROW = BN / VEC;
  const int items = rows * PER_ROW, share = (items + C - 1) / C;
  const int end = min(items, (rank + 1) * share);
  for (int it = rank * share + tid; it < end; it += CL_THREADS) {
    const int row = it / PER_ROW, col = VEC * (it % PER_ROW);
    const uint32_t off = terms_u32 + (row * L::TP + col) * 4;
    const float as = row_scale[row];
    float acc[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
    for (int q0 = 0; q0 < n_groups; q0 += BATCH) {
      float v[BATCH][VEC];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        if (q0 + u < n_groups) {
          const int entry = table[q0 + u];
          ld_cluster<VEC>(v[u], mapa_cluster(off + (entry >> 3) * 4, entry & 7));
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (q0 + u < n_groups)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], v[u][e]);
    }
    uint16_t* o = out + (size_t)(m0 + row) * N + n0 + col;
    if constexpr (VEC == 1) {
      *o = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(acc[0], as)));
    } else {
#pragma unroll
      for (int e = 0; e < VEC; e += 2) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(__fmul_rn(acc[e], as), __fmul_rn(acc[e + 1], as));
        *reinterpret_cast<__nv_bfloat162*>(o + e) = b;
      }
    }
  }
}

// Grid (C, N / BN, ceil(M / 64)), clusters of (C, 1, 1): the C ranks of a
// cluster share a 64 x BN output tile; rank r takes packed-row blocks
// [r nkb / C, (r + 1) nkb / C) (nkb = K / 256 blocks, each one low and one
// high group).
template <int BN>
__global__ void __launch_bounds__(CL_THREADS)
int4_w4a8_cluster_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ packed,
                         const float* __restrict__ scales, const float* __restrict__ a_scale,
                         uint16_t* __restrict__ out, int M, int K, int N, int stages) {
  using L = ClusterLayout<BN>;
  constexpr int PCH = BN / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - smem_u32(smem_raw));
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int n0 = blockIdx.y * BN, m0 = blockIdx.z * CL_BM;
  const int half = K / 2, nkb = half / KB, n_groups = 2 * nkb;
  const int per_rank = (nkb + C - 1) / C;
  const int kb0 = rank * nkb / C, cnt = (rank + 1) * nkb / C - kb0;
  uint8_t* const Bs = smem + stages * L::STAGE;
  float* const terms = reinterpret_cast<float*>(Bs + 2 * L::B);  // [2 per_rank][64][TP]
  float* const row_scale = terms + 2 * per_rank * L::TERM;  // a_scale of the tile's rows
  int* const table = reinterpret_cast<int*>(row_scale + CL_BM);

  // The chain's table: group q (low groups, then high) lies in rank r's
  // terms at float offset o: (o << 3) | r.
  for (int q = tid; q < n_groups; q += CL_THREADS) {
    const int nib = q >= nkb ? 1 : 0, kb = q - nib * nkb;
    const int r = ((kb + 1) * C - 1) / nkb, slot = nib * per_rank + kb - r * nkb / C;
    table[q] = (slot * L::TERM) << 3 | r;
  }

  auto load = [&](int s, int stage) {
    const int kb = kb0 + s;
    const uint32_t st = smem_u32(smem + stage * L::STAGE);
#pragma unroll
    for (int it = 0; it < 2 * CL_BM * 8 / CL_THREADS; ++it) {
      const int i = tid + it * CL_THREADS;
      const int hi = i / (CL_BM * 8), row = (i >> 3) % CL_BM, ch = i & 7;
      const bool ok = m0 + row < M;
      const int8_t* src = ok ? xq + (size_t)(m0 + row) * K + hi * half + kb * KB + ch * 16 : xq;
      cp_async16(st + hi * CL_X + swz128(row, ch), src, ok ? 16 : 0);
    }
#pragma unroll
    for (int it = 0; it < (KB * PCH + CL_THREADS - 1) / CL_THREADS; ++it) {
      const int i = tid + it * CL_THREADS, row = i / PCH, ch = i % PCH;
      if (i < KB * PCH)
        cp_async16(st + 2 * CL_X + quad_chunk<L::PCH>(row, ch),
                   packed + (size_t)(kb * KB + row) * N + n0 + ch * 16, 16);
    }
    if (tid < L::SC / 16) {  // the scales of groups kb and nkb + kb for the tile's columns
      const int hi = tid / (BN / 4), ch = tid % (BN / 4);
      cp_async16(st + 2 * CL_X + L::PK + tid * 16,
                 scales + (size_t)(hi * nkb + kb) * N + n0 + ch * 4, 16);
    }
  };

  // The unpack: thread (kq, c16, unib, js) takes packed rows 4 kq .. 4 kq +
  // 3 and columns 16 c16 .. 16 c16 + 15, and writes group unib's values of
  // its JS-th share of those columns (every warp has a share).
  constexpr int JS = CL_THREADS / 32 / (2 * PCH);  // warps sharing a (c16, group) unpack
  const int kq = lane, c16 = warp % PCH, unib = (warp / PCH) & 1, js = warp / (2 * PCH);
  // The products: warpgroup nib runs group nib of the step (wgmma m64nBNk32
  // on x's slice and the B tile); warp wr of it holds rows 16 wr .. 16 wr + 15.
  const int nib = warp >> 2, wr = warp & 3;
  // The ring: `ahead` steps' loads in flight before the first (all of them
  // where the stages allow), each step issuing the one `ahead` later.
  const int ahead = stages > 1 ? stages - 1 : 1;
  int part[BN / 2];  // a group's int32 sums (the first k32 step overwrites them)
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) part[r] = 0;
  if (tid < CL_BM / 4) {  // the tile's row scales, with the first stage (0 past M)
    const int rows_ok = min(4, max(0, M - m0 - 4 * tid));
    cp_async16(smem_u32(row_scale + 4 * tid), a_scale + (rows_ok > 0 ? m0 + 4 * tid : 0),
               4 * rows_ok);
  }
  for (int s = 0; s < ahead; ++s) {
    if (s < cnt) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < cnt; ++s) {
    cp_async_wait_dyn(ahead - 1);  // step s's stage landed (this thread's copies)
    fence_async_proxy();  // ... visible to wgmma's reads
    __syncthreads();  // ... every thread's; every warp is done with step s - 1's stage and B tiles
    if (s + ahead < cnt) load(s + ahead, (s + ahead) % stages);
    cp_async_commit();
    const uint8_t* st = smem + (s % stages) * L::STAGE;
    {
      uint4 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = *reinterpret_cast<const uint4*>(st + 2 * CL_X + quad_chunk<L::PCH>(4 * kq + i, c16));
#pragma unroll
      for (int jj = 0; jj < 4 / JS; ++jj) {
        const int j4 = js * (4 / JS) + jj;
        const uint32_t wq[4] = {word(w[0], j4), word(w[1], j4), word(w[2], j4), word(w[3], j4)};
        uint32_t t[4];
        transpose4x4(wq, t);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<uint32_t*>(Bs + unib * L::B + swz128(16 * c16 + 4 * j4 + j, kq >> 2) +
                                       (kq & 3) * 4) = s8_nibbles(t[j], unib != 0);
      }
      fence_async_proxy();
    }
    __syncthreads();  // both B tiles are complete
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk)
      wgmma_s8<BN>(part, make_desc(smem_u32(st + nib * CL_X) + kk * 32, 16, 1024),
                   make_desc(smem_u32(Bs + nib * L::B) + kk * 32, 16, 1024), kk > 0 ? 1 : 0);
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int r = 0; r < BN / 2; ++r) fence_operand(part[r]);
    // The group's terms fl(I * s), one rounding each, in this rank's slot:
    // part[4 j + e] is row 16 wr + g (+ 8 for e >= 2), column 8 j + 2c + (e & 1).
    float* tt = terms + (nib * per_rank + s) * L::TERM + (16 * wr + g) * L::TP + 2 * c;
    const float* sc = reinterpret_cast<const float*>(st + 2 * CL_X + L::PK) + nib * BN + 2 * c;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const float2 sv = *reinterpret_cast<const float2*>(sc + j * 8);
      *reinterpret_cast<float2*>(tt + j * 8) =
          make_float2(__fmul_rn(exact_float(part[4 * j]), sv.x),
                      __fmul_rn(exact_float(part[4 * j + 1]), sv.y));
      *reinterpret_cast<float2*>(tt + 8 * L::TP + j * 8) =
          make_float2(__fmul_rn(exact_float(part[4 * j + 2]), sv.x),
                      __fmul_rn(exact_float(part[4 * j + 3]), sv.y));
    }
  }

  cluster.sync();  // every rank's terms are written and visible to the cluster
  // The ordered chain, VEC columns at a time (the widest load that keeps at
  // least half of every rank's threads busy: a shared::cluster load costs
  // per request): each rank takes an even share of the tile's outputs.
  const int rows = min(CL_BM, M - m0);
  const uint32_t terms_u32 = smem_u32(terms);
  if (rows * BN / 4 >= C * CL_THREADS / 2) {
    w4a8_chain<BN, 4>(table, terms_u32, row_scale, out, m0, n0, N, rows, n_groups, rank, C, tid);
  } else if (rows * BN / 2 >= C * CL_THREADS / 2) {
    w4a8_chain<BN, 2>(table, terms_u32, row_scale, out, m0, n0, N, rows, n_groups, rank, C, tid);
  } else {
    w4a8_chain<BN, 1>(table, terms_u32, row_scale, out, m0, n0, N, rows, n_groups, rank, C, tid);
  }
  cluster.sync();  // no block leaves while another still reads its terms
}

// ---------------------------------------------------------------------------
// W4A8, regime (b): s8 wgmma at M > 192.

constexpr int W8_CONSUMERS = 256;  // two warpgroups of 64 rows
constexpr int W8_PRODUCERS = 128;  // a producer warpgroup: one warp on each SM sub-partition
constexpr int W8_THREADS = W8_CONSUMERS + W8_PRODUCERS;
constexpr int W8_BM = 128;
constexpr int W8_STAGES = 4;
constexpr int W8_X = W8_BM * KB;  // an xq slice: 128 rows x 128 bytes, swizzled

// The wgmma kernel's tile at WBN columns (128, or 64 where 128-column tiles
// leave SMs idle): a packed tile of 128 rows x WBN bytes, an unpacked s8 B
// tile of WBN n x 128 k.
template <int WBN>
struct WgLayout {
  static constexpr int CH = WBN / 16;     // 16-byte chunks of a packed row
  static constexpr int P = KB * WBN;
  static constexpr int SC = WBN * 4;      // the group's scales for the tile's columns
  static constexpr int STAGE = (W8_X + P + SC + 1023) / 1024 * 1024;  // x stays 1,024-aligned
  static constexpr int B = WBN * KB;
  static constexpr int SMEM = W8_STAGES * STAGE + 2 * B + 1024;  // + the swizzle atom's alignment
};

// Byte offset of 16-byte chunk `ch` of row `row` of a packed tile of `ch_n`
// chunks a row: chunks XOR-swizzled by the row's quad, so the unpack's
// threads, one row quad each, read distinct banks.
__device__ __forceinline__ uint32_t packed_off_n(int row, int ch, int ch_n) {
  return static_cast<uint32_t>(row * ch_n * 16 + ((ch ^ ((row >> 2) & (ch_n - 1))) << 4));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrives once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(W8_CONSUMERS) : "memory");
}

// Shared memory (1,024-byte aligned): W8_STAGES ring stages (the xq slice,
// swizzled, the packed tile, chunks swizzled by row quad, the group's
// scales for the tile's columns), then two
// unpacked B tiles. Step i is group i: packed block i of the low groups for
// i < nkb, block i - nkb of the high groups after. Group i's wgmma reads B
// tile i % 2 while the consumers unpack group i + 1 into the other.
template <int WBN>
__global__ void __launch_bounds__(W8_THREADS, 1)
int4_w4a8_wgmma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ packed,
                       const float* __restrict__ scales, const float* __restrict__ a_scale,
                       uint16_t* __restrict__ out, int M, int K, int N) {
  using L = WgLayout<WBN>;
  constexpr int NA = WBN / 2;  // accumulator registers a thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[W8_STAGES], empty_bar[W8_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - smem_u32(smem_raw));
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * WBN, m0 = blockIdx.y * W8_BM;
  const int half = K / 2, nkb = half / KB, steps = 2 * nkb;

  if (tid == 0) {
    for (int st = 0; st < W8_STAGES; ++st) {
      mbar_init(smem_u32(&full_bar[st]), W8_PRODUCERS);   // every producer thread
      mbar_init(smem_u32(&empty_bar[st]), W8_CONSUMERS);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= W8_CONSUMERS / 32) {
    // Producer warpgroup: fills step i's stage once the consumers have
    // released the step W8_STAGES before it there (the copies of a stage are
    // spread over four warps: one warp's cp.async issue cannot keep up).
    const int pt = tid - W8_CONSUMERS;
    for (int i = 0; i < steps; ++i) {
      const int st = i % W8_STAGES, round = i / W8_STAGES;
      if (round > 0) mbar_wait(smem_u32(&empty_bar[st]), (round - 1) & 1);
      const int hi = i >= nkb ? 1 : 0, kb = i - hi * nkb;
      const uint32_t xs = base + st * L::STAGE, ps = xs + W8_X;
#pragma unroll
      for (int it = 0; it < W8_BM * 8 / W8_PRODUCERS; ++it) {
        const int idx = pt + W8_PRODUCERS * it, row = idx >> 3, ch = idx & 7;
        const bool ok = m0 + row < M;
        const int8_t* src = ok ? xq + (size_t)(m0 + row) * K + hi * half + kb * KB + ch * 16 : xq;
        cp_async16(xs + swz128(row, ch), src, ok ? 16 : 0);
      }
#pragma unroll
      for (int it = 0; it < KB * L::CH / W8_PRODUCERS; ++it) {
        const int idx = pt + W8_PRODUCERS * it, row = idx / L::CH, ch = idx % L::CH;
        cp_async16(ps + packed_off_n(row, ch, L::CH),
                   packed + (size_t)(kb * KB + row) * N + n0 + ch * 16, 16);
      }
      if (pt < L::SC / 16)  // group i's scales
        cp_async16(ps + L::P + pt * 16, scales + (size_t)i * N + n0 + pt * 4, 16);
      mbar_arrive_cp_async(smem_u32(&full_bar[st]));
    }
    cp_async_wait<0>();
    return;
  }

  const int wg = warp >> 2, wr = warp & 3, g = lane >> 2, c = lane & 3;
  // The unpack of group i into B tile i % 2: warp w < CH takes columns 16 w
  // .. 16 w + 15, lane kq packed rows 4 kq .. 4 kq + 3 (a warp's stores fill
  // whole 128-byte rows).
  const int kq = lane, c16 = warp;
  auto unpack = [&](int i) {
    const int st = i % W8_STAGES;
    mbar_wait(smem_u32(&full_bar[st]), (i / W8_STAGES) & 1);
    fence_async_proxy();
    if (c16 < L::CH) {
      const unsigned char* pk = sm + st * L::STAGE + W8_X;
      unsigned char* bt = sm + W8_STAGES * L::STAGE + (i & 1) * L::B;
      const bool high = i >= nkb;
      uint4 w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint4*>(pk + packed_off_n(4 * kq + r, c16, L::CH));
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        const uint32_t wq[4] = {word(w[0], j4), word(w[1], j4), word(w[2], j4), word(w[3], j4)};
        uint32_t t[4];
        transpose4x4(wq, t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int n = 16 * c16 + 4 * j4 + j;
          *reinterpret_cast<uint32_t*>(bt + swz128(n, kq >> 2) + (kq & 3) * 4) =
              s8_nibbles(t[j], high);
        }
      }
      fence_async_proxy();
    }
  };

  // acc[4 j + e]: row 64 wg + 16 wr + g (+ 8 for e >= 2), column 8 j + 2c +
  // (e & 1) of the block's tile; accg the same for one group's int32 sums.
  float acc[NA];
  int accg[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    acc[i] = 0.f;
    accg[i] = 0;
  }
  unpack(0);
  consumer_sync();
  const uint32_t b_tiles = base + W8_STAGES * L::STAGE;
  for (int i = 0; i < steps; ++i) {
    const int st = i % W8_STAGES;
    const uint32_t xs = base + st * L::STAGE + wg * 64 * KB;
    const uint32_t bt = b_tiles + (i & 1) * L::B;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB / 32; ++kk)
      wgmma_s8<WBN>(accg, make_desc(xs + kk * 32, 16, 1024), make_desc(bt + kk * 32, 16, 1024),
                    kk > 0 ? 1 : 0);
    wgmma_commit();
#pragma unroll
    for (int r = 0; r < NA; ++r) fence_operand(accg[r]);
    if (i + 1 < steps) unpack(i + 1);  // B tile (i + 1) % 2: group i - 1's wgmma has completed
    const float* sg = reinterpret_cast<const float*>(sm + st * L::STAGE + W8_X + L::P) + 2 * c;
    wgmma_wait0();
#pragma unroll
    for (int r = 0; r < NA; ++r) fence_operand(accg[r]);
    // One rounding each, in the plain version's order: acc + fl(I * s).
#pragma unroll
    for (int j = 0; j < WBN / 8; ++j) {
      const float2 sv = *reinterpret_cast<const float2*>(sg + 8 * j);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * j + e] = __fadd_rn(acc[4 * j + e],
                                   __fmul_rn(exact_float(accg[4 * j + e]), (e & 1) ? sv.y : sv.x));
    }
    mbar_arrive(smem_u32(&empty_bar[st]));
    // Group i + 1's B tile is complete, and both warpgroups are done with
    // group i's (the next step's unpack overwrites it).
    consumer_sync();
  }

#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int row = m0 + 64 * wg + 16 * wr + g + 8 * e2;
    if (row >= M) continue;
    const float as = a_scale[row];
#pragma unroll
    for (int j = 0; j < WBN / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + n0 + 8 * j + 2 * c) =
          __floats2bfloat162_rn(__fmul_rn(acc[4 * j + 2 * e2], as),
                                __fmul_rn(acc[4 * j + 2 * e2 + 1], as));
  }
}

// cudaFuncSetAttribute for `bytes` of dynamic shared memory, once per
// device for kernel `which` (it costs host time on every launch otherwise).
template <typename F>
cudaError_t allow_smem(F kernel, int bytes, int which) {
  constexpr int MAX_DEVICES = 64;
  static bool done[6][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[which][dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[which][dev] = true;
  return err;
}

bool shapes_ok(int M, int K, int N) { return M >= 1 && K % (2 * KB) == 0 && N % 128 == 0; }

// The cluster kernel at BN columns: C ranks over the packed-row blocks,
// C <= 8 (the portable limit) and at most one rank a block.
template <int BN>
cudaError_t launch_w4a8_cluster(const int8_t* xq, const int8_t* packed, const float* scales,
                                const float* a_scale, uint16_t* out, int M, int K, int N,
                                int cluster, cudaStream_t stream, int which) {
  const int nkb = K / 2 / KB;
  if (N % BN != 0 || cluster < 1 || cluster > 8 || cluster > nkb) return cudaErrorInvalidValue;
  const int per_rank = (nkb + cluster - 1) / cluster;
  const int stages = ClusterLayout<BN>::stages(per_rank, 2 * nkb);
  if (stages == 0) return cudaErrorInvalidValue;
  const int smem = ClusterLayout<BN>::smem(stages, per_rank, 2 * nkb);
  const cudaError_t set = allow_smem(int4_w4a8_cluster_kernel<BN>, MAX_SMEM, which);
  if (set != cudaSuccess) return set;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N / BN, (M + CL_BM - 1) / CL_BM);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, int4_w4a8_cluster_kernel<BN>, xq, packed, scales, a_scale, out,
                            M, K, N, stages);
}

// The wgmma kernel at WBN columns.
template <int WBN>
cudaError_t launch_w4a8_wgmma(const int8_t* xq, const int8_t* packed, const float* scales,
                              const float* a_scale, uint16_t* out, int M, int K, int N,
                              cudaStream_t stream, int which) {
  if (N % WBN != 0) return cudaErrorInvalidValue;
  const cudaError_t set = allow_smem(int4_w4a8_wgmma_kernel<WBN>, WgLayout<WBN>::SMEM, which);
  if (set != cudaSuccess) return set;
  int4_w4a8_wgmma_kernel<WBN><<<dim3(N / WBN, (M + W8_BM - 1) / W8_BM), W8_THREADS,
                                WgLayout<WBN>::SMEM, stream>>>(xq, packed, scales, a_scale, out,
                                                               M, K, N);
  return cudaGetLastError();
}

}  // namespace

// units_per_split > 0: regime (a), n_split splits of that many 64-row
// units, part float32 scratch of n_split * M * N values (unused for one
// split); units_per_split == 0: regime (b).
extern "C" int dots_int4_matmul_w4a16(const void* x, const void* packed, const void* scales,
                                      void* part, void* out, int M, int K, int N,
                                      int units_per_split, int n_split, void* stream) {
  if (!shapes_ok(M, K, N) || N % SK_BN != 0 || units_per_split < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const uint16_t*>(x);
  const auto* pp = static_cast<const int8_t*>(packed);
  const auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<uint16_t*>(out);
  if (units_per_split == 0) {
    const cudaError_t set = allow_smem(int4_wgmma_kernel, WG_SMEM, 0);
    if (set != cudaSuccess) return static_cast<int>(set);
    int4_wgmma_kernel<<<dim3(N / WG_BN, (M + WG_BM - 1) / WG_BM), WG_THREADS, WG_SMEM, st>>>(
        xp, pp, sp, op, M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_units = K / 2 / SK_UNIT;
  if (n_split < 1 || (long long)n_split * units_per_split < n_units ||
      (n_split - 1) * units_per_split >= n_units || (n_split > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = allow_smem(int4_splitk_kernel, SK_SMEM, 1);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto* partp = static_cast<float*>(part);
  int4_splitk_kernel<<<dim3(N / SK_BN, (M + SK_BM - 1) / SK_BM, n_split), SK_THREADS, SK_SMEM,
                       st>>>(xp, pp, sp, partp, op, M, K, N, units_per_split, n_split);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  const int mn = M * N;
  int4_reduce_kernel<<<(mn / 4 + 255) / 256, 256, 0, st>>>(partp, op, mn, n_split);
  return static_cast<int>(cudaGetLastError());
}

// scratch: M * K bytes of xq, then M float32 row scales. cluster > 0:
// regime (a), `cols` 32 or 64, clusters of `cluster` CTAs; cluster 0:
// regime (b), `cols` 128 or 64.
extern "C" int dots_int4_matmul_w4a8(const void* x, const void* packed, const void* scales,
                                     void* scratch, void* out, int M, int K, int N, int cols,
                                     int cluster, void* stream) {
  if (!shapes_ok(M, K, N) || scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* xq = static_cast<int8_t*>(scratch);
  auto* a_scale = reinterpret_cast<float*>(xq + (size_t)M * K);
  quantize_rows_kernel<<<M, QR_THREADS, 0, st>>>(static_cast<const uint16_t*>(x), xq, a_scale,
                                                  K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* pp = static_cast<const int8_t*>(packed);
  const auto* sp = static_cast<const float*>(scales);
  auto* op = static_cast<uint16_t*>(out);
  if (cluster > 0 && cols == 32)
    return static_cast<int>(
        launch_w4a8_cluster<32>(xq, pp, sp, a_scale, op, M, K, N, cluster, st, 2));
  if (cluster > 0 && cols == 64)
    return static_cast<int>(
        launch_w4a8_cluster<64>(xq, pp, sp, a_scale, op, M, K, N, cluster, st, 3));
  if (cols == 128) return static_cast<int>(launch_w4a8_wgmma<128>(xq, pp, sp, a_scale, op, M, K, N,
                                                                  st, 4));
  if (cols == 64) return static_cast<int>(launch_w4a8_wgmma<64>(xq, pp, sp, a_scale, op, M, K, N,
                                                                st, 5));
  return static_cast<int>(cudaErrorInvalidValue);
}
