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
// W4A8 (the W4A8 kernel below, int4_matmul_kernel<true>): one block (4
// warps, 2 x 2 warp tiles of 32 x 32) per 64 x 64 output tile walks K one
// packed-row block of 128 at a time. Each packed 128 x 64 byte tile is read
// once from device memory with coalesced 16-byte loads, unpacked and
// transposed in registers (4 x 4 byte transposes) and stored to shared
// memory k-contiguous, the column-major B operand of mma.sync s8 m16n8k32
// with s32 sums. It walks the packed rows twice, low nibbles then high, so
// it adds its group sums in the Pallas order (every low group, then every
// high group): the sums are integers, each scaled with one rounding, so
// kernel and plain version agree bit for bit (a split over K would break
// that). Shared rows are padded by 16 bytes so a fragment's 8 rows hit
// distinct banks. The next step's global loads are issued into registers
// before the current step's products run.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KB = 128;           // packed rows per step: one low and one high group
constexpr int BM = 64, BN = 64;   // output tile of a block
constexpr int NUM_THREADS = 128;  // 4 warps, 2 x 2 over the tile
constexpr int WM = 32, WN = 32;   // warp tile
constexpr int MT = WM / 16, NT = WN / 8;

template <bool A8>
struct Mode {
  static constexpr int ESIZE = A8 ? 1 : 2;            // bytes per x element
  static constexpr int ROW = KB * ESIZE;              // bytes of one group row
  static constexpr int PITCH = ROW + 16;              // shared row pitch (4 mod 32 words)
  static constexpr int NIB = A8 ? 1 : 2;              // group products per step
  static constexpr int PASSES = A8 ? 2 : 1;           // walks over the packed rows
  static constexpr int XCH = ROW / 16;                // 16-byte chunks per x row
  static constexpr int XPT = BM * XCH / NUM_THREADS;  // x chunks per thread per group
  static constexpr int SMEM = NIB * (BM + BN) * PITCH;
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// Four biased nibbles u -> four bf16 q = u - 8, exactly: 0x43uu is the
// bf16 value 128 + u, and 128 + u - 136 is exact.
__device__ __forceinline__ uint2 nibbles_bf16(uint32_t u) {
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
  uint32_t p0 = __byte_perm(u, 0x43434343u, 0x5140), p1 = __byte_perm(u, 0x43434343u, 0x7362);
  __nv_bfloat162 v0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p0), bias);
  __nv_bfloat162 v1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&p1), bias);
  return make_uint2(*reinterpret_cast<uint32_t*>(&v0), *reinterpret_cast<uint32_t*>(&v1));
}

template <bool A8>
__global__ void __launch_bounds__(NUM_THREADS)
int4_matmul_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ packed,
                   const float* __restrict__ scales, const float* __restrict__ a_scale,
                   uint16_t* __restrict__ out, int M, int K, int N) {
  using Md = Mode<A8>;
  using Acc = typename std::conditional<A8, int, float>::type;
  constexpr int P = Md::PITCH;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const Xs = smem;                     // [NIB][BM][P], k contiguous
  uint8_t* const Ws = smem + Md::NIB * BM * P;  // [NIB][BN][P], k contiguous

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // mma groupID, thread in group
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int half = K / 2, nkb = half / KB;  // packed-row blocks = groups per half
  const size_t x_pitch = (size_t)K * Md::ESIZE;
  // This thread's share of a packed tile: rows 4 kq .. 4 kq + 3, columns
  // 16 c16 .. 16 c16 + 15 (a warp reads 8 rows x 64 contiguous bytes).
  const int kq = (tid & 7) + 8 * warp, c16 = (tid >> 3) & 3;

  uint4 wreg[4];
  uint4 xreg[Md::NIB][Md::XPT];

  auto load = [&](int step) {
    const int pass = step / nkb, kb = step % nkb;
    const int8_t* wp = packed + (size_t)(kb * KB + 4 * kq) * N + n0 + 16 * c16;
#pragma unroll
    for (int i = 0; i < 4; ++i) wreg[i] = __ldg(reinterpret_cast<const uint4*>(wp + (size_t)i * N));
#pragma unroll
    for (int nib = 0; nib < Md::NIB; ++nib) {
      const int high = A8 ? pass : nib;
      const size_t col = ((size_t)high * half + (size_t)kb * KB) * Md::ESIZE;
#pragma unroll
      for (int it = 0; it < Md::XPT; ++it) {
        const int idx = tid + it * NUM_THREADS;
        const int row = idx / Md::XCH, ch = idx % Md::XCH;
        xreg[nib][it] = m0 + row < M
            ? __ldg(reinterpret_cast<const uint4*>(x + (m0 + row) * x_pitch + col + ch * 16))
            : make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };

  auto store = [&](int pass) {
#pragma unroll
    for (int nib = 0; nib < Md::NIB; ++nib)
#pragma unroll
      for (int it = 0; it < Md::XPT; ++it) {
        const int idx = tid + it * NUM_THREADS;
        const int row = idx / Md::XCH, ch = idx % Md::XCH;
        *reinterpret_cast<uint4*>(Xs + (nib * BM + row) * P + ch * 16) = xreg[nib][it];
      }
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      uint32_t w[4], t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = word(wreg[i], j4);
      transpose4x4(w, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = 16 * c16 + 4 * j4 + j;
#pragma unroll
        for (int nib = 0; nib < Md::NIB; ++nib) {
          const uint32_t u = biased_nibbles(t[j], (A8 ? pass : nib) != 0);
          uint8_t* row = Ws + (nib * BN + n) * P + 4 * kq * Md::ESIZE;
          if constexpr (A8) {
            *reinterpret_cast<uint32_t*>(row) = __vsub4(u, 0x08080808u);
          } else {
            *reinterpret_cast<uint2*>(row) = nibbles_bf16(u);
          }
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  const int steps = Md::PASSES * nkb;
  load(0);
  for (int step = 0; step < steps; ++step) {
    const int pass = step / nkb, kb = step % nkb;
    store(pass);
    __syncthreads();
    if (step + 1 < steps) load(step + 1);  // in flight during the products
#pragma unroll
    for (int nib = 0; nib < Md::NIB; ++nib) {
      const int grp = (A8 ? pass : nib) * nkb + kb;  // low groups first, then high
      float2 sv[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        sv[nt] = __ldg(reinterpret_cast<const float2*>(
            scales + (size_t)grp * N + n0 + wn * WN + nt * 8 + 2 * c));
      Acc part[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0;
      const uint8_t* xa = Xs + (nib * BM + wm * WM + g) * P + 4 * c;
      const uint8_t* wb = Ws + (nib * BN + wn * WN + g) * P + 4 * c;
#pragma unroll
      for (int kk = 0; kk < Md::ROW / 32; ++kk) {  // k16 (bf16) or k32 (s8) steps
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint8_t* p = xa + mt * 16 * P + kk * 32;
          a[mt][0] = ld32(p);
          a[mt][1] = ld32(p + 8 * P);
          a[mt][2] = ld32(p + 16);
          a[mt][3] = ld32(p + 8 * P + 16);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint8_t* p = wb + nt * 8 * P + kk * 32;
          const uint32_t b0 = ld32(p), b1 = ld32(p + 16);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) mma(part[mt][nt], a[mt], b0, b1);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float s = (i & 1) ? sv[nt].y : sv[nt].x;
            if constexpr (A8) {  // one rounding each, in the plain version's order
              acc[mt][nt][i] = __fadd_rn(acc[mt][nt][i], __fmul_rn((float)part[mt][nt][i], s));
            } else {
              acc[mt][nt][i] = fmaf(part[mt][nt][i], s, acc[mt][nt][i]);
            }
          }
    }
    __syncthreads();  // Xs / Ws are refilled by the next step
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * WM + mt * 16 + g + 8 * h;
        if (row >= M) continue;
        const int col = n0 + wn * WN + nt * 8 + 2 * c;
        float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if constexpr (A8) {
          const float as = a_scale[row];
          v0 = __fmul_rn(v0, as);
          v1 = __fmul_rn(v1, as);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
}

// W4A8's pre-pass: one warp per row of x [M, K] bf16 -> xq [M, K] int8 and
// a_scale [M] f32, with true division and round-half-to-even (as the plain
// version's torch.round and the Pallas body's jnp.round).
__global__ void __launch_bounds__(NUM_THREADS)
quantize_rows_kernel(const uint16_t* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ a_scale, int M, int K) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (NUM_THREADS / 32) + warp;
  if (row >= M) return;
  const uint16_t* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + k));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fmaxf(fabsf(bf_lo(w[e])), fabsf(bf_hi(w[e]))));
  }
  amax = warp_max(amax);
  const float s = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
  for (int k = lane * 8; k < K; k += 256) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xr + k));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t q[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = (uint32_t)__float2int_rn(__fdiv_rn(bf_lo(w[e]), s)) & 0xffu;
      const uint32_t hi = (uint32_t)__float2int_rn(__fdiv_rn(bf_hi(w[e]), s)) & 0xffu;
      q[e >> 1] |= (lo | (hi << 8)) << (16 * (e & 1));
    }
    *reinterpret_cast<uint2*>(xq + (size_t)row * K + k) = make_uint2(q[0], q[1]);
  }
  if (lane == 0) a_scale[row] = s;
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

// cudaFuncSetAttribute for `bytes` of dynamic shared memory, once per
// device for kernel `which` (it costs host time on every launch otherwise).
template <typename F>
cudaError_t allow_smem(F kernel, int bytes, int which) {
  constexpr int MAX_DEVICES = 64;
  static bool done[2][MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < MAX_DEVICES && done[which][dev])) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < MAX_DEVICES) done[which][dev] = true;
  return err;
}

bool shapes_ok(int M, int K, int N) { return M >= 1 && K % (2 * KB) == 0 && N % BN == 0; }

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

extern "C" int dots_int4_matmul_w4a8(const void* x, const void* packed, const void* scales,
                                     void* xq, void* a_scale, void* out, int M, int K, int N,
                                     void* stream) {
  if (!shapes_ok(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int rows_per_block = NUM_THREADS / 32;
  quantize_rows_kernel<<<(M + rows_per_block - 1) / rows_per_block, NUM_THREADS, 0, st>>>(
      static_cast<const uint16_t*>(x), static_cast<int8_t*>(xq), static_cast<float*>(a_scale),
      M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  int4_matmul_kernel<true><<<grid, NUM_THREADS, Mode<true>::SMEM, st>>>(
      static_cast<const uint8_t*>(xq), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(a_scale),
      static_cast<uint16_t*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
