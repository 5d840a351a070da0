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
// What the design does about it: one block (4 warps, 2 x 2 warp tiles of
// 32 x 32) per 64 x 64 output tile walks K one packed-row block of 128 at a
// time. Each packed 128 x 64 byte tile is read once from device memory with
// coalesced 16-byte loads, unpacked and transposed in registers (4 x 4 byte
// transposes) and stored to shared memory k-contiguous, the column-major B
// operand of mma.sync: bf16 m16n8k16 with f32 sums (W4A16) or s8 m16n8k32
// with s32 sums (W4A8). In W4A16 one tile feeds two group products, group
// kb from its low nibbles and group kb + G/2 from its high nibbles. Each
// group's partial sum stays in registers and is scaled by s[g, n] into the
// float32 accumulator. The next step's global loads are issued into
// registers before the current step's products run (one step of prefetch).
// W4A8 walks the packed rows twice, low nibbles then high, so it adds its
// group sums in the Pallas order (every low group, then every high group):
// the sums are integers, each scaled with one rounding, so kernel and plain
// version agree bit for bit; its second walk reads the tiles again, mostly
// from L2 (a linear's packed weights are at most 6.9 MB). Shared rows are
// padded by 16 bytes so a fragment's 8 rows hit distinct banks. Simple
// first: no cp.async/TMA pipeline, no wgmma, no split-K (at M = 64 an
// N = 1,536 linear has 24 blocks for 132 SMs).

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

bool shapes_ok(int M, int K, int N) { return M >= 1 && K % (2 * KB) == 0 && N % BN == 0; }

}  // namespace

extern "C" int dots_int4_matmul_w4a16(const void* x, const void* packed, const void* scales,
                                      void* out, int M, int K, int N, void* stream) {
  if (!shapes_ok(M, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = Mode<false>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(int4_matmul_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  int4_matmul_kernel<false><<<grid, NUM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scales), nullptr, static_cast<uint16_t*>(out), M, K, N);
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
