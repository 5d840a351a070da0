// Dense attention within uniform windows for Hopper (sm_90a), bf16 in /
// bf16 out: the windowed layers of the vision encoder.
//
// Replaces the Pallas kernel dots_ocr_tpu/ops/window_attention.py:
// window_attention -> _window_kernel (the pl.pallas_call at line 96). Same
// function, per (window, head) of q, k, v [nw, W, H, D]:
//   s = (q . k^T, float32) * scale; keys with segment id < 0 -> -1e30
//   m = rowmax(s); p = exp(s - m); l = sum(p) over the unrounded float32 p
//   o = (bf16(p) @ v, float32 sum) / l
// A row whose keys are all padding (a window of the bucket tail) gets the
// uniform average of V, exactly as the Pallas body gives it.
//
// What bounds it on this card: at the encoder's shape (W = 256 raw patches,
// H = 12, D = 128) each (window, head) reads 3 x 64 KB and writes 64 KB but
// does 2 x 256 x 256 x 128 x 2 = 33.6 MFLOP: ~130 FLOP per byte, below the
// H100's ~295 bf16 ridge, so on paper memory bound; in practice the two
// tensor-core products and the float32 softmax set the time at this size.
//
// What the design does about it: one block (8 warps) per (head, window).
// The window's K and V for that head are staged in shared memory once
// (2 x W x (D + 8) halfwords: 139 KB at W = 256, D = 128), read strided
// straight from the [nw, W, H, D] layout: no head-major copy, which is
// what cost the TPU kernel end to end. Each warp owns 16-row query tiles
// (held as mma fragments in registers) and makes two passes over the keys
// on mma.sync m16n8k16 bf16 -> f32: the first finds the row max, the
// second recomputes the scores, forms p against that final max (the Pallas
// order of rounding; an online softmax would round p against a running
// max), sums l from the float32 p and accumulates bf16(p) @ V. The second
// pass re-does QK^T, 1.5x the products of one pass, to keep 64 KB of
// scores out of registers and shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 256;  // 8 warps
constexpr int KEY_TILE = 64;
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two floats -> bf16x2, the first in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The scores of one 64-key tile for this warp's 16 query rows, scaled and
// masked: s[j][e] is key k0 + j*8 + 2c + (e & 1) of row g (e < 2) or g + 8.
template <int D>
__device__ __forceinline__ void tile_scores(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                            const uint16_t* Ks, const int* valid_s, int k0,
                                            int g, int c, float scale) {
  constexpr int PITCH = D + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const uint16_t* kr = &Ks[(k0 + j * 8 + g) * PITCH + 2 * c];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      mma_16816(s[j], qf[kk], ld32(kr + kk * 16), ld32(kr + kk * 16 + 8));
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = valid_s[k0 + j * 8 + 2 * c + (e & 1)];
      s[j][e] = ok ? s[j][e] * scale : MASK_VALUE;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
window_attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v, const int* __restrict__ seg,
                        uint16_t* __restrict__ out, int W, int H, float scale) {
  constexpr int PITCH = D + 8;  // smem row pitch in halfwords: conflict-free fragments
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* Ks = reinterpret_cast<uint16_t*>(smem);
  uint16_t* Vs = Ks + (size_t)W * PITCH;
  int* valid_s = reinterpret_cast<int*>(Vs + (size_t)W * PITCH);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // mma fragment row group / column pair
  const int h = blockIdx.x, w = blockIdx.y;
  const size_t pitch = (size_t)H * D;  // elements between consecutive tokens
  const size_t base = (size_t)w * W * pitch + (size_t)h * D;

  for (int i = tid; i < W * (D / 8); i += NUM_THREADS) {
    const int row = i / (D / 8), ch = i % (D / 8);
    const size_t src = base + row * pitch + ch * 8;
    *reinterpret_cast<uint4*>(&Ks[row * PITCH + ch * 8]) =
        *reinterpret_cast<const uint4*>(k + src);
    *reinterpret_cast<uint4*>(&Vs[row * PITCH + ch * 8]) =
        *reinterpret_cast<const uint4*>(v + src);
  }
  for (int i = tid; i < W; i += NUM_THREADS) valid_s[i] = seg[(size_t)w * W + i] >= 0;
  __syncthreads();

  for (int mt = warp; mt < W / 16; mt += NUM_THREADS / 32) {
    const int r0 = mt * 16 + g, r1 = r0 + 8;
    const uint16_t* q0 = q + base + r0 * pitch;
    const uint16_t* q1 = q + base + r1 * pitch;
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + 2 * c;
      qf[kk][0] = ld32(q0 + col);
      qf[kk][1] = ld32(q1 + col);
      qf[kk][2] = ld32(q0 + col + 8);
      qf[kk][3] = ld32(q1 + col + 8);
    }

    // Pass 1: the row max over every key.
    float m0 = -INFINITY, m1 = -INFINITY;
    for (int k0 = 0; k0 < W; k0 += KEY_TILE) {
      float s[8][4];
      tile_scores<D>(s, qf, Ks, valid_s, k0, g, c, scale);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);

    // Pass 2: p against the final max, l from the float32 p, O += bf16(p) V.
    float o[D / 8][4];
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.f;
    float l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 < W; k0 += KEY_TILE) {
      float s[8][4];
      tile_scores<D>(s, qf, Ks, valid_s, k0, g, c, scale);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = expf(s[j][0] - m0);
        s[j][1] = expf(s[j][1] - m0);
        s[j][2] = expf(s[j][2] - m1);
        s[j][3] = expf(s[j][3] - m1);
        l0 += s[j][0] + s[j][1];
        l1 += s[j][2] + s[j][3];
      }
      // The S accumulators of n-tiles 2t, 2t+1 are the A fragment of the
      // 16-key k-step t.
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const uint32_t pa[4] = {
            pack_bf16(s[2 * t][0], s[2 * t][1]), pack_bf16(s[2 * t][2], s[2 * t][3]),
            pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
            pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
        const uint16_t* vr = &Vs[(k0 + t * 16 + 2 * c) * PITCH + g];
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd) {
          const uint16_t* p = vr + nd * 8;
          const uint32_t b0 = (uint32_t)p[0] | ((uint32_t)p[PITCH] << 16);
          const uint32_t b1 = (uint32_t)p[8 * PITCH] | ((uint32_t)p[9 * PITCH] << 16);
          mma_16816(o[nd], pa, b0, b1);
        }
      }
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);

    uint16_t* o0 = out + base + r0 * pitch;
    uint16_t* o1 = out + base + r1 * pitch;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      const int col = nd * 8 + 2 * c;
      *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(o[nd][0] / l0, o[nd][1] / l0);
      *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(o[nd][2] / l1, o[nd][3] / l1);
    }
  }
}

template <int D>
int launch(const uint16_t* q, const uint16_t* k, const uint16_t* v, const int* seg,
           uint16_t* out, int nw, int W, int H, float scale, cudaStream_t st) {
  const size_t smem = 2 * (size_t)W * (D + 8) * sizeof(uint16_t) + W * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_kernel<D><<<dim3(H, nw), NUM_THREADS, smem, st>>>(q, k, v, seg, out, W, H,
                                                                     scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dots_window_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* seg, void* out, int nw, int W, int H,
                                          int D, float sm_scale, void* stream) {
  if (W % KEY_TILE != 0 || W > 256) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* sp = static_cast<const int*>(seg);
  auto* op = static_cast<uint16_t*>(out);
  if (D == 128) return launch<128>(qp, kp, vp, sp, op, nw, W, H, sm_scale, st);
  if (D == 64) return launch<64>(qp, kp, vp, sp, op, nw, W, H, sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
