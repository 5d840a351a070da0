// Seeded Gumbel-max draw for Hopper (sm_90a): threefry2x32 bits, Gumbel
// noise and a row argmax in one launch, float32 logits in, int64 tokens out.
//
// No Pallas kernel to replace: on the TPU, XLA fuses the same function into
// the sampling program (dots_ocr_tpu/engine/sampling.py: _categorical, i.e.
// jax.random.categorical with jax_threefry_partitionable=True). Per row b
// and column j of logits [B, V]:
//   bits = y0 ^ y1 of threefry2x32(key, (0, counter)), counter = j for a
//          key per row, b * V + j for one key shared by every row;
//   u    = max(tiny, (top 23 bits as a float in [1, 2)) - 1 + tiny);
//   g    = -log(-log(u));
//   token[b] = argmax_j (g + logits[b, j] / t[b])  (t = 1 without temps)
// with ties to the lowest index, as jnp.argmax. -inf logits never win over
// a finite value; a row of only -inf gives 0.
//
// Exactness: logf (not __logf), IEEE division, and no --use_fast_math, so
// the kernel equals its plain PyTorch version (ops/sampling.py) bit for
// bit on the card: the same float32 operations in the same order.
//
// What bounds it on this card: at [64, 151,936] the kernel reads 38.9 MB of
// logits (11.6 us at 3.35 TB/s) and does ~90 scalar operations a column
// (20 threefry rounds of add, rotate and xor, 5 key injections, the
// uniform, two logf, the add and the compare): 0.87 G operations, 13 us at
// the card's 67 T/s float32 rate. Integer operations issue at half that
// rate, so the operations bound it.
//
// What the design does about it: a simple two-pass kernel. Pass 1: a
// 256-thread block per (row, 8,192-column range) walks its columns with a
// stride of one block (coalesced logits reads), keeps a running (value,
// index) per thread in registers, and reduces it over the block with warp
// shuffles: nothing but the logits read and one partial a block written.
// Pass 2: one warp per row merges the row's partials. The Gumbel noise is
// written only when the caller asks for it (the check against the plain
// version).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int COLS_PER_BLOCK = 8192;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// threefry2x32, 20 rounds (Random123's rotation constants and key
// schedule, as jax.random runs it): the xor of the two output words.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t c_hi,
                                                  uint32_t c_lo) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c_hi + k0, x1 = c_lo + k1;
#define DOTS_TF_ROUND(r) \
  x0 += x1;              \
  x1 = rotl(x1, r);      \
  x1 ^= x0;
#define DOTS_TF_ROUNDS_A DOTS_TF_ROUND(13) DOTS_TF_ROUND(15) DOTS_TF_ROUND(26) DOTS_TF_ROUND(6)
#define DOTS_TF_ROUNDS_B DOTS_TF_ROUND(17) DOTS_TF_ROUND(29) DOTS_TF_ROUND(16) DOTS_TF_ROUND(24)
  DOTS_TF_ROUNDS_A x0 += k1; x1 += k2 + 1u;
  DOTS_TF_ROUNDS_B x0 += k2; x1 += k0 + 2u;
  DOTS_TF_ROUNDS_A x0 += k0; x1 += k1 + 3u;
  DOTS_TF_ROUNDS_B x0 += k1; x1 += k2 + 4u;
  DOTS_TF_ROUNDS_A x0 += k2; x1 += k0 + 5u;
#undef DOTS_TF_ROUNDS_B
#undef DOTS_TF_ROUNDS_A
#undef DOTS_TF_ROUND
  return x0 ^ x1;
}

// jax.random.gumbel (mode "low") from one word of bits.
__device__ __forceinline__ float gumbel_from_bits(uint32_t bits) {
  const float mant = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  // uniform(minval=tiny, maxval=1): mant * (1 - tiny) + tiny, and 1 - tiny
  // rounds to 1.0f, so the product is exact and one rounded add remains.
  const float u = fmaxf(FLT_MIN, __fadd_rn(mant, FLT_MIN));
  return -logf(-logf(u));
}

// (value, index) order of the argmax: larger value, then lower index.
__device__ __forceinline__ void merge(float& best, int& idx, float v, int i) {
  if (v > best || (v == best && i < idx)) {
    best = v;
    idx = i;
  }
}

__device__ __forceinline__ void warp_merge(float& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, best, off);
    const int i = __shfl_down_sync(0xffffffffu, idx, off);
    merge(best, idx, v, i);
  }
}

__global__ void __launch_bounds__(THREADS)
    gumbel_argmax_partial(const float* __restrict__ logits, const float* __restrict__ temps,
                          const uint32_t* __restrict__ keys, float* __restrict__ noise_out,
                          float* __restrict__ part_val, int* __restrict__ part_idx, int V,
                          int per_row) {
  const int row = blockIdx.y;
  const int blk = blockIdx.x;
  const uint32_t k0 = keys[per_row ? 2 * row : 0];
  const uint32_t k1 = keys[per_row ? 2 * row + 1 : 1];
  const float t = temps != nullptr ? temps[row] : 1.0f;
  const float* x = logits + static_cast<size_t>(row) * V;
  float* noise = noise_out != nullptr ? noise_out + static_cast<size_t>(row) * V : nullptr;
  // The wrapper checks B * V < 2^32, so the flat counter's high word is 0.
  const uint32_t base = per_row ? 0u : static_cast<uint32_t>(row) * static_cast<uint32_t>(V);
  const int c1 = min(V, (blk + 1) * COLS_PER_BLOCK);
  float best = -INFINITY;
  int idx = INT_MAX;
  for (int j = blk * COLS_PER_BLOCK + threadIdx.x; j < c1; j += THREADS) {
    const float g = gumbel_from_bits(threefry_bits(k0, k1, 0u, base + static_cast<uint32_t>(j)));
    if (noise != nullptr) noise[j] = g;
    const float xv = temps != nullptr ? x[j] / t : x[j];
    merge(best, idx, g + xv, j);
  }
  warp_merge(best, idx);
  __shared__ float s_val[THREADS / 32];
  __shared__ int s_idx[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < THREADS / 32 ? s_val[lane] : -INFINITY;
    idx = lane < THREADS / 32 ? s_idx[lane] : INT_MAX;
    warp_merge(best, idx);
    if (lane == 0) {
      part_val[row * gridDim.x + blk] = best;
      part_idx[row * gridDim.x + blk] = idx;
    }
  }
}

__global__ void __launch_bounds__(32)
    gumbel_argmax_final(const float* __restrict__ part_val, const int* __restrict__ part_idx,
                        long long* __restrict__ out, int nblk) {
  const int row = blockIdx.x;
  float best = -INFINITY;
  int idx = INT_MAX;
  for (int b = threadIdx.x; b < nblk; b += 32) {
    merge(best, idx, part_val[row * nblk + b], part_idx[row * nblk + b]);
  }
  warp_merge(best, idx);
  if (threadIdx.x == 0) out[row] = idx == INT_MAX ? 0 : idx;
}

}  // namespace

// logits [B, V] float32; temps [B] float32 or null; keys uint32 [2] (one
// shared key) or [B, 2] (per_row); noise_out [B, V] float32 or null;
// part_val / part_idx [B, nblk] scratch; out [B] int64. nblk must be
// ceil(V / 8192).
extern "C" int dots_threefry_gumbel_argmax(const void* logits, const void* temps, const void* keys,
                                           void* noise_out, void* part_val, void* part_idx,
                                           void* out, int B, int V, int per_row, int nblk,
                                           void* stream) {
  if (B <= 0 || V <= 0 || nblk != (V + COLS_PER_BLOCK - 1) / COLS_PER_BLOCK || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gumbel_argmax_partial<<<dim3(nblk, B), THREADS, 0, st>>>(
      static_cast<const float*>(logits), static_cast<const float*>(temps),
      static_cast<const uint32_t*>(keys), static_cast<float*>(noise_out),
      static_cast<float*>(part_val), static_cast<int*>(part_idx), V, per_row);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gumbel_argmax_final<<<B, 32, 0, st>>>(static_cast<const float*>(part_val),
                                        static_cast<const int*>(part_idx),
                                        static_cast<long long*>(out), nblk);
  return static_cast<int>(cudaGetLastError());
}
