// Seeded sampling for Hopper (sm_90a): threefry2x32 over a grid of (key,
// counter) words, and the Gumbel-max draw (threefry bits, Gumbel noise and
// a row argmax) with its rows' key derivation, each in one launch.
//
// No Pallas kernel to replace: on the TPU, XLA fuses the same functions
// into the sampling program (dots_ocr_tpu/engine/sampling.py: _categorical,
// i.e. jax.random.categorical, and the fold_in / split / bits / uniform of
// jax.random with jax_threefry_partitionable=True). Written as eager torch,
// each fold_in is ~150 int64 elementwise operations, and a draw over
// [64, 151,936] logits over a hundred passes of ~78 MB each.
//
// threefry_grid_kernel: out[r, c] from threefry2x32(k0, k1, (x0, x1) (+ c
// with iota, as a 64-bit counter)) with each operand read from its own
// (pointer, row step, column step) or given as a value, as (y0, y1), as
// y0 ^ y1, or as jax.random.uniform's float from those bits. fold_in, split,
// random_bits and uniform (ops/sampling.py) are each one launch of it.
//
// gumbel_argmax_kernel: per row b and column j of logits [B, V]
//   key  = keys[b] (or the one shared key), then fold_in(key, positions[b])
//          when positions are given, then fold_in(key, tag) when tag >= 0,
//          derived in the kernel's prologue (20 threefry rounds a fold);
//   bits = y0 ^ y1 of threefry2x32(key, (0, counter)), counter = j for
//          per-row keys, b * V + j for one key shared by every row;
//   u    = max(tiny, (top 23 bits as a float in [1, 2)) - 1 + tiny);
//   g    = -log(-log(u));
//   token[b] = argmax_j (g + logits[b, j] / t[b])  (t = 1 without temps)
// with ties to the lowest index, as jnp.argmax. -inf logits never win over
// a finite value; a row of only -inf gives 0.
//
// Exactness: logf (not __logf), IEEE division, and no --use_fast_math, so
// the kernels equal their plain PyTorch versions (ops/sampling.py) bit for
// bit on the card: the same float32 operations in the same order.
//
// What bounds the draw on this card: at [64, 151,936] it reads 38.9 MB of
// logits (11.6 us at 3.35 TB/s) and runs, a column, the instructions of
// its main loop: 321 SASS instructions for two columns (chip_smoke.py
// counts them in the built library: the 20 threefry rounds of add, rotate
// and xor, the key injections, the uniform, two accurate logf, the add and
// the compare), 160.5 a column, 46.6 us at one instruction a lane a clock
// (33.5 T/s). The instructions bound it.
//
// What the design does about it: one launch a draw. A row is split over
// the C ranks of a thread block cluster (C from the wrapper's plan: as many
// as give every SM one CTA of 512 threads, at most 8; 2 at 64 rows, the
// fastest in kernel_ab.py's sweep), each rank a contiguous range of
// columns walked with a stride of one block (coalesced logits reads), two
// columns a step so that two independent threefry chains interleave. Each
// rank reduces its range to one (value, index) over warp shuffles; rank 0
// merges the ranks' results in rank order through distributed shared
// memory. The Gumbel noise is written only when the caller asks for it
// (the check against the plain version).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int DRAW_THREADS = 512;
constexpr int DRAW_MAX_CLUSTER = 8;
constexpr int GRID_THREADS = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

// threefry2x32, 20 rounds (Random123's rotation constants and key
// schedule, as jax.random runs it): the two output words.
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1, uint32_t c_hi,
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
  return make_uint2(x0, x1);
}

// jax.random.uniform(minval=lo, maxval=1) from one word of bits: the top
// 23 bits as a mantissa in [1, 2), minus 1, times (1 - lo), plus lo, and
// at least lo (a multiply and an add, each rounded, as the plain version).
__device__ __forceinline__ float uniform_from_bits(uint32_t bits, float lo) {
  const float mant = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, __fadd_rn(__fmul_rn(mant, __fsub_rn(1.0f, lo)), lo));
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

// One operand of threefry_grid_kernel: element (r, c) is
// ptr[r * row_step + c * col_step] (uint32 values held in int64), or
// `value` where ptr is null.
struct Operand {
  const long long* ptr;
  long long row_step, col_step, value;
};

struct GridArgs {
  Operand op[4];  // k0, k1, x0, x1
  void* out;
  int rows, cols, iota, mode;
  float minval;
};

__device__ __forceinline__ uint32_t operand(const Operand& o, long long r, long long c) {
  return static_cast<uint32_t>(o.ptr != nullptr ? o.ptr[r * o.row_step + c * o.col_step]
                                                : o.value);
}

// mode 0: out int64 [rows, cols, 2] = (y0, y1); 1: int64 [rows, cols] =
// y0 ^ y1; 2: float32 [rows, cols] = the uniform of y0 ^ y1 on [minval, 1).
__global__ void __launch_bounds__(GRID_THREADS) threefry_grid_kernel(const GridArgs a) {
  const long long n = static_cast<long long>(a.rows) * a.cols;
  for (long long i = blockIdx.x * static_cast<long long>(GRID_THREADS) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * GRID_THREADS) {
    const long long r = i / a.cols, c = i % a.cols;
    uint32_t x0 = operand(a.op[2], r, c), x1 = operand(a.op[3], r, c);
    if (a.iota) {
      const unsigned long long ctr =
          ((static_cast<unsigned long long>(x0) << 32) | x1) + static_cast<unsigned long long>(c);
      x0 = static_cast<uint32_t>(ctr >> 32);
      x1 = static_cast<uint32_t>(ctr);
    }
    const uint2 y = threefry(operand(a.op[0], r, c), operand(a.op[1], r, c), x0, x1);
    if (a.mode == 0) {
      long long* out = static_cast<long long*>(a.out) + 2 * i;
      out[0] = y.x;
      out[1] = y.y;
    } else if (a.mode == 1) {
      static_cast<long long*>(a.out)[i] = y.x ^ y.y;
    } else {
      static_cast<float*>(a.out)[i] = uniform_from_bits(y.x ^ y.y, a.minval);
    }
  }
}

// grid (C, B), cluster (C, 1, 1): rank r of row b takes the columns
// [r V / C, (r + 1) V / C).
__global__ void __launch_bounds__(DRAW_THREADS, 2)
    gumbel_argmax_kernel(const float* __restrict__ logits, const float* __restrict__ temps,
                         const long long* __restrict__ keys, int key_step,
                         const long long* __restrict__ positions, int tag, int flat,
                         float* __restrict__ noise_out, long long* __restrict__ out, int V) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int row = blockIdx.y;
  uint2 key = make_uint2(static_cast<uint32_t>(keys[key_step * row]),
                         static_cast<uint32_t>(keys[key_step * row + 1]));
  if (positions != nullptr)
    key = threefry(key.x, key.y, 0u, static_cast<uint32_t>(positions[row]));
  if (tag >= 0) key = threefry(key.x, key.y, 0u, static_cast<uint32_t>(tag));
  const uint32_t k0 = key.x, k1 = key.y;
  const float t = temps != nullptr ? temps[row] : 1.0f;
  const float* x = logits + static_cast<size_t>(row) * V;
  float* noise = noise_out != nullptr ? noise_out + static_cast<size_t>(row) * V : nullptr;
  // The wrapper checks B * V < 2^32, so the flat counter's high word is 0.
  const uint32_t base = flat ? static_cast<uint32_t>(row) * static_cast<uint32_t>(V) : 0u;
  const int c0 = static_cast<int>(static_cast<long long>(rank) * V / n_ranks);
  const int c1 = static_cast<int>(static_cast<long long>(rank + 1) * V / n_ranks);
  float best = -INFINITY;
  int idx = INT_MAX;
  int j = c0 + threadIdx.x;
  for (; j + DRAW_THREADS < c1; j += 2 * DRAW_THREADS) {
    const int j1 = j + DRAW_THREADS;
    const uint2 y0 = threefry(k0, k1, 0u, base + static_cast<uint32_t>(j));
    const uint2 y1 = threefry(k0, k1, 0u, base + static_cast<uint32_t>(j1));
    const float g0 = gumbel_from_bits(y0.x ^ y0.y), g1 = gumbel_from_bits(y1.x ^ y1.y);
    if (noise != nullptr) {
      noise[j] = g0;
      noise[j1] = g1;
    }
    const float v0 = temps != nullptr ? x[j] / t : x[j];
    const float v1 = temps != nullptr ? x[j1] / t : x[j1];
    merge(best, idx, g0 + v0, j);
    merge(best, idx, g1 + v1, j1);
  }
  if (j < c1) {
    const uint2 y = threefry(k0, k1, 0u, base + static_cast<uint32_t>(j));
    const float g = gumbel_from_bits(y.x ^ y.y);
    if (noise != nullptr) noise[j] = g;
    merge(best, idx, g + (temps != nullptr ? x[j] / t : x[j]), j);
  }
  warp_merge(best, idx);
  __shared__ float s_val[DRAW_THREADS / 32];
  __shared__ int s_idx[DRAW_THREADS / 32];
  __shared__ float rank_val;
  __shared__ int rank_idx;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < DRAW_THREADS / 32 ? s_val[lane] : -INFINITY;
    idx = lane < DRAW_THREADS / 32 ? s_idx[lane] : INT_MAX;
    warp_merge(best, idx);
    if (lane == 0) {
      rank_val = best;
      rank_idx = idx;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    best = rank_val;
    idx = rank_idx;
    for (int r = 1; r < n_ranks; ++r)
      merge(best, idx, *cluster.map_shared_rank(&rank_val, r), *cluster.map_shared_rank(&rank_idx, r));
    out[row] = idx == INT_MAX ? 0 : idx;
  }
  cluster.sync();  // no rank leaves while rank 0 still reads its result
}

}  // namespace

// logits [B, V] float32; temps [B] float32 or null; keys int64 uint32
// words, [2] (key_step 0) or [B, 2] (key_step 2); positions [B] int64 or
// null; tag >= 0 or -1 (none); flat 1: one shared key counting over the
// flat index (then positions must be null); noise_out [B, V] float32 or
// null; out [B] int64. cluster: the ranks a row is split over (1 to 8).
extern "C" int dots_threefry_gumbel_argmax(const void* logits, const void* temps, const void* keys,
                                           int key_step, const void* positions, int tag, int flat,
                                           void* noise_out, void* out, int B, int V, int cluster,
                                           void* stream) {
  if (B <= 0 || V <= 0 || B > 65535 || cluster < 1 || cluster > DRAW_MAX_CLUSTER ||
      (key_step != 0 && key_step != 2) || (flat && (positions != nullptr || key_step != 0)) ||
      (flat && static_cast<unsigned long long>(B) * V >= (1ull << 32))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(DRAW_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, gumbel_argmax_kernel, static_cast<const float*>(logits),
      static_cast<const float*>(temps), static_cast<const long long*>(keys), key_step,
      static_cast<const long long*>(positions), tag, flat, static_cast<float*>(noise_out),
      static_cast<long long*>(out), V));
}

// operands: 16 int64 on the host, (pointer, row step, column step, value)
// for k0, k1, x0, x1 in turn (pointer 0: the value); out as `mode` says
// (threefry_grid_kernel); rows * cols elements, cols >= 1.
extern "C" int dots_threefry2x32(const long long* operands, void* out, int rows, int cols,
                                 int iota, int mode, float minval, void* stream) {
  if (rows < 0 || cols < 1 || mode < 0 || mode > 2 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  GridArgs a = {};
  for (int o = 0; o < 4; ++o) {
    a.op[o].ptr = reinterpret_cast<const long long*>(operands[4 * o]);
    a.op[o].row_step = operands[4 * o + 1];
    a.op[o].col_step = operands[4 * o + 2];
    a.op[o].value = operands[4 * o + 3];
  }
  a.out = out;
  a.rows = rows;
  a.cols = cols;
  a.iota = iota;
  a.mode = mode;
  a.minval = minval;
  const long long n = static_cast<long long>(rows) * cols;
  const long long blocks = (n + GRID_THREADS - 1) / GRID_THREADS;
  threefry_grid_kernel<<<static_cast<unsigned>(blocks < 1024 ? blocks : 1024), GRID_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
