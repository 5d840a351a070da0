// Multi-query paged decode attention for Hopper (sm_90a): bf16 K/V (split-K
// flash-decoding, below), and int8 K/V with per-token f32 scales (the
// int8 kernel, further below: the same split-K and merge kernel).
//
// Replaces the Pallas kernel dots_ocr_tpu/ops/paged_attention.py:
// paged_attention_multiquery -> _multipage_kernel (the pl.pallas_call at
// line 689); paged_attention_multipage (line 523) is its nq = 1 wrapper.
// Same function: q [B, nq, H, D] against K/V pools
// [KV, num_pages, page_size, D] through page_indices [B, max_pages];
// query j of row b attends tokens < lengths[b] + j; a row with length 0
// outputs exact zeros; GQA maps query head h to KV head h / (H / KV).
//
// What bounds it on this card: decode attention reads every live K/V byte
// once and does ~2 * (H / KV) * nq FLOPs per element read - memory bound
// (the H100's bf16 ridge is ~295 FLOP/byte). The time floor is the live
// K/V bytes over 3.35 TB/s, so nothing past a row's live length may be
// read: the page table is padded with the null page to a static width.
//
// bf16 mode, what the design does about it:
// (a) Split-K over the token axis (flash-decoding). The grid is (split,
//     KV head, slot); split s of a row covers tokens [s * chunk,
//     (s + 1) * chunk), chunk a multiple of 64 chosen by the wrapper from
//     static shapes only (batch, KV heads, rows, head_dim, the table's
//     max_pages * page_size and the SM count: paged_split_plan in
//     ops/paged_attention.py), so the decode step never syncs with the
//     host. A block whose range starts past its row's n_tok exits at once;
//     the others write float32 partials (m, l in the base-2 domain, and the
//     unnormalized O) to scratch, and paged_merge_kernel, launched right
//     after on the same stream, merges a row's live splits by log-sum-exp
//     and writes bf16 (a row of length 0 gets exact zeros). Scratch at the
//     shipping geometry (64 slots, 2 KV heads, 12 heads, table width 320 x
//     page 128, nq = 3, D = 128): 28 splits of 1,472 tokens, 28 x 64 x 2 x
//     18 rows x 130 floats = 33.5 MB (32 MiB, the plan's budget); nq = 1:
//     the same 28 splits (the plan's cap on the grid), 11.2 MB.
// (b) Tensor cores: mma.sync m16n8k16 bf16 -> f32. The block's G * nq
//     <= 24 query rows are the A operand, padded with zero rows to 16 or
//     32 (MT m16 tiles); K and V fragments come from shared memory through
//     ldmatrix and ldmatrix.trans; P is re-packed as bf16 from the S
//     accumulators (no score buffer in shared memory). Not wgmma: wgmma
//     takes 64 query rows per warpgroup, and a block here has at most 24,
//     so 62-90% of its work would be padding on a memory-bound kernel.
// (c) Each of the block's 4 warps walks its own 16-token tiles of the
//     block's range (tile i of warp w starts at 16 (4 i + w)) through its
//     own three-stage cp.async ring (16-byte copies gathered through the
//     page table; a D = 128 token row is 256 contiguous bytes), so loads
//     run two tiles ahead of the products and no block barrier is taken
//     per tile; the four warps' (m, l, O) merge once, in shared memory, at
//     the end. Positions past n_tok are zero-filled in shared memory (an
//     unwritten slot may hold NaN, and 0 * NaN is NaN inside an mma), and
//     table entries past a row's end are never read. Shared rows are
//     padded by 16 bytes, so ldmatrix's 8 rows hit distinct banks.
// Registers (nvcc -Xptxas -v, sm_90a): 228 a thread at D = 128 with 32
// query rows, 128 with 16 (D = 64: 128 / 80), no spills; 113 KB of dynamic
// shared memory at D = 128, so two 128-thread blocks per SM. The merge
// kernel: 40 registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_merge.cuh"

namespace {

constexpr int NUM_THREADS = 128;
constexpr int MAX_ROWS = 24;  // (H / KV) * nq query rows per block
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
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
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int SPLIT_STEP = 16;  // tokens per warp tile
constexpr int SPLIT_WARPS = NUM_THREADS / 32;
constexpr int SPLIT_STAGES = 3;

template <int D>
struct SplitSmem {
  static constexpr int PITCH = D * 2 + 16;  // bytes per shared row
  static constexpr int SLOT = SPLIT_STEP * PITCH;
  static constexpr int Q = 32 * PITCH;  // up to 32 query rows
  static constexpr int RING = SPLIT_STAGES * 2 * SLOT;  // per warp
  static constexpr int BYTES = Q + SPLIT_WARPS * RING;
};

template <int D, int MT>
__global__ void __launch_bounds__(NUM_THREADS)
paged_decode_split_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k_pool,
                          const uint16_t* __restrict__ v_pool, const int* __restrict__ lengths,
                          const int* __restrict__ page_indices, float* __restrict__ part_o,
                          float* __restrict__ part_ml, int nq, int H, int KV, int num_slots,
                          int page_size, int max_pages, int chunk, int n_split,
                          float scale_log2) {
  using L = SplitSmem<D>;
  constexpr int CH = D / 8;  // 16-byte chunks per token row
  constexpr int ROWS = 16 * MT;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  // Tokens the furthest query can see, capped at the table's capacity.
  const int n_tok = len > 0 ? min(len + nq - 1, max_pages * page_size) : 0;
  const int t_begin = split * chunk;
  if (t_begin >= n_tok) return;  // the merge reads only live splits
  const int t_end = min(t_begin + chunk, n_tok);
  const int G = H / KV;
  const int R = G * nq;  // row r = g * nq + j serves query head kvh * G + g, query j
  const int* table = page_indices + (size_t)b * max_pages;
  const size_t head_base = (size_t)kvh * num_slots;

  uint8_t* Qs = smem;
  for (int i = tid; i < ROWS * CH; i += NUM_THREADS) {
    const int r = i / CH, ch = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      const int gh = r / nq, j = r % nq;
      val = *reinterpret_cast<const uint4*>(q + (((size_t)b * nq + j) * H + kvh * G + gh) * D +
                                            ch * 8);
    }
    *reinterpret_cast<uint4*>(Qs + r * L::PITCH + ch * 16) = val;
  }
  __syncthreads();

  const uint32_t qs = smem_u32(Qs);
  const uint32_t ring = smem_u32(smem + L::Q + warp * L::RING);
  const int span = t_end - t_begin - warp * SPLIT_STEP;
  constexpr int STRIDE = SPLIT_WARPS * SPLIT_STEP;  // tokens between a warp's tiles
  const int n_steps = span > 0 ? (span + STRIDE - 1) / STRIDE : 0;

  auto load = [&](int step, int stage) {
    const int t0 = t_begin + (step * SPLIT_WARPS + warp) * SPLIT_STEP;
    const uint32_t ks = ring + stage * 2 * L::SLOT, vs = ks + L::SLOT;
#pragma unroll
    for (int i = lane; i < SPLIT_STEP * CH; i += 32) {
      const int row = i / CH, ch = i % CH;
      const int pos = t0 + row;
      const bool ok = pos < t_end;
      size_t off = 0;
      if (ok) {
        const size_t slot = (size_t)table[pos / page_size] * page_size + pos % page_size;
        off = (head_base + slot) * D + ch * 8;
      }
      cp_async16(ks + row * L::PITCH + ch * 16, k_pool + off, ok);
      cp_async16(vs + row * L::PITCH + ch * 16, v_pool + off, ok);
    }
  };

  // This thread's rows: mt * 16 + g (+ 8); the last position each may see.
  int limit[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + hf * 8;
      limit[mt][hf] = r < R ? min(len + r % nq, t_end) : 0;  // query j sees tokens < len + j
    }
  float o[MT][D / 8][4];
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nd][e] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < SPLIT_STAGES - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  const int mat = lane >> 3;
  for (int step = 0; step < n_steps; ++step) {
    if (step + SPLIT_STAGES - 1 < n_steps)
      load(step + SPLIT_STAGES - 1, (step + SPLIT_STAGES - 1) % SPLIT_STAGES);
    cp_async_commit();
    cp_async_wait<SPLIT_STAGES - 1>();
    __syncwarp();
    const int t0 = t_begin + (step * SPLIT_WARPS + warp) * SPLIT_STEP;
    const uint32_t ks = ring + (step % SPLIT_STAGES) * 2 * L::SLOT, vs = ks + L::SLOT;

    // S = Q K^T: MT m16 tiles x 2 n8 tiles (16 tokens).
    float sc[MT][2][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[mt][nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, ks + (((mat >> 1) << 3) + (lane & 7)) * L::PITCH + (2 * kk + (mat & 1)) * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t qa[4];
        ldsm_x4(qa, qs + (mt * 16 + ((mat & 1) << 3) + (lane & 7)) * L::PITCH +
                        (2 * kk + (mat >> 1)) * 16);
        mma_bf16(sc[mt][0], qa, bk[0], bk[1]);
        mma_bf16(sc[mt][1], qa, bk[2], bk[3]);
      }
    }

    // Online softmax in the base-2 domain; P re-packed as the A fragment.
    uint32_t pa[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = t0 + nt * 8 + 2 * c + (e & 1);
          const float x = tok < limit[mt][e >> 1] ? sc[mt][nt][e] * scale_log2 : MASK_VALUE;
          sc[mt][nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float mn = fmaxf(m[mt][hf], quad_max(mx[hf]));
        alpha[hf] = exp2f(m[mt][hf] - mn);  // 0 on the first tile
        m[mt][hf] = mn;
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int tok = t0 + nt * 8 + 2 * c + (e & 1);
          const float p = tok < limit[mt][e >> 1] ? exp2f(sc[mt][nt][e] - m[mt][e >> 1]) : 0.f;
          sc[mt][nt][e] = p;
          rs[e >> 1] += p;
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[mt][hf] = l[mt][hf] * alpha[hf] + quad_sum(rs[hf]);
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd) {
        o[mt][nd][0] *= alpha[0];
        o[mt][nd][1] *= alpha[0];
        o[mt][nd][2] *= alpha[1];
        o[mt][nd][3] *= alpha[1];
      }
      pa[mt][0] = pack_bf16(sc[mt][0][0], sc[mt][0][1]);
      pa[mt][1] = pack_bf16(sc[mt][0][2], sc[mt][0][3]);
      pa[mt][2] = pack_bf16(sc[mt][1][0], sc[mt][1][1]);
      pa[mt][3] = pack_bf16(sc[mt][1][2], sc[mt][1][3]);
    }

    // O += P V: V fragments through ldmatrix.trans, two n8 tiles at a time.
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vs + (((mat & 1) << 3) + (lane & 7)) * L::PITCH + (2 * np + (mat >> 1)) * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(o[mt][2 * np], pa[mt], bv[0], bv[1]);
        mma_bf16(o[mt][2 * np + 1], pa[mt], bv[2], bv[3]);
      }
    }
    __syncwarp();  // this slot is refilled SPLIT_STAGES - 1 tiles on
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: reuse them to merge the warps

  float* wm = reinterpret_cast<float*>(smem + L::Q);  // [warp][ROWS]
  float* wl = wm + SPLIT_WARPS * ROWS;
  float* acc = wl + SPLIT_WARPS * ROWS;  // [ROWS][D]
  if (c == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + g + hf * 8;
        wm[warp * ROWS + r] = m[mt][hf];
        wl[warp * ROWS + r] = l[mt][hf];
      }
  }
  __syncthreads();
  float f[MT][2];  // this warp's weight in the block's sum
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = mt * 16 + g + hf * 8;
      float mb = -INFINITY;
#pragma unroll
      for (int w = 0; w < SPLIT_WARPS; ++w) mb = fmaxf(mb, wm[w * ROWS + r]);
      f[mt][hf] = m[mt][hf] == -INFINITY ? 0.f : exp2f(m[mt][hf] - mb);
    }
  for (int w = 0; w < SPLIT_WARPS; ++w) {  // in warp order: a fixed summation order
    if (warp == w) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + g + (e >> 1) * 8;
            float* dst = acc + r * D + nd * 8 + 2 * c + (e & 1);
            const float x = o[mt][nd][e] * f[mt][e >> 1];
            *dst = w == 0 ? x : *dst + x;
          }
    }
    __syncthreads();
  }
  const size_t row0 = (((size_t)b * KV + kvh) * n_split + split) * R;
  for (int i = tid; i < R * D; i += NUM_THREADS) part_o[row0 * D + i] = acc[i];
  for (int r = tid; r < R; r += NUM_THREADS) {
    float mb = -INFINITY;
    for (int w = 0; w < SPLIT_WARPS; ++w) mb = fmaxf(mb, wm[w * ROWS + r]);
    float lb = 0.f;
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float mw = wm[w * ROWS + r];
      lb += mw == -INFINITY ? 0.f : wl[w * ROWS + r] * exp2f(mw - mb);
    }
    part_ml[(row0 + r) * 2] = mb;
    part_ml[(row0 + r) * 2 + 1] = lb;
  }
}

template <int D, int MT>
int launch_split(const void* q, const void* k_pool, const void* v_pool, const void* lengths,
                 const void* page_indices, float* part_o, float* part_ml, int B, int nq, int H,
                 int KV, int num_slots, int page_size, int max_pages, int chunk, int n_split,
                 float scale_log2, cudaStream_t st) {
  auto kernel = paged_decode_split_kernel<D, MT>;
  constexpr int smem = SplitSmem<D>::BYTES;
  static_assert(SplitSmem<D>::RING * SPLIT_WARPS >= 2 * SPLIT_WARPS * 32 * 4 + 32 * D * 4,
                "the merge area must fit in the rings");
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_split, KV, B), NUM_THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k_pool),
      static_cast<const uint16_t*>(v_pool), static_cast<const int*>(lengths),
      static_cast<const int*>(page_indices), part_o, part_ml, nq, H, KV, num_slots, page_size,
      max_pages, chunk, n_split, scale_log2);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// int8 mode: the Pallas body's quantized path (paged_attention.py:400-509),
// in the bf16 mode's shape.
//
// Same function and masking as above, with int8 pools and f32 scales
// [KV, num_pages, page_size] (the flat per-layer scale vector viewed as
// pages). Each query row is quantized to int8 once (qs = amax / 127, or 1);
// S = int32(q_i8 . k_i8) * qs[row] * ks[token] * sm_scale; online softmax
// in the natural-exp domain as the plain version computes it; P is scaled
// by vs[token], re-quantized to int8 per row over the tile (pscale =
// amax / 127, or 1), and O += int32(P_i8 . V_i8) * pscale after the alpha
// rescale. The re-quantization depends on the tile (INT8_TILE tokens here,
// 512 in the Pallas kernel); the plain PyTorch version takes the tile
// length, the split and the number of tile walkers that share a split, so
// on the card kernel and plain agree up to the softmax denominator's
// summation order (f32 ops are issued with __fmul_rn / __fadd_rn so nvcc
// contracts none of them into an FMA the plain version does not have).
//
// What bounds it: the same live-K/V read as the bf16 mode at half the
// bytes (the capacity mode's point); in practice the float32 softmax and
// re-quantization (an exp, a division and six roundings a score), a long
// dependent chain a warp cannot hide alone. What the design does about it:
// (a) The bf16 mode's split-K: grid (split, KV head, slot) over the same
//     static plan, a block past its row's end exits at once, float32
//     partials (m, l in the natural-exp domain, unnormalized O) go to the
//     caller's scratch and paged_merge_kernel<false> merges them. Splits
//     start on multiples of 64 = INT8_TILE, so P is re-quantized over the
//     same 64-token tiles whatever the split.
// (b) Rows over warps, tiles over groups. A group of WT = ceil(rows / 8)
//     warps walks its own 64-token tiles (group i of a block's n takes
//     tiles i, i + n, ...); warp w of the group owns query rows 8w .. 8w + 7
//     for ALL 64 tokens of the tile, so the row max, the row sum and the
//     row's pamax are quad shuffles and no warp waits on another's rows; a
//     verify step's 18 rows take three warps side by side where one warp
//     walking three row groups in turn took three times a decode step's
//     time. Each group has its own (m, l, O) per row and one K tile and one
//     V tile with their scales in shared memory (cp.async, gathered through
//     the page table; 16-byte copies, zero-filled past the row's live span,
//     scales included, so a masked probability never meets a scale; table
//     entries past a row's end are never read). The next K tile is
//     requested as soon as this one's scores are scaled and lands during
//     the softmax and P V; the next V tile is requested after P V and lands
//     during the next Q K^T. A group of several warps meets at a named
//     barrier around those two requests; the groups' states merge once at
//     the end, in shared memory, in group order.
// (c) Both products on mma.sync m16n8k32 s8 x s8 -> s32, the scores never
//     leaving registers (the m16 tile's upper 8 rows are another warp's
//     rows or zeros: their products are dropped). Q and K come through
//     ldmatrix as they lie. V lies [token][D] and the second product wants
//     four consecutive tokens of one column in a register; ldmatrix.trans
//     moves 16-bit units, so it delivers two tokens x two columns, and two
//     prmt turn a pair of such registers into the fragments of an even and
//     an odd column. The product sums over tokens, so the ORDER of tokens
//     inside a 32-token step is free: it is chosen so that the S
//     accumulators a thread already holds (n-tiles 4u .. 4u + 3) are, after
//     softmax and re-quantization, exactly its A fragment of step u. No
//     byte stores, no score buffer, no transposed copy of V.
// (d) P's re-quantization divides 16 values a thread by the row's pscale:
//     one correctly rounded reciprocal, then q = x r corrected by two
//     FMAs (q += (x - pscale q) r), which is the quotient's correct
//     rounding as a true division gives it.
// Shared rows are padded by 16 bytes, so ldmatrix's 8 rows hit distinct
// banks. Per group 18.5 KB at D = 128; a block is 4 groups of one warp
// (79 KB, two blocks an SM: 8 tiles in flight) or 2 groups of two or three
// warps (42 KB; registers capped for 4 and 3 blocks an SM: 8 and 6 tiles).
// Registers (nvcc -Xptxas -v, sm_90a, D = 128): 150 a thread with one warp
// a group, no spills; capped at 128 / 96 with two / three (156 / 76 bytes
// spilled). More tiles in flight beat fewer spills: uncapped (150
// registers, 4 tiles an SM) the verify step took 12% longer.

constexpr int INT8_TILE = 64;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes, of which the first src_bytes come from src and the rest are zero.
__device__ __forceinline__ void cp_async16_part(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ uint32_t pack_s8(int b0, int b1, int b2, int b3) {
  return (uint32_t)(b0 & 0xff) | ((uint32_t)(b1 & 0xff) << 8) | ((uint32_t)(b2 & 0xff) << 16) |
         ((uint32_t)(b3 & 0xff) << 24);
}

// WT warps a group (8 query rows each), GROUPS groups a block.
template <int D, int WT>
struct Int8Smem {
  static constexpr int GROUPS = WT == 1 ? 4 : 2;
  static constexpr int THREADS = GROUPS * WT * 32;
  // Blocks an SM should hold (registers are capped to allow it): 8 groups of
  // one warp, 8 of two, 6 of three in flight.
  static constexpr int MIN_BLOCKS = WT == 1 ? 2 : (WT == 2 ? 4 : 3);
  static constexpr int PITCH = D + 16;               // bytes per Q / K / V row
  static constexpr int KV_TILE = INT8_TILE * PITCH;  // one K or V tile
  static constexpr int SCALES = 2 * KV_TILE;         // k scales, then v scales
  static constexpr int GROUP = 2 * KV_TILE + 2 * INT8_TILE * 4;  // one group's K, V, scales
  static constexpr int Q = 32 * PITCH + 32 * 4;      // int8 query rows, their scales
  static constexpr int BYTES = Q + GROUPS * GROUP;
};

// Barrier of one group's warps (named barrier 1 + group; a warp alone syncs itself).
template <int WT>
__device__ __forceinline__ void group_sync(int group) {
  if (WT == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(WT * 32) : "memory");
  }
}

template <int D, int WT>
__global__ void __launch_bounds__(Int8Smem<D, WT>::THREADS, Int8Smem<D, WT>::MIN_BLOCKS)
paged_decode_int8_split_kernel(const uint16_t* __restrict__ q, const int8_t* __restrict__ k_pool,
                               const int8_t* __restrict__ v_pool,
                               const float* __restrict__ k_scale,
                               const float* __restrict__ v_scale, const int* __restrict__ lengths,
                               const int* __restrict__ page_indices, float* __restrict__ part_o,
                               float* __restrict__ part_ml, int nq, int H, int KV, int num_slots,
                               int page_size, int max_pages, int chunk, int n_split,
                               float sm_scale) {
  using L = Int8Smem<D, WT>;
  constexpr int T = INT8_TILE;
  constexpr int CH = D / 16;  // 16-byte chunks per token row
  constexpr int GROUPS = L::GROUPS, THREADS = L::THREADS;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = warp / WT, wr = warp % WT;   // group, warp in the group
  const int gt = tid - grp * WT * 32;          // thread in the group
  const int g = lane >> 2, c = lane & 3;       // mma groupID, thread in group
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, row within it
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = lengths[b];
  const int n_tok = len > 0 ? min(len + nq - 1, max_pages * page_size) : 0;
  const int t_begin = split * chunk;
  if (t_begin >= n_tok) return;  // the merge reads only live splits
  const int t_end = min(t_begin + chunk, n_tok);
  const int G = H / KV;
  const int R = G * nq;  // row r = g * nq + j serves query head kvh * G + g, query j
  const int* table = page_indices + (size_t)b * max_pages;
  const size_t head_base = (size_t)kvh * num_slots;

  int8_t* Qs = reinterpret_cast<int8_t*>(smem);
  float* qs_s = reinterpret_cast<float*>(smem + 32 * L::PITCH);
  const uint32_t qsm = smem_u32(Qs);
  uint8_t* buf_p = smem + L::Q + grp * L::GROUP;
  const uint32_t ks = smem_u32(buf_p), vs = ks + L::KV_TILE;
  const float* ksc = reinterpret_cast<const float*>(buf_p + L::SCALES);
  const float* vsc = ksc + T;
  const int span = t_end - t_begin - grp * T;
  constexpr int STRIDE = GROUPS * T;  // tokens between a group's tiles
  const int n_steps = span > 0 ? (span + STRIDE - 1) / STRIDE : 0;
  const bool one_page = page_size % T == 0;

  // One tile of K (with K's scales) or of V (with V's) into the group's
  // buffer, the group's threads sharing the copies.
  auto load = [&](int step, bool is_v) {
    const int t0 = t_begin + (step * GROUPS + grp) * T;
    const int8_t* pool = is_v ? v_pool : k_pool;
    const uint32_t dst = is_v ? vs : ks;
    // Pages of whole tiles (the shipping 128): one table entry a tile.
    const size_t tile_slot =
        one_page ? (size_t)table[t0 / page_size] * page_size + t0 % page_size : 0;
    for (int i = gt; i < T * CH; i += WT * 32) {
      const int row = i / CH, ch = i % CH;
      const int pos = t0 + row;
      const bool ok = pos < t_end;
      size_t off = 0;
      if (ok) {
        const size_t slot = one_page ? tile_slot + row
                                     : (size_t)table[pos / page_size] * page_size + pos % page_size;
        off = (head_base + slot) * D + ch * 16;
      }
      cp_async16(dst + row * L::PITCH + ch * 16, pool + off, ok);
    }
    // The tile's scales, four tokens (one page: page_size % 4 == 0) a copy.
    if (gt < T / 4) {
      const int j4 = gt * 4, pos = t0 + j4;
      const int n_ok = max(0, min(4, t_end - pos));
      size_t off = 0;
      if (n_ok > 0)
        off = head_base + (one_page ? tile_slot + j4
                                    : (size_t)table[pos / page_size] * page_size + pos % page_size);
      cp_async16_part(ks + L::SCALES + (is_v ? T * 4 : 0) + j4 * 4,
                      (is_v ? v_scale : k_scale) + off, n_ok * 4);
    }
  };

  // Two cp.async groups are pending at the top of every step, K's then
  // V's, and one group is committed at each of the two refill points
  // whether or not a tile is left, so "all but the newest" is always the
  // tile needed next.
  if (n_steps > 0) load(0, false);
  cp_async_commit();
  if (n_steps > 0) load(0, true);
  cp_async_commit();

  // Quantize each query row once: one warp per row, D / 32 values a lane,
  // a warp's rows loaded together. Rows >= R stay zero. (The first K and V
  // tiles are already on their way.)
  for (int i = tid; i < L::Q / 4; i += THREADS) reinterpret_cast<uint32_t*>(smem)[i] = 0u;
  __syncthreads();
  {
    constexpr int WARPS = THREADS / 32, ROUNDS = (MAX_ROWS + WARPS - 1) / WARPS;
    float x[ROUNDS][D / 32];
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      const int r = warp + i * WARPS;
      const uint16_t* qr = q + (((size_t)b * nq + r % nq) * H + kvh * G + r / nq) * D;
#pragma unroll
      for (int e = 0; e < D / 32; ++e)
        x[i][e] = r < R ? __uint_as_float((uint32_t)qr[lane + 32 * e] << 16) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      const int r = warp + i * WARPS;
      if (r >= R) break;  // uniform across the warp
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e) amax = fmaxf(amax, fabsf(x[i][e]));
      amax = warp_max(amax);
      const float qs = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
#pragma unroll
      for (int e = 0; e < D / 32; ++e)
        Qs[r * L::PITCH + lane + 32 * e] = (int8_t)__float2int_rn(__fdiv_rn(x[i][e], qs));
      if (lane == 0) qs_s[r] = qs;
    }
  }
  __syncthreads();

  // This thread's row: 8 wr + g (rows g + 8 of the warp's m16 tile belong
  // to the next warp or are zero, and are dropped); the last position it
  // may see and its query scale.
  const int row = 8 * wr + g;
  const int limit = row < R ? min(len + row % nq, t_end) : 0;  // query j sees tokens < len + j
  const float qsr = row < R ? qs_s[row] : 0.f;
  // acc[dc][i]: column 16 dc + 4 c + i of the row.
  float acc[D / 16][4];
#pragma unroll
  for (int dc = 0; dc < D / 16; ++dc)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dc][i] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<1>();  // this step's K
    group_sync<WT>(grp);
    const int t0 = t_begin + (step * GROUPS + grp) * T;

    // S = Q K^T: the warp's m16 tile x 8 n8 tiles (64 tokens), int32.
    int sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < D / 32; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qsm + (8 * wr + ((mat & 1) << 3) + mrow) * L::PITCH +
                      (2 * kk + (mat >> 1)) * 16);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + ((2 * jp + (mat >> 1)) * 8 + mrow) * L::PITCH + (2 * kk + (mat & 1)) * 16);
        mma_s8(sc[2 * jp], qa, bk[0], bk[1]);
        mma_s8(sc[2 * jp + 1], qa, bk[2], bk[3]);
      }
    }

    // The scaled, masked scores; then K's buffer is free and the next K
    // tile is requested.
    float x[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 kv2 = *reinterpret_cast<const float2*>(&ksc[j * 8 + 2 * c]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = t0 + j * 8 + 2 * c + e < limit;
        const float sv = __fmul_rn(
            __fmul_rn(__fmul_rn((float)sc[j][e], qsr), e ? kv2.y : kv2.x), sm_scale);
        x[j][e] = ok ? sv : MASK_VALUE;
      }
    }
    group_sync<WT>(grp);
    if (step + 1 < n_steps) load(step + 1, false);
    cp_async_commit();
    cp_async_wait<1>();  // this step's V (the K just requested may be pending)
    group_sync<WT>(grp);

    // Online softmax (natural exp) and P's re-quantization per row over
    // the tile; the thread's S values become its A fragments of P.
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(x[j][0], x[j][1]));
    mx = quad_max(mx);
    const float mn = fmaxf(m, mx);
    float sum = 0.f, pamax = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 vv2 = *reinterpret_cast<const float2*>(&vsc[j * 8 + 2 * c]);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = t0 + j * 8 + 2 * c + e < limit;
        const float p = ok ? expf(__fsub_rn(x[j][e], mn)) : 0.f;
        sum = __fadd_rn(sum, p);
        const float pp = ok ? __fmul_rn(p, e ? vv2.y : vv2.x) : 0.f;
        pamax = fmaxf(pamax, fabsf(pp));
        x[j][e] = pp;
      }
    }
    sum = quad_sum(sum);
    pamax = quad_max(pamax);
    const float ps = pamax > 0.f ? __fdiv_rn(pamax, 127.f) : 1.f;
    const float ps_inv = __frcp_rn(ps);
    int qi[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // pp / ps, correctly rounded: the quotient by the reciprocal,
        // corrected by its remainder.
        const float q0 = __fmul_rn(x[j][e], ps_inv);
        qi[j][e] = __float2int_rn(__fmaf_rn(__fmaf_rn(-ps, q0, x[j][e]), ps_inv, q0));
      }
    const float alpha = expf(__fsub_rn(m, mn));  // 0 on the first tile
    l = __fadd_rn(__fmul_rn(l, alpha), sum);
    m = mn;

    // O = alpha * O + (P_i8 . V_i8) * pscale, 16 columns at a time. k-slot
    // 4c + i of 32-token step u holds token 32u + 8(i >> 1) + 2c + (i & 1),
    // and slot 16 + 4c + i token 32u + 16 + 8(i >> 1) + 2c + (i & 1): this
    // thread's values of n-tiles 4u, 4u + 1 and 4u + 2, 4u + 3 (the
    // fragment's rows g + 8 are zero). One ldmatrix.x4.trans per step
    // gives, after prmt, the B fragments of the chunk's 8 even and 8 odd
    // columns in that token order.
    uint32_t pa[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      pa[u][0] = pack_s8(qi[4 * u][0], qi[4 * u][1], qi[4 * u + 1][0], qi[4 * u + 1][1]);
      pa[u][2] = pack_s8(qi[4 * u + 2][0], qi[4 * u + 2][1], qi[4 * u + 3][0], qi[4 * u + 3][1]);
      pa[u][1] = pa[u][3] = 0u;
    }
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      int ce[4] = {0, 0, 0, 0}, co[4] = {0, 0, 0, 0};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        uint32_t vt[4];
        ldsm_x4_t(vt, vs + (u * 32 + mat * 8 + mrow) * L::PITCH + dc * 16);
        mma_s8(ce, pa[u], prmt(vt[0], vt[1], 0x6420u), prmt(vt[2], vt[3], 0x6420u));
        mma_s8(co, pa[u], prmt(vt[0], vt[1], 0x7531u), prmt(vt[2], vt[3], 0x7531u));
      }
      // Even tile column 2c + i' is column 16 dc + 4c + 2 i'; the odd
      // tile's is one further.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int cv = (i & 1) ? co[i >> 1] : ce[i >> 1];
        acc[dc][i] = __fadd_rn(__fmul_rn(acc[dc][i], alpha), __fmul_rn((float)cv, ps));
      }
    }
    group_sync<WT>(grp);  // V's buffer is free: request the next V tile
    if (step + 1 < n_steps) load(step + 1, true);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the buffers are free: reuse them to merge the groups

  float* wm = reinterpret_cast<float*>(smem + L::Q);  // [group][32 rows]
  float* wl = wm + GROUPS * 32;
  float* accs = wl + GROUPS * 32;  // [32 rows][D]
  if (c == 0) {
    wm[grp * 32 + row] = m;
    wl[grp * 32 + row] = l;
  }
  __syncthreads();
  float mb = -INFINITY;
#pragma unroll
  for (int gi = 0; gi < GROUPS; ++gi) mb = fmaxf(mb, wm[gi * 32 + row]);
  const float fw = m == -INFINITY ? 0.f : expf(__fsub_rn(m, mb));  // this group's weight
  for (int gi = 0; gi < GROUPS; ++gi) {  // in group order: a fixed summation order
    if (grp == gi) {
#pragma unroll
      for (int dc = 0; dc < D / 16; ++dc) {
        float4* dst = reinterpret_cast<float4*>(accs + row * D + dc * 16 + 4 * c);
        float4 val;
        if (gi == 0) {
          val = make_float4(__fmul_rn(acc[dc][0], fw), __fmul_rn(acc[dc][1], fw),
                            __fmul_rn(acc[dc][2], fw), __fmul_rn(acc[dc][3], fw));
        } else {
          val = *dst;
          val.x = __fadd_rn(val.x, __fmul_rn(acc[dc][0], fw));
          val.y = __fadd_rn(val.y, __fmul_rn(acc[dc][1], fw));
          val.z = __fadd_rn(val.z, __fmul_rn(acc[dc][2], fw));
          val.w = __fadd_rn(val.w, __fmul_rn(acc[dc][3], fw));
        }
        *dst = val;
      }
    }
    __syncthreads();
  }
  const size_t row0 = (((size_t)b * KV + kvh) * n_split + split) * R;
  for (int i = tid; i < R * D; i += THREADS) part_o[row0 * D + i] = accs[i];
  for (int r = tid; r < R; r += THREADS) {
    float mr = -INFINITY;
    for (int gi = 0; gi < GROUPS; ++gi) mr = fmaxf(mr, wm[gi * 32 + r]);
    float lb = 0.f;
    for (int gi = 0; gi < GROUPS; ++gi) {
      const float mw = wm[gi * 32 + r];
      if (mw != -INFINITY) lb = __fadd_rn(lb, __fmul_rn(wl[gi * 32 + r], expf(__fsub_rn(mw, mr))));
    }
    part_ml[(row0 + r) * 2] = mr;
    part_ml[(row0 + r) * 2 + 1] = lb;
  }
}

template <int D, int WT>
int launch_int8_split(const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
                      const void* v_scale, const void* lengths, const void* page_indices,
                      float* part_o, float* part_ml, int B, int nq, int H, int KV, int num_slots,
                      int page_size, int max_pages, int chunk, int n_split, float sm_scale,
                      cudaStream_t st) {
  using L = Int8Smem<D, WT>;
  auto kernel = paged_decode_int8_split_kernel<D, WT>;
  constexpr int smem = L::BYTES;
  static_assert(L::GROUP * L::GROUPS >= 2 * L::GROUPS * 32 * 4 + 32 * D * 4,
                "the merge area must fit in the groups' buffers");
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_split, KV, B), L::THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const int8_t*>(k_pool),
      static_cast<const int8_t*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(lengths),
      static_cast<const int*>(page_indices), part_o, part_ml, nq, H, KV, num_slots, page_size,
      max_pages, chunk, n_split, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// part_o / part_ml: float32 scratch of B * KV * n_split * (H / KV) * nq * D
// and * 2 values; chunk a multiple of 64 with n_split * chunk >= max_pages *
// page_size (paged_split_plan).
extern "C" int dots_paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                         const void* lengths, const void* page_indices,
                                         void* part_o, void* part_ml, void* out, int B, int nq,
                                         int H, int KV, int D, int num_pages, int page_size,
                                         int max_pages, int chunk, int n_split, float sm_scale,
                                         void* stream) {
  const int R = (H / KV) * nq;
  if (R > MAX_ROWS || chunk <= 0 || chunk % 64 != 0 || (long long)n_split * chunk <
      (long long)max_pages * page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  const int num_slots = num_pages * page_size;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  int err;
  if (D == 128 && R <= 16)
    err = launch_split<128, 1>(q, k_pool, v_pool, lengths, page_indices, po, pml, B, nq, H, KV,
                               num_slots, page_size, max_pages, chunk, n_split, scale_log2, st);
  else if (D == 128)
    err = launch_split<128, 2>(q, k_pool, v_pool, lengths, page_indices, po, pml, B, nq, H, KV,
                               num_slots, page_size, max_pages, chunk, n_split, scale_log2, st);
  else if (D == 64 && R <= 16)
    err = launch_split<64, 1>(q, k_pool, v_pool, lengths, page_indices, po, pml, B, nq, H, KV,
                              num_slots, page_size, max_pages, chunk, n_split, scale_log2, st);
  else if (D == 64)
    err = launch_split<64, 2>(q, k_pool, v_pool, lengths, page_indices, po, pml, B, nq, H, KV,
                              num_slots, page_size, max_pages, chunk, n_split, scale_log2, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (err != 0) return err;
  const int warps = B * KV * R;
  paged_merge_kernel<true><<<(warps + 3) / 4, 128, 0, st>>>(
      po, pml, static_cast<const int*>(lengths), static_cast<uint16_t*>(out), B, nq, H, KV, D,
      max_pages * page_size, chunk, n_split);
  return static_cast<int>(cudaGetLastError());
}

// The int8 mode: the same scratch and plan as the bf16 mode.
extern "C" int dots_paged_attention_int8(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* lengths, const void* page_indices,
                                         void* part_o, void* part_ml, void* out, int B, int nq,
                                         int H, int KV, int D, int num_pages, int page_size,
                                         int max_pages, int chunk, int n_split, float sm_scale,
                                         void* stream) {
  const int R = (H / KV) * nq;
  if (R > MAX_ROWS || page_size % 4 != 0 || chunk <= 0 || chunk % INT8_TILE != 0 ||
      (long long)n_split * chunk < (long long)max_pages * page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  const int num_slots = num_pages * page_size;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  const int wt = (R + 7) / 8;  // warps a tile: 8 query rows each
  int err = static_cast<int>(cudaErrorInvalidValue);
#define DOTS_INT8_CASE(D_, WT_)                                                               \
  if (D == D_ && wt == WT_)                                                                   \
    err = launch_int8_split<D_, WT_>(q, k_pool, v_pool, k_scale, v_scale, lengths,            \
                                     page_indices, po, pml, B, nq, H, KV, num_slots,          \
                                     page_size, max_pages, chunk, n_split, sm_scale, st);
  DOTS_INT8_CASE(128, 1)
  DOTS_INT8_CASE(128, 2)
  DOTS_INT8_CASE(128, 3)
  DOTS_INT8_CASE(64, 1)
  DOTS_INT8_CASE(64, 2)
  DOTS_INT8_CASE(64, 3)
#undef DOTS_INT8_CASE
  if (err != 0) return err;
  const int warps = B * KV * R;
  paged_merge_kernel<false><<<(warps + 3) / 4, 128, 0, st>>>(
      po, pml, static_cast<const int*>(lengths), static_cast<uint16_t*>(out), B, nq, H, KV, D,
      max_pages * page_size, chunk, n_split);
  return static_cast<int>(cudaGetLastError());
}
