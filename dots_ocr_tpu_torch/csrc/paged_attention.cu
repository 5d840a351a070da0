// Multi-query paged decode attention for Hopper (sm_90a): bf16 K/V (split-K
// flash-decoding, below), and int8 K/V with per-token f32 scales (the
// int8 kernel, further below).
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

// One warp per output row (slot b, KV head, row r): the log-sum-exp merge
// of the row's live splits; exact zeros where nothing was seen.
__global__ void paged_merge_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   const int* __restrict__ lengths, uint16_t* __restrict__ out,
                                   int B, int nq, int H, int KV, int D, int cap, int chunk,
                                   int n_split) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const int G = H / KV, R = G * nq;
  if (w >= B * KV * R) return;  // uniform across the warp
  const int b = w / (KV * R), kvh = (w / R) % KV, r = w % R;
  const int len = lengths[b];
  const int n_tok = len > 0 ? min(len + nq - 1, cap) : 0;
  const int n_live = (n_tok + chunk - 1) / chunk;
  const size_t row0 = ((size_t)b * KV + kvh) * n_split * R + r;  // split s: row0 + s * R
  float mb = -INFINITY;
  for (int s = 0; s < n_live; ++s) mb = fmaxf(mb, part_ml[(row0 + (size_t)s * R) * 2]);
  float lb = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float ms = part_ml[(row0 + (size_t)s * R) * 2];
    lb += ms == -INFINITY ? 0.f : part_ml[(row0 + (size_t)s * R) * 2 + 1] * exp2f(ms - mb);
  }
  const float inv = lb == 0.f ? 0.f : 1.f / lb;
  const int gh = r / nq, j = r % nq;
  uint16_t* dst = out + (((size_t)b * nq + j) * H + kvh * G + gh) * D;
  for (int d = lane; d < D; d += 32) {
    float x = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const size_t row = row0 + (size_t)s * R;
      const float ms = part_ml[row * 2];
      if (ms != -INFINITY) x += part_o[row * D + d] * exp2f(ms - mb);
    }
    dst[d] = __bfloat16_as_ushort(__float2bfloat16_rn(x * inv));
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
// int8 mode: the Pallas body's quantized path (paged_attention.py:400-509).
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
// length, so on the card kernel and plain agree up to the softmax
// denominator's summation order (f32 ops are issued with __fmul_rn /
// __fadd_rn so nvcc contracts none of them into an FMA the plain version
// does not have).
//
// What bounds it: the same live-K/V read as the bf16 mode at half the
// bytes (the capacity mode's point). Both products run on the tensor cores
// with mma.sync m16n8k32 s8 x s8 -> s32: Q [32 rows, D] x K^T for the
// scores (rows past (H/KV)*nq are zero), P [32 rows, 64 tokens] x V for
// the output. V is the column-major B operand of the second product and
// ldmatrix.trans only moves b16, so the tile's V is stored transposed in
// shared memory ([D][tokens], byte stores) as it is loaded; K is stored
// row-major and read directly as the B operand of the first. Shared rows
// are padded by 16 bytes so the 8 rows of a fragment hit distinct banks.
// Tokens past a row's live span are zero-filled, scales included, and a
// masked probability never meets a scale (it is 0 before the multiply).
// Simple first: one block per (KV head, slot) walks its tiles serially,
// loads are not overlapped with compute.

constexpr int INT8_TILE = 64;
constexpr int ROWS_PAD = 32;  // two m16 tiles

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
paged_decode_int8_kernel(const uint16_t* __restrict__ q, const int8_t* __restrict__ k_pool,
                         const int8_t* __restrict__ v_pool, const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale, const int* __restrict__ lengths,
                         const int* __restrict__ page_indices, uint16_t* __restrict__ out,
                         int nq, int H, int KV, int num_slots, int page_size, int max_pages,
                         float sm_scale) {
  constexpr int T = INT8_TILE;
  constexpr int QP = D + 16;  // Qs / Ks row pitch in bytes
  constexpr int VP = T + 16;  // Vt / Ps row pitch in bytes
  constexpr int CH = D / 16;  // 16-byte chunks per token row
  constexpr int PER_THREAD = T * CH / NUM_THREADS;
  constexpr int NT_PV = D / 32;  // n8 output tiles per warp in P.V
  __shared__ __align__(16) int8_t Qs[ROWS_PAD * QP];
  __shared__ __align__(16) int8_t Ks[T * QP];
  __shared__ __align__(16) int8_t Vt[D * VP];
  __shared__ __align__(16) int8_t Ps[ROWS_PAD * VP];
  __shared__ float Ss[MAX_ROWS * T];
  __shared__ float ks_s[T], vs_s[T];
  __shared__ float qs_s[ROWS_PAD], m_s[ROWS_PAD], l_s[ROWS_PAD];
  __shared__ float alpha_s[ROWS_PAD], pscale_s[ROWS_PAD];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 2, tig = lane & 3;  // mma groupID, thread in group
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int R = G * nq;  // row r = g * nq + j serves query head kvh * G + g, query j
  const int MT = R > 16 ? 2 : 1;  // m16 tiles holding live rows

  // Zero the padded rows of Qs and all of Ps (rows >= R stay zero), and the
  // per-row state of rows >= R (alpha, pscale 0: they never accumulate).
  for (int i = tid; i < ROWS_PAD * QP / 4; i += NUM_THREADS) reinterpret_cast<uint32_t*>(Qs)[i] = 0u;
  for (int i = tid; i < ROWS_PAD * VP / 4; i += NUM_THREADS) reinterpret_cast<uint32_t*>(Ps)[i] = 0u;
  if (tid < ROWS_PAD) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
    alpha_s[tid] = 0.f;
    pscale_s[tid] = 0.f;
  }
  __syncthreads();

  // Quantize each query row once: one warp per row, D / 32 values a lane.
  for (int r = warp; r < R; r += NUM_THREADS / 32) {
    const int g = r / nq, j = r % nq;
    const uint16_t* qr = q + (((size_t)b * nq + j) * H + kvh * G + g) * D;
    float x[D / 32];
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e) {
      x[e] = __uint_as_float((uint32_t)qr[lane + 32 * e] << 16);
      amax = fmaxf(amax, fabsf(x[e]));
    }
    amax = warp_max(amax);
    const float qs = amax > 0.f ? __fdiv_rn(amax, 127.f) : 1.f;
#pragma unroll
    for (int e = 0; e < D / 32; ++e)
      Qs[r * QP + lane + 32 * e] = (int8_t)__float2int_rn(__fdiv_rn(x[e], qs));
    if (lane == 0) qs_s[r] = qs;
  }

  const int len = lengths[b];
  const int n_tok = len > 0 ? min(len + nq - 1, max_pages * page_size) : 0;
  const int* table = page_indices + (size_t)b * max_pages;
  const size_t head_base = (size_t)kvh * num_slots;

  float acc[2][NT_PV][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT_PV; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += T) {
    // Load: K row-major, V transposed, the tile's scales; zeros past n_tok.
    uint4 kst[PER_THREAD], vst[PER_THREAD];
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = tid + it * NUM_THREADS;
      const int pos = t0 + i / CH;
      kst[it] = vst[it] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < n_tok) {
        const int slot = table[pos / page_size] * page_size + pos % page_size;
        const size_t off = (head_base + slot) * D + (i % CH) * 16;
        kst[it] = *reinterpret_cast<const uint4*>(k_pool + off);
        vst[it] = *reinterpret_cast<const uint4*>(v_pool + off);
      }
    }
    if (tid < T) {
      const int pos = t0 + tid;
      float ksv = 0.f, vsv = 0.f;
      if (pos < n_tok) {
        const size_t si = head_base + table[pos / page_size] * page_size + pos % page_size;
        ksv = k_scale[si];
        vsv = v_scale[si];
      }
      ks_s[tid] = ksv;
      vs_s[tid] = vsv;
    }
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = tid + it * NUM_THREADS;
      const int row = i / CH, ch = i % CH;
      *reinterpret_cast<uint4*>(&Ks[row * QP + ch * 16]) = kst[it];
      const uint32_t w[4] = {vst[it].x, vst[it].y, vst[it].z, vst[it].w};
#pragma unroll
      for (int e = 0; e < 16; ++e)
        Vt[(ch * 16 + e) * VP + row] = (int8_t)((w[e >> 2] >> (8 * (e & 3))) & 0xffu);
    }
    __syncthreads();

    // Scores: warp w owns tokens [16w, 16w + 16) (two n8 tiles), all rows.
    {
      int c[2][2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0;
#pragma unroll
      for (int kk = 0; kk < D / 32; ++kk) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int8_t* kb = &Ks[(warp * 16 + nt * 8 + grp) * QP + kk * 32 + tig * 4];
          const uint32_t b0 = ld32(kb), b1 = ld32(kb + 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= MT) continue;  // static register indices, dynamic skip
            const int8_t* qa = &Qs[(mt * 16 + grp) * QP + kk * 32 + tig * 4];
            mma_s8(c[mt][nt], ld32(qa), ld32(qa + 8 * QP), ld32(qa + 16), ld32(qa + 8 * QP + 16),
                   b0, b1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= MT) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + grp + (i >> 1) * 8;
            const int tok = warp * 16 + nt * 8 + tig * 2 + (i & 1);
            if (r < R) {
              const int limit = min(len + r % nq, n_tok);  // query j sees tokens < len + j
              const float sv = __fmul_rn(
                  __fmul_rn(__fmul_rn((float)c[mt][nt][i], qs_s[r]), ks_s[tok]), sm_scale);
              Ss[r * T + tok] = t0 + tok < limit ? sv : MASK_VALUE;
            }
          }
        }
      }
    }
    __syncthreads();

    // Online softmax and P re-quantization, one warp per row.
    for (int r = warp; r < R; r += NUM_THREADS / 32) {
      const int limit = min(len + r % nq, n_tok);
      float sv[2];
      bool ok[2];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = lane + 32 * e;
        ok[e] = t0 + tok < limit;
        sv[e] = Ss[r * T + tok];
        mx = fmaxf(mx, sv[e]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float mn = fmaxf(m_prev, mx);
      float sum = 0.f, pp[2], pamax = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[e] ? expf(__fsub_rn(sv[e], mn)) : 0.f;
        sum = __fadd_rn(sum, p);
        pp[e] = ok[e] ? __fmul_rn(p, vs_s[lane + 32 * e]) : 0.f;
        pamax = fmaxf(pamax, fabsf(pp[e]));
      }
      sum = warp_sum(sum);
      pamax = warp_max(pamax);
      const float pscale = pamax > 0.f ? __fdiv_rn(pamax, 127.f) : 1.f;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        Ps[r * VP + lane + 32 * e] = (int8_t)__float2int_rn(__fdiv_rn(pp[e], pscale));
      if (lane == 0) {
        const float alpha = expf(__fsub_rn(m_prev, mn));  // 0 on the first tile
        alpha_s[r] = alpha;
        pscale_s[r] = pscale;
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], alpha), sum);
        m_s[r] = mn;
      }
    }
    __syncthreads();

    // O = alpha * O + (P_i8 . V_i8) * pscale: warp w owns columns
    // [w * D / 4, (w + 1) * D / 4) (NT_PV n8 tiles).
    {
      int c[2][NT_PV][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT_PV; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) c[mt][nt][i] = 0;
#pragma unroll
      for (int kk = 0; kk < T / 32; ++kk) {
#pragma unroll
        for (int nt = 0; nt < NT_PV; ++nt) {
          const int8_t* vb = &Vt[(warp * (D / 4) + nt * 8 + grp) * VP + kk * 32 + tig * 4];
          const uint32_t b0 = ld32(vb), b1 = ld32(vb + 16);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            if (mt >= MT) continue;
            const int8_t* pa = &Ps[(mt * 16 + grp) * VP + kk * 32 + tig * 4];
            mma_s8(c[mt][nt], ld32(pa), ld32(pa + 8 * VP), ld32(pa + 16), ld32(pa + 8 * VP + 16),
                   b0, b1);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (mt >= MT) continue;
#pragma unroll
        for (int nt = 0; nt < NT_PV; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = mt * 16 + grp + (i >> 1) * 8;
            acc[mt][nt][i] = __fadd_rn(__fmul_rn(acc[mt][nt][i], alpha_s[r]),
                                       __fmul_rn((float)c[mt][nt][i], pscale_s[r]));
          }
        }
      }
    }
    __syncthreads();  // Ks / Vt / Ss / Ps are refilled by the next tile
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (mt >= MT) continue;
#pragma unroll
    for (int nt = 0; nt < NT_PV; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + grp + half * 8;
        if (r < R) {
          const float l = l_s[r];
          const float l_inv = l == 0.f ? 0.f : __fdiv_rn(1.f, l);
          const int g = r / nq, j = r % nq;
          const int d = warp * (D / 4) + nt * 8 + tig * 2;
          const uint32_t lo = __bfloat16_as_ushort(
              __float2bfloat16_rn(__fmul_rn(acc[mt][nt][half * 2], l_inv)));
          const uint32_t hi = __bfloat16_as_ushort(
              __float2bfloat16_rn(__fmul_rn(acc[mt][nt][half * 2 + 1], l_inv)));
          *reinterpret_cast<uint32_t*>(out + (((size_t)b * nq + j) * H + kvh * G + g) * D + d) =
              lo | (hi << 16);
        }
      }
    }
  }
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
  paged_merge_kernel<<<(warps + 3) / 4, 128, 0, st>>>(
      po, pml, static_cast<const int*>(lengths), static_cast<uint16_t*>(out), B, nq, H, KV, D,
      max_pages * page_size, chunk, n_split);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dots_paged_attention_int8(const void* q, const void* k_pool, const void* v_pool,
                                         const void* k_scale, const void* v_scale,
                                         const void* lengths, const void* page_indices,
                                         void* out, int B, int nq, int H, int KV, int D,
                                         int num_pages, int page_size, int max_pages,
                                         float sm_scale, void* stream) {
  if ((H / KV) * nq > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KV, B);
  const int num_slots = num_pages * page_size;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const int8_t*>(k_pool);
  const auto* vp = static_cast<const int8_t*>(v_pool);
  const auto* ksp = static_cast<const float*>(k_scale);
  const auto* vsp = static_cast<const float*>(v_scale);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* tp = static_cast<const int*>(page_indices);
  auto* op = static_cast<uint16_t*>(out);
  if (D == 128) {
    paged_decode_int8_kernel<128><<<grid, NUM_THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, lp, tp, op, nq, H, KV, num_slots, page_size, max_pages, sm_scale);
  } else if (D == 64) {
    paged_decode_int8_kernel<64><<<grid, NUM_THREADS, 0, st>>>(
        qp, kp, vp, ksp, vsp, lp, tp, op, nq, H, KV, num_slots, page_size, max_pages, sm_scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
