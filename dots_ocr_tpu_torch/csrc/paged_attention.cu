// Multi-query paged decode attention for Hopper (sm_90a): bf16 K/V, and
// int8 K/V with per-token f32 scales (the second kernel, below).
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
// What the design does about it: one block per (KV head, slot) walks only
// ceil((len + nq - 1) / 64) tiles of 64 logical tokens, resolving each
// token's page through the table, so any page_size works (no 128-alignment
// rule) and padded table entries are never touched. A tile's K and V rows
// are loaded with coalesced 16-byte reads into shared memory (K at an odd
// word pitch so each thread's own-row reads are conflict-free); the block
// serves all H / KV query heads x nq queries of its KV head from that one
// read. Scores and P @ V run on the CUDA cores in f32 (the products are
// tiny: <= 24 query rows), online softmax in the base-2 domain. Masked
// token rows are zero-filled, so garbage in unwritten slots cannot leak.
// Simple first: a tile's loads overlap each other but not the previous
// tile's compute, and 64 slots x 2 KV heads = 128 blocks under-fill 132
// SMs (one long row bounds the call); split-K over the pages is later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // logical tokens per tile
constexpr int NUM_THREADS = 128;
constexpr int MAX_ROWS = 24;  // (H / KV) * nq query rows per block
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

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

template <int D>
__global__ void __launch_bounds__(NUM_THREADS)
paged_decode_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k_pool,
                    const uint16_t* __restrict__ v_pool, const int* __restrict__ lengths,
                    const int* __restrict__ page_indices, uint16_t* __restrict__ out,
                    int nq, int H, int KV, int num_slots, int page_size, int max_pages,
                    float scale_log2) {
  constexpr int KW = D / 2 + 1;  // K row pitch in 32-bit words (odd)
  constexpr int QW = D / 2;
  constexpr int RG = NUM_THREADS / D;  // row groups in the P @ V phase
  constexpr int ACC = (MAX_ROWS + RG - 1) / RG;
  constexpr int PER_THREAD = TILE * (D / 8) / NUM_THREADS;  // 16-byte loads per tensor
  __shared__ uint32_t Ks[TILE * KW];
  __shared__ __align__(16) uint16_t Vs[TILE * D];
  __shared__ uint32_t Qs[MAX_ROWS * QW];
  __shared__ float Ss[MAX_ROWS * TILE];
  __shared__ float m_s[MAX_ROWS], l_s[MAX_ROWS], alpha_s[MAX_ROWS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = H / KV;
  const int R = G * nq;  // row r = g * nq + j serves query head kvh * G + g, query j

  for (int i = tid; i < R * QW; i += NUM_THREADS) {
    const int r = i / QW, w = i % QW;
    const int g = r / nq, j = r % nq;
    Qs[i] = *reinterpret_cast<const uint32_t*>(
        q + (((size_t)b * nq + j) * H + kvh * G + g) * D + 2 * w);
  }
  if (tid < R) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int len = lengths[b];
  // Tokens the furthest query can see, capped at the table's capacity.
  const int n_tok = len > 0 ? min(len + nq - 1, max_pages * page_size) : 0;
  const int* table = page_indices + (size_t)b * max_pages;
  const size_t head_base = (size_t)kvh * num_slots;

  const int d = tid % D, rg = tid / D;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = 0; t0 < n_tok; t0 += TILE) {
    // All of the tile's 16-byte loads are issued into registers before any
    // is stored, so their latencies overlap (tokens past n_tok read as 0).
    uint4 kst[PER_THREAD], vst[PER_THREAD];
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = tid + it * NUM_THREADS;
      const int pos = t0 + i / (D / 8);
      kst[it] = vst[it] = make_uint4(0u, 0u, 0u, 0u);
      if (pos < n_tok) {
        const int slot = table[pos / page_size] * page_size + pos % page_size;
        const size_t off = (head_base + slot) * D + (i % (D / 8)) * 8;
        kst[it] = *reinterpret_cast<const uint4*>(k_pool + off);
        vst[it] = *reinterpret_cast<const uint4*>(v_pool + off);
      }
    }
#pragma unroll
    for (int it = 0; it < PER_THREAD; ++it) {
      const int i = tid + it * NUM_THREADS;
      const int row = i / (D / 8), ch = i % (D / 8);
      uint32_t* kd = &Ks[row * KW + ch * 4];
      kd[0] = kst[it].x;
      kd[1] = kst[it].y;
      kd[2] = kst[it].z;
      kd[3] = kst[it].w;
      *reinterpret_cast<uint4*>(&Vs[row * D + ch * 8]) = vst[it];
    }
    __syncthreads();

    // Scores: thread (token, half) dots its token's K row with rows
    // half, half + 2, ... (all lanes of a warp read the same Q row).
    {
      const int tok = tid % TILE, half = tid / TILE;
      const uint32_t* kr = &Ks[tok * KW];
      for (int r = half; r < R; r += NUM_THREADS / TILE) {
        const uint32_t* qr = &Qs[r * QW];
        float dot = 0.f;
#pragma unroll 8
        for (int w = 0; w < QW; ++w) {
          const uint32_t kw = kr[w], qw = qr[w];
          dot = fmaf(bf_lo(qw), bf_lo(kw), dot);
          dot = fmaf(bf_hi(qw), bf_hi(kw), dot);
        }
        Ss[r * TILE + tok] = dot * scale_log2;
      }
    }
    __syncthreads();

    // Online softmax, one warp per row; Ss becomes P in place.
    for (int r = warp; r < R; r += NUM_THREADS / 32) {
      const int limit = min(len + r % nq, n_tok);  // query j sees tokens < len + j
      float sv[2];
      bool ok[2];
      float mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = lane + 32 * e;
        ok[e] = t0 + tok < limit;
        sv[e] = ok[e] ? Ss[r * TILE + tok] : MASK_VALUE;
        mx = fmaxf(mx, sv[e]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[r];
      const float mn = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ok[e] ? exp2f(sv[e] - mn) : 0.f;
        Ss[r * TILE + lane + 32 * e] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f(m_prev - mn);  // 0 on the first tile
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = mn;
      }
    }
    __syncthreads();

    // O = alpha * O + P V: thread (d, rg) owns column d of rows rg + i * RG.
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = rg + i * RG;
      if (r < R) acc[i] *= alpha_s[r];
    }
    for (int tok = 0; tok < TILE; ++tok) {
      const float vv = __uint_as_float((uint32_t)Vs[tok * D + d] << 16);
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int r = rg + i * RG;
        if (r < R) acc[i] = fmaf(Ss[r * TILE + tok], vv, acc[i]);
      }
    }
    __syncthreads();  // Ks / Vs / Ss are refilled by the next tile
  }

#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int r = rg + i * RG;
    if (r < R) {
      const float l = l_s[r];
      const float o = l == 0.f ? 0.f : acc[i] / l;
      const int g = r / nq, j = r % nq;
      out[(((size_t)b * nq + j) * H + kvh * G + g) * D + d] =
          __bfloat16_as_ushort(__float2bfloat16_rn(o));
    }
  }
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
// loads are not overlapped with compute, as in the bf16 kernel.

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

extern "C" int dots_paged_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                                         const void* lengths, const void* page_indices,
                                         void* out, int B, int nq, int H, int KV, int D,
                                         int num_pages, int page_size, int max_pages,
                                         float sm_scale, void* stream) {
  if ((H / KV) * nq > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(KV, B);
  const float scale_log2 = sm_scale * 1.4426950408889634f;
  const int num_slots = num_pages * page_size;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k_pool);
  const auto* vp = static_cast<const uint16_t*>(v_pool);
  const auto* lp = static_cast<const int*>(lengths);
  const auto* tp = static_cast<const int*>(page_indices);
  auto* op = static_cast<uint16_t*>(out);
  if (D == 128) {
    paged_decode_kernel<128><<<grid, NUM_THREADS, 0, st>>>(
        qp, kp, vp, lp, tp, op, nq, H, KV, num_slots, page_size, max_pages, scale_log2);
  } else if (D == 64) {
    paged_decode_kernel<64><<<grid, NUM_THREADS, 0, st>>>(
        qp, kp, vp, lp, tp, op, nq, H, KV, num_slots, page_size, max_pages, scale_log2);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
