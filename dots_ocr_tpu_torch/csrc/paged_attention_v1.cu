// The v1 paged decode attention for Hopper (sm_90a): one query token per
// sequence over a layer-stacked paged cache, bf16 or int8 K/V.
//
// Replaces the Pallas kernel dots_ocr_tpu/ops/paged_attention.py:
// paged_attention_stacked -> _paged_kernel (the pl.pallas_call at line
// 268), reached through paged_attention (:757). Same function, per batch
// row b and KV head (its G = H / KV query rows), over the row's pages in
// order, page by page (page_size-token tiles of an online softmax):
//   k = bf16 K in float32 (int8 mode: int8 K times its float32 scale, kept
//       in float32); v = bf16 V (int8 mode: int8 V times its scale, rounded
//       to bf16)
//   s = (q in float32) . k * scale; tokens >= length -> -0.7 * f32 max
//   m_new = max(m, rowmax(s)); p = exp(s - m_new), 0 past the length
//   alpha = exp(m - m_new) (NaN -> 0); l = alpha l + sum(p)
//   acc = alpha acc + bf16(p) @ v (float32 sum)
//   out = acc * (l == 0 ? 0 : 1 / l)
// so a row of length 0 returns exact zeros. This is not kernel 2's int8
// arithmetic (csrc/paged_attention.cu re-quantizes P per row).
//
// What bounds it on this card: bytes. Each row's K and V are read once
// (2 x length x KV x D x 2 bytes in bf16, half that plus 8 bytes of scales
// per token in int8) for 4 x G x D FLOPs per token: ~6 FLOP per byte.
//
// What the design does about it, simple first: one block (4 warps) per
// (row, KV head) walks only that row's live pages, reading the page table
// itself; a page is staged in float32 in shared memory in chunks of up to
// 128 tokens with 16-byte (bf16) or 8-byte (int8) coalesced loads, K for
// the page's scores, then V for its products. QK runs on the CUDA cores in
// float32, as the Pallas body computes it (TF32 tensor cores would change
// the rounding); PV multiplies the bf16-rounded P by bf16 V values with
// float32 sums. The stacked form selects the layer by pointer offset. Not
// yet: overlapping one chunk's loads with the previous chunk's compute,
// split-K over pages for long rows, tensor-core products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 128;
constexpr int CHUNK = 128;     // tokens of a page staged at a time
constexpr int MAX_GROUP = 8;   // query rows (H / KV) one block serves
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Stage `count` tokens (from flat token index `tok`) of one layer's pool
// into rows of `dst` (pitch D + 1 floats). int8 mode multiplies by the
// token's scale; `round_v` rounds that product to bf16 (V's dequant).
template <int D, bool QUANT>
__device__ __forceinline__ void stage(float* dst, const void* pool, const float* scales,
                                      size_t tok, int count, bool round_v) {
  constexpr int PITCH = D + 1;
  for (int i = threadIdx.x; i < count * (D / 8); i += NUM_THREADS) {
    const int row = i / (D / 8), ch = i % (D / 8);
    float* d = dst + row * PITCH + ch * 8;
    if (QUANT) {
      const uint2 raw =
          *reinterpret_cast<const uint2*>(static_cast<const int8_t*>(pool) + (tok + row) * D + ch * 8);
      const float sc = scales[tok + row];
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float x = static_cast<float>(b[e]) * sc;
        d[e] = round_v ? round_bf16(x) : x;
      }
    } else {
      const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(pool) +
                                                        (tok + row) * D + ch * 8);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d[2 * e] = bf16_bits_to_float(w[e] & 0xffffu);
        d[2 * e + 1] = bf16_bits_to_float(w[e] >> 16);
      }
    }
  }
}

template <int D, bool QUANT>
__global__ void __launch_bounds__(NUM_THREADS)
paged_v1_kernel(const uint16_t* __restrict__ q, const void* __restrict__ k_all,
                const void* __restrict__ v_all, const float* __restrict__ ks_all,
                const float* __restrict__ vs_all, const int* __restrict__ lengths,
                const int* __restrict__ page_indices, uint16_t* __restrict__ out, int H,
                int KV, int n_slots, int page_size, int max_pages, int layer, float scale) {
  constexpr int PITCH = D + 1;  // float pitch: conflict-free column and row reads
  constexpr int GROUPS = NUM_THREADS / D;  // PV: threads sharing a column d
  constexpr int ROWS = MAX_GROUP / GROUPS;  // PV: query rows per thread
  extern __shared__ float smem[];
  float* tile = smem;                       // [CHUNK][PITCH]
  float* q_s = tile + CHUNK * PITCH;        // [MAX_GROUP][PITCH]
  float* s_s = q_s + MAX_GROUP * PITCH;     // [MAX_GROUP][page_size]
  __shared__ float m_s[MAX_GROUP], l_s[MAX_GROUP], alpha_s[MAX_GROUP];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / KV;
  const int len = lengths[b];
  // Flat token index of this (layer, KV head)'s pool: [L, KV, n_slots, D].
  const size_t head_tok = ((size_t)layer * KV + kvh) * n_slots;

  for (int i = tid; i < G * D; i += NUM_THREADS) {
    const int g = i / D, d = i % D;
    q_s[g * PITCH + d] = bf16_bits_to_float(q[((size_t)b * H + kvh * G + g) * D + d]);
  }
  if (tid < MAX_GROUP) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  const int d = tid % D, grp = tid / D;
  float acc[ROWS];
#pragma unroll
  for (int j = 0; j < ROWS; ++j) acc[j] = 0.f;
  __syncthreads();

  const int n_pages = len > 0 ? min((len + page_size - 1) / page_size, max_pages) : 0;
  for (int i = 0; i < n_pages; ++i) {
    const size_t page_tok = head_tok + (size_t)page_indices[(size_t)b * max_pages + i] * page_size;
    const int pos0 = i * page_size;

    // Scores of the page, chunk by chunk.
    for (int t0 = 0; t0 < page_size; t0 += CHUNK) {
      const int count = min(CHUNK, page_size - t0);
      stage<D, QUANT>(tile, k_all, ks_all, page_tok + t0, count, false);
      __syncthreads();
      for (int idx = tid; idx < G * count; idx += NUM_THREADS) {
        const int g = idx / count, t = idx % count;
        const float* qr = q_s + g * PITCH;
        const float* kr = tile + t * PITCH;
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // four chains: latency, not order
#pragma unroll 16
        for (int e = 0; e < D; e += 4) {
#pragma unroll
          for (int u = 0; u < 4; ++u) part[u] = fmaf(qr[e + u], kr[e + u], part[u]);
        }
        const float dot = (part[0] + part[1]) + (part[2] + part[3]);
        s_s[g * page_size + t0 + t] = pos0 + t0 + t < len ? dot * scale : MASK_VALUE;
      }
      __syncthreads();
    }

    // The online-softmax update, one warp per query row.
    for (int g = warp; g < G; g += NUM_THREADS / 32) {
      float* sr = s_s + g * page_size;
      float mx = -INFINITY;
      for (int t = lane; t < page_size; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page_size; t += 32) {
        const float p = pos0 + t < len ? expf(sr[t] - m_next) : 0.f;
        sum += p;
        sr[t] = round_bf16(p);  // P enters P @ V in bf16
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        float alpha = expf(m_prev - m_next);
        if (isnan(alpha)) alpha = 0.f;
        l_s[g] = alpha * l_s[g] + sum;
        m_s[g] = m_next;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int g = grp + j * GROUPS;
      if (g < G) acc[j] *= alpha_s[g];
    }
    for (int t0 = 0; t0 < page_size; t0 += CHUNK) {
      const int count = min(CHUNK, page_size - t0);
      stage<D, QUANT>(tile, v_all, vs_all, page_tok + t0, count, true);
      __syncthreads();
      for (int t = 0; t < count; ++t) {
        const float vv = tile[t * PITCH + d];
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
          const int g = grp + j * GROUPS;
          if (g < G) acc[j] = fmaf(s_s[g * page_size + t0 + t], vv, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int g = grp + j * GROUPS;
    if (g < G) {
      const float l = l_s[g];
      const float l_inv = l == 0.f ? 0.f : 1.f / l;
      const __nv_bfloat16 o = __float2bfloat16_rn(acc[j] * l_inv);
      out[((size_t)b * H + kvh * G + g) * D + d] = *reinterpret_cast<const uint16_t*>(&o);
    }
  }
}

template <int D, bool QUANT>
int launch(const void* q, const void* k_all, const void* v_all, const void* ks_all,
           const void* vs_all, const void* lengths, const void* page_indices, void* out, int B,
           int H, int KV, int n_slots, int page_size, int max_pages, int layer, float scale,
           cudaStream_t st) {
  const size_t smem =
      ((size_t)(CHUNK + MAX_GROUP) * (D + 1) + (size_t)MAX_GROUP * page_size) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(paged_v1_kernel<D, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  paged_v1_kernel<D, QUANT><<<dim3(B, KV), NUM_THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), k_all, v_all, static_cast<const float*>(ks_all),
      static_cast<const float*>(vs_all), static_cast<const int*>(lengths),
      static_cast<const int*>(page_indices), static_cast<uint16_t*>(out), H, KV, n_slots,
      page_size, max_pages, layer, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT>
int dispatch(const void* q, const void* k_all, const void* v_all, const void* ks_all,
             const void* vs_all, const void* lengths, const void* page_indices, void* out,
             int B, int H, int KV, int D, int n_slots, int page_size, int max_pages, int layer,
             float scale, void* stream) {
  if (H % KV != 0 || H / KV > MAX_GROUP || page_size % 16 != 0 || B == 0)
    return B == 0 ? 0 : static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128, QUANT>(q, k_all, v_all, ks_all, vs_all, lengths, page_indices, out, B,
                              H, KV, n_slots, page_size, max_pages, layer, scale, st);
  if (D == 64)
    return launch<64, QUANT>(q, k_all, v_all, ks_all, vs_all, lengths, page_indices, out, B, H,
                             KV, n_slots, page_size, max_pages, layer, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int dots_paged_attention_v1_bf16(const void* q, const void* k_all, const void* v_all,
                                            const void* lengths, const void* page_indices,
                                            void* out, int B, int H, int KV, int D, int n_slots,
                                            int page_size, int max_pages, int layer,
                                            float sm_scale, void* stream) {
  return dispatch<false>(q, k_all, v_all, nullptr, nullptr, lengths, page_indices, out, B, H,
                         KV, D, n_slots, page_size, max_pages, layer, sm_scale, stream);
}

extern "C" int dots_paged_attention_v1_int8(const void* q, const void* k_all, const void* v_all,
                                            const void* k_scales_all, const void* v_scales_all,
                                            const void* lengths, const void* page_indices,
                                            void* out, int B, int H, int KV, int D, int n_slots,
                                            int page_size, int max_pages, int layer,
                                            float sm_scale, void* stream) {
  return dispatch<true>(q, k_all, v_all, k_scales_all, v_scales_all, lengths, page_indices, out,
                        B, H, KV, D, n_slots, page_size, max_pages, layer, sm_scale, stream);
}
