// The v1 paged decode attention for Hopper (sm_90a): one query token per
// sequence over a layer-stacked paged cache, bf16 or int8 K/V (one
// templated body for both modes).
//
// Replaces the Pallas kernel dots_ocr_tpu/ops/paged_attention.py:
// paged_attention_stacked -> _paged_kernel (the pl.pallas_call at line
// 268), reached through paged_attention (:757). Same function, per batch
// row b and KV head (its G = H / KV query rows), tokens < lengths[b]:
//   k = bf16 K (int8 mode: int8 K times its float32 scale, kept in float32)
//   v = bf16 V (int8 mode: int8 V times its scale, rounded to bf16)
//   s = q . k * scale; tokens past the length -> -0.7 * f32 max
//   per tile of tokens: m_new = max(m, rowmax(s)); p = exp(s - m_new), 0
//   past the length; alpha = exp(m - m_new) (NaN -> 0); l = alpha l +
//   sum(p); acc = alpha acc + bf16(p) @ v (float32 sums)
//   out = acc * (l == 0 ? 0 : 1 / l)
// so a row of length 0 returns exact zeros. It dequantizes K and V; it does
// not re-quantize P as kernel 2's int8 mode does (csrc/paged_attention.cu).
//
// What bounds it on this card: bytes. Each row's live K and V are read once
// (2 x length x KV x D x 2 bytes in bf16, half that plus 8 bytes of scales
// per token and head in int8) for 4 x G x D operations per token: ~6 per
// byte, far under the H100's ridge of ~295.
//
// What the design does about it:
// (a) Split over the token axis, as kernel 2: grid (split, KV head, row);
//     split s covers tokens [s * chunk, (s + 1) * chunk), chunk whole pages
//     and whole 64-token steps, from static shapes only (paged_v1_split_plan
//     in ops/paged_attention.py: a decode step never syncs with the host).
//     A block whose range starts past its row's length exits at once, so a
//     step of 64 slots with 3 live rows runs as many blocks as those rows'
//     splits; the others write float32 partials (m, l in the natural-exp
//     domain, unnormalized O) to the caller's scratch, and kernel 2's merge
//     (csrc/paged_merge.cuh, at nq = 1) combines a row's live splits in
//     split order.
// (b) Inside a split, the Pallas page-by-page online softmax over 64-token
//     steps (one page at page 64, the served int8 shape): each of the 4 warps
//     takes 16 tokens of the step; the step's row max is exchanged through
//     shared memory at one block barrier, so every warp rescales by the same
//     alpha, and the warps' l and O are summed once at the end, in warp order.
// (c) Tensor cores: mma.sync m16n8k16 bf16 -> f32 for S = Q K^T and O += P V.
//     The G <= 8 query rows are the A operand (rows G..15 zero), so the S
//     accumulators, packed to bf16, are P's A fragment with no shuffle; K
//     and V fragments come through ldmatrix and ldmatrix.trans. Tokens on
//     M would waste no rows but need P transposed between the products; the
//     padded rows cost tensor-core time far under the byte time. bf16 q
//     times bf16 K, or times int8 K (exact in bf16), forms every product
//     exactly in the float32 sum, so only the order of sums differs from the
//     Pallas body's float32 dot; in int8 mode the K scale multiplies the
//     score after the dot (a float32 rounding of a few ulp), and V becomes
//     bf16(float(v) * scale) element by element before the product, the
//     Pallas order.
// (d) Each warp fills its own three-stage cp.async ring of 16-token K and V
//     tiles (16-byte copies; a tile lies in one page, so one table entry a
//     tile; entries past a row's end are never read; positions past the
//     split's end are zero-filled, so unwritten slots holding NaN never meet
//     a product). int8 tiles are converted to bf16 in the warp's own shared
//     buffer right before use. Shared rows are padded by 16 bytes, so
//     ldmatrix's 8 rows hit distinct banks. 109 KB (bf16) / 96 KB (int8) of
//     shared memory at D = 128: two blocks an SM, 12 tiles in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_merge.cuh"

namespace {

constexpr int NUM_THREADS = 128;
constexpr int WARPS = NUM_THREADS / 32;
constexpr int TILE = 16;            // tokens a warp takes of a step
constexpr int STEP = WARPS * TILE;  // tokens of one online-softmax update
constexpr int STAGES = 3;
constexpr int MAX_GROUP = 8;        // H / KV query rows one block serves
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

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

// Four int8 values in a word -> two bf16 pairs, each value times `scale`
// and rounded to bf16 (scale 1: exact).
__device__ __forceinline__ uint2 int8x4_bf16(uint32_t w, float scale) {
  const float f0 = __fmul_rn((float)(int8_t)(w & 0xffu), scale);
  const float f1 = __fmul_rn((float)(int8_t)((w >> 8) & 0xffu), scale);
  const float f2 = __fmul_rn((float)(int8_t)((w >> 16) & 0xffu), scale);
  const float f3 = __fmul_rn((float)(int8_t)(w >> 24), scale);
  return make_uint2(pack_bf16(f0, f1), pack_bf16(f2, f3));
}

// Shared memory of a block: Q (16 rows, bf16), the step's row maxima
// [2][WARPS][MAX_GROUP], then each warp's ring of STAGES staged K and V
// tiles (int8 mode: with their scales, then one bf16 K and V tile).
template <int D, bool QUANT>
struct V1Smem {
  static constexpr int PITCH = 2 * D + 16;                   // bytes of a bf16 row
  static constexpr int RAW_PITCH = QUANT ? D + 16 : PITCH;   // bytes of a staged row
  static constexpr int RAW = TILE * RAW_PITCH;               // one staged K or V tile
  static constexpr int SCALES = QUANT ? 2 * TILE * 4 : 0;    // K's, then V's
  static constexpr int STAGE = 2 * RAW + SCALES;
  static constexpr int CONV = QUANT ? 2 * TILE * PITCH : 0;  // bf16 K, then V
  static constexpr int WARP = STAGES * STAGE + CONV;
  static constexpr int Q = 16 * PITCH;
  static constexpr int RED = 2 * WARPS * MAX_GROUP * 4;
  static constexpr int BYTES = Q + RED + WARPS * WARP;
};

template <int D, bool QUANT>
__global__ void __launch_bounds__(NUM_THREADS, 2)
paged_v1_split_kernel(const uint16_t* __restrict__ q, const uint8_t* __restrict__ k_all,
                      const uint8_t* __restrict__ v_all, const float* __restrict__ ks_all,
                      const float* __restrict__ vs_all, const int* __restrict__ lengths,
                      const int* __restrict__ page_indices, float* __restrict__ part_o,
                      float* __restrict__ part_ml, int H, int KV, int n_slots, int page_size,
                      int max_pages, int layer, int chunk, int n_split, float scale) {
  using L = V1Smem<D, QUANT>;
  constexpr int ESIZE = QUANT ? 1 : 2;       // bytes of a staged element
  constexpr int CH = D * ESIZE / 16;         // 16-byte chunks of a staged row
  constexpr int PITCH = L::PITCH;
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;      // mma groupID, thread in group
  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: matrix, row within it
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n_tok = min(max(lengths[b], 0), max_pages * page_size);
  const int t_begin = split * chunk;
  if (t_begin >= n_tok) return;  // the merge reads only live splits
  const int t_end = min(t_begin + chunk, n_tok);
  const int G = H / KV;
  const int* table = page_indices + (size_t)b * max_pages;
  // Flat token index of this (layer, KV head)'s pool: [L, KV, n_slots, D].
  const size_t head_tok = ((size_t)layer * KV + kvh) * n_slots;

  uint8_t* Qs = smem;
  float* red = reinterpret_cast<float*>(smem + L::Q);
  uint8_t* wbuf = smem + L::Q + L::RED + warp * L::WARP;
  const uint32_t ring = smem_u32(wbuf);
  const int n_steps = (t_end - t_begin + STEP - 1) / STEP;

  // The warp's 16 tokens of a step into a ring stage: one table entry (a
  // tile lies in one page: page_size and every tile start are multiples of
  // 16), K and V rows, and in int8 mode their scales, 4 tokens a copy.
  auto load = [&](int step, int stage) {
    const int t0 = t_begin + step * STEP + warp * TILE;
    const uint32_t kdst = ring + stage * L::STAGE, vdst = kdst + L::RAW;
    size_t tile_tok = 0;
    if (t0 < t_end) tile_tok = head_tok + (size_t)table[t0 / page_size] * page_size + t0 % page_size;
#pragma unroll
    for (int i = lane; i < TILE * CH; i += 32) {
      const int row = i / CH, ch = i % CH;
      const bool ok = t0 + row < t_end;
      const size_t off = ok ? (tile_tok + row) * (D * ESIZE) + ch * 16 : 0;
      cp_async16(kdst + row * L::RAW_PITCH + ch * 16, k_all + off, ok ? 16 : 0);
      cp_async16(vdst + row * L::RAW_PITCH + ch * 16, v_all + off, ok ? 16 : 0);
    }
    if (QUANT && lane < 8) {  // lanes 0-3: K's scales, 4-7: V's
      const int j4 = (lane & 3) * 4;
      const int n_ok = max(0, min(4, t_end - (t0 + j4)));
      const float* src = (lane < 4 ? ks_all : vs_all) + (n_ok > 0 ? tile_tok + j4 : 0);
      cp_async16(kdst + 2 * L::RAW + (lane < 4 ? 0 : TILE * 4) + j4 * 4, src, n_ok * 4);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }

  // Q: the G query rows of this KV head, zero rows up to 16.
  for (int i = tid; i < 16 * (D / 8); i += NUM_THREADS) {
    const int r = i / (D / 8), ch = i % (D / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < G) val = *reinterpret_cast<const uint4*>(q + ((size_t)b * H + kvh * G + r) * D + ch * 8);
    *reinterpret_cast<uint4*>(Qs + r * PITCH + ch * 16) = val;
  }
  __syncthreads();
  uint32_t qa[D / 16][4];  // Q's A fragments, the same every step
  {
    const uint32_t qs = smem_u32(Qs);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      ldsm_x4(qa[kk], qs + (((mat & 1) << 3) + mrow) * PITCH + (2 * kk + (mat >> 1)) * 16);
  }

  // This thread's query row is g (rows g + 8 of the m16 tile are zero).
  float o[D / 8][4];
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
  float m = -INFINITY, l = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    if (step + STAGES - 1 < n_steps) load(step + STAGES - 1, (step + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const int stage = step % STAGES;
    const int t0 = t_begin + step * STEP + warp * TILE;
    uint32_t kb = ring + stage * L::STAGE, vb = kb + L::RAW;
    const float* ksc = nullptr;
    if constexpr (QUANT) {
      // int8 K -> bf16 (exact), int8 V -> bf16(v * its scale), into the
      // warp's bf16 tiles.
      const uint8_t* raw = wbuf + stage * L::STAGE;
      ksc = reinterpret_cast<const float*>(raw + 2 * L::RAW);
      const float* vsc = ksc + TILE;
      uint8_t* conv = wbuf + STAGES * L::STAGE;
#pragma unroll
      for (int i = lane; i < TILE * (D / 16); i += 32) {
        const int row = i / (D / 16), ch = i % (D / 16);
        const uint4 kr = *reinterpret_cast<const uint4*>(raw + row * L::RAW_PITCH + ch * 16);
        const uint4 vr = *reinterpret_cast<const uint4*>(raw + L::RAW + row * L::RAW_PITCH + ch * 16);
        const float vs = vsc[row];
        const uint2 k0 = int8x4_bf16(kr.x, 1.f), k1 = int8x4_bf16(kr.y, 1.f);
        const uint2 k2 = int8x4_bf16(kr.z, 1.f), k3 = int8x4_bf16(kr.w, 1.f);
        const uint2 v0 = int8x4_bf16(vr.x, vs), v1 = int8x4_bf16(vr.y, vs);
        const uint2 v2 = int8x4_bf16(vr.z, vs), v3 = int8x4_bf16(vr.w, vs);
        uint4* kd = reinterpret_cast<uint4*>(conv + row * PITCH + ch * 32);
        uint4* vd = reinterpret_cast<uint4*>(conv + TILE * PITCH + row * PITCH + ch * 32);
        kd[0] = make_uint4(k0.x, k0.y, k1.x, k1.y);
        kd[1] = make_uint4(k2.x, k2.y, k3.x, k3.y);
        vd[0] = make_uint4(v0.x, v0.y, v1.x, v1.y);
        vd[1] = make_uint4(v2.x, v2.y, v3.x, v3.y);
      }
      __syncwarp();
      kb = smem_u32(conv);
      vb = kb + TILE * PITCH;
    }

    // S = Q K^T: 16 rows x 16 tokens (two n8 tiles).
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, kb + (((mat >> 1) << 3) + mrow) * PITCH + (2 * kk + (mat & 1)) * 16);
      mma_bf16(sc[0], qa[kk], bk[0], bk[1]);
      mma_bf16(sc[1], qa[kk], bk[2], bk[3]);
    }

    // The scaled, masked scores of row g; the step's row max over the warps.
    float x[2][2], mx = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = nt * 8 + 2 * c + e;
        float s = sc[nt][e];
        if constexpr (QUANT) s = __fmul_rn(s, ksc[j]);
        s = __fmul_rn(s, scale);
        x[nt][e] = t0 + j < t_end ? s : MASK_VALUE;
        mx = fmaxf(mx, x[nt][e]);
      }
    mx = quad_max(mx);
    float* rs = red + (step & 1) * WARPS * MAX_GROUP;
    if (c == 0) rs[warp * MAX_GROUP + g] = mx;
    __syncthreads();
    float mt = rs[g];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) mt = fmaxf(mt, rs[w * MAX_GROUP + g]);
    const float mn = fmaxf(m, mt);
    float alpha = expf(m - mn);  // 0 at the first step
    if (isnan(alpha)) alpha = 0.f;
    float p[2][2], sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[nt][e] = t0 + nt * 8 + 2 * c + e < t_end ? expf(x[nt][e] - mn) : 0.f;
        sum += p[nt][e];
      }
    l = alpha * l + quad_sum(sum);
    m = mn;
#pragma unroll
    for (int nd = 0; nd < D / 8; ++nd) {
      o[nd][0] *= alpha;
      o[nd][1] *= alpha;
    }
    // P as bf16: the S accumulators are its A fragment (rows g + 8 zero).
    const uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), 0u, pack_bf16(p[1][0], p[1][1]), 0u};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vb + (((mat & 1) << 3) + mrow) * PITCH + (2 * np + (mat >> 1)) * 16);
      mma_bf16(o[2 * np], pa, bv[0], bv[1]);
      mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
    }
    __syncwarp();  // this stage is refilled STAGES - 1 steps on
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: reuse them to sum the warps

  float* wl = red;                                             // [WARPS][MAX_GROUP]
  float* acc = reinterpret_cast<float*>(smem + L::Q + L::RED);  // [MAX_GROUP][D]
  if (c == 0) wl[warp * MAX_GROUP + g] = l;
  for (int w = 0; w < WARPS; ++w) {  // in warp order: a fixed summation order
    if (warp == w && g < G) {
#pragma unroll
      for (int nd = 0; nd < D / 8; ++nd)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float* dst = acc + g * D + nd * 8 + 2 * c + e;
          *dst = w == 0 ? o[nd][e] : *dst + o[nd][e];
        }
    }
    __syncthreads();
  }
  const size_t row0 = (((size_t)b * KV + kvh) * n_split + split) * G;
  for (int i = tid; i < G * D; i += NUM_THREADS) part_o[row0 * D + i] = acc[i];
  if (warp == 0 && c == 0 && g < G) {  // every warp holds the same m
    float lb = 0.f;
    for (int w = 0; w < WARPS; ++w) lb += wl[w * MAX_GROUP + g];
    part_ml[(row0 + g) * 2] = m;
    part_ml[(row0 + g) * 2 + 1] = lb;
  }
}

template <int D, bool QUANT>
int launch(const void* q, const void* k_all, const void* v_all, const void* ks_all,
           const void* vs_all, const void* lengths, const void* page_indices, float* part_o,
           float* part_ml, void* out, int B, int H, int KV, int n_slots, int page_size,
           int max_pages, int layer, int chunk, int n_split, float scale, cudaStream_t st) {
  using L = V1Smem<D, QUANT>;
  static_assert(L::WARP * WARPS >= MAX_GROUP * D * 4, "the warps' sum must fit in the rings");
  auto kernel = paged_v1_split_kernel<D, QUANT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(n_split, KV, B), NUM_THREADS, L::BYTES, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint8_t*>(k_all),
      static_cast<const uint8_t*>(v_all), static_cast<const float*>(ks_all),
      static_cast<const float*>(vs_all), static_cast<const int*>(lengths),
      static_cast<const int*>(page_indices), part_o, part_ml, H, KV, n_slots, page_size,
      max_pages, layer, chunk, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = B * H;  // one query a row: kernel 2's merge at nq = 1
  paged_merge_kernel<false><<<(warps + 3) / 4, 128, 0, st>>>(
      part_o, part_ml, static_cast<const int*>(lengths), static_cast<uint16_t*>(out), B, 1, H,
      KV, D, max_pages * page_size, chunk, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <bool QUANT>
int dispatch(const void* q, const void* k_all, const void* v_all, const void* ks_all,
             const void* vs_all, const void* lengths, const void* page_indices, void* part_o,
             void* part_ml, void* out, int B, int H, int KV, int D, int n_slots, int page_size,
             int max_pages, int layer, int chunk, int n_split, float scale, void* stream) {
  if (B == 0) return 0;
  if (KV <= 0 || H % KV != 0 || H / KV > MAX_GROUP || page_size % TILE != 0 || chunk <= 0 ||
      chunk % STEP != 0 || chunk % page_size != 0 ||
      (long long)n_split * chunk < (long long)max_pages * page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  if (D == 128)
    return launch<128, QUANT>(q, k_all, v_all, ks_all, vs_all, lengths, page_indices, po, pml,
                              out, B, H, KV, n_slots, page_size, max_pages, layer, chunk,
                              n_split, scale, st);
  if (D == 64)
    return launch<64, QUANT>(q, k_all, v_all, ks_all, vs_all, lengths, page_indices, po, pml,
                             out, B, H, KV, n_slots, page_size, max_pages, layer, chunk, n_split,
                             scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// part_o / part_ml: float32 scratch of B * KV * n_split * (H / KV) * D and
// * 2 values; chunk a multiple of 64 and of page_size with n_split * chunk
// >= max_pages * page_size (paged_v1_split_plan).
extern "C" int dots_paged_attention_v1_bf16(const void* q, const void* k_all, const void* v_all,
                                            const void* lengths, const void* page_indices,
                                            void* part_o, void* part_ml, void* out, int B, int H,
                                            int KV, int D, int n_slots, int page_size,
                                            int max_pages, int layer, int chunk, int n_split,
                                            float sm_scale, void* stream) {
  return dispatch<false>(q, k_all, v_all, nullptr, nullptr, lengths, page_indices, part_o,
                         part_ml, out, B, H, KV, D, n_slots, page_size, max_pages, layer, chunk,
                         n_split, sm_scale, stream);
}

extern "C" int dots_paged_attention_v1_int8(const void* q, const void* k_all, const void* v_all,
                                            const void* k_scales_all, const void* v_scales_all,
                                            const void* lengths, const void* page_indices,
                                            void* part_o, void* part_ml, void* out, int B, int H,
                                            int KV, int D, int n_slots, int page_size,
                                            int max_pages, int layer, int chunk, int n_split,
                                            float sm_scale, void* stream) {
  return dispatch<true>(q, k_all, v_all, k_scales_all, v_scales_all, lengths, page_indices,
                        part_o, part_ml, out, B, H, KV, D, n_slots, page_size, max_pages, layer,
                        chunk, n_split, sm_scale, stream);
}
