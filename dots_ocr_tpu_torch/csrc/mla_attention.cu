// Paged latent decode (MLA) for Hopper (sm_90a): DeepSeek-V3's absorbed
// decode attention over a paged latent cache, split over the context and
// merged as kernel 2 (csrc/paged_attention.cu) is.
//
// Replaces no Pallas kernel: the JAX package runs dots.ocr's GQA decoder
// only. It was added for the multi-head latent attention of DeepSeek-V3's
// decoder (dots.vlm1). Each cached token holds ONE row of RANK + ROPE
// values (512 + 64: the RMS-normed latent and the rope key), shared by
// every head. In the absorbed decode each head's query is already taken
// into the latent space (q_nope W_UK, RANK wide) and carries its rope part
// (ROPE): the score of head h against token t is q[h] . row[t] over all
// RANK + ROPE values, and the head's output is the softmax-weighted sum of
// the rows' first RANK values (W_UV is applied afterwards, outside).
// Layouts: q [S, H, RANK + ROPE] bf16, one query row a slot; the layer's
// pool [num_pages * page_size, RANK + ROPE] bf16; page_tables [S,
// max_pages] int32; lengths [S] int32 (0: exact zeros); out [S, H, RANK].
//
// What bounds it on this card: a step reads each slot's context once (576 x
// 2 bytes a token) and does H x (576 + 512) x 2 operations a token: about
// 240 operations a byte at 128 heads, near the H100's bf16 ridge (295). So
// neither side may be wasted: every head that shares a latent row has to
// use it while it is on chip, on the tensor cores.
//
// What the design does about it:
// (a) The grid is (head block, split, slot). A block serves BH = 64 heads
//     (a head past H is a zero query row, never stored) over split j of the
//     slot's context, tokens [j chunk, (j + 1) chunk); chunk and n_split
//     come from static shapes (mla_split_plan in ops/mla_attention.py), so
//     a decode step never syncs with the host and is captured in CUDA
//     graphs. The head blocks of one (split, slot) are neighbours in the
//     grid, so the latent tile they share comes from L2 after its first
//     read. A block whose split starts past the slot's length exits at
//     once; the others write float32 partials (unnormalized O, and (m, l)
//     in the base-2 domain) and mla_latent_merge_kernel, launched right
//     after on the same stream, merges a slot's live splits.
// (b) The block's 64 query rows sit in shared memory; the context walks in
//     tiles of BN = 64 tokens through a two-stage cp.async ring (16-byte
//     copies gathered through the page table, zero-filled past the split's
//     end: an unwritten row may hold NaN, and 0 * NaN is NaN inside an mma),
//     so the next tile is in flight while one is consumed. Rows of 576
//     values are stored unpadded with their 16-byte chunks XOR-swizzled by
//     the row (chunk ^ (row & 7)), so ldmatrix's 8 rows hit distinct banks
//     and Q, two tiles and P fit in 227 KB; narrower rows whose chunks are
//     not a multiple of 8 are padded by 16 bytes instead.
// (c) Both products on the tensor cores (mma.sync m16n8k16 bf16 -> f32,
//     fragments through ldmatrix; not wgmma, whose 64-row A tiles leave no
//     room to split the 512-wide output between warps at these register
//     counts). Eight warps split each tile's work evenly:
//     scores: warp w computes heads 16 (w % 4).. x tokens 32 (w / 4).. over
//     all RANK + ROPE values, four independent accumulator chains (one an
//     n8 tile: a longer chain of dependent mma.sync would bound the tile by
//     its latency); the two warps of a head row exchange their
//     row maxima through shared memory, write P (bf16) to shared memory and
//     keep their own part of l;
//     values: warp w accumulates heads 32 (w / 4).. x latent values
//     (RANK / 4) (w % 4).., P from shared memory and the tile's first RANK
//     values through ldmatrix.trans (128 float accumulators a thread at
//     RANK = 512).
//     Three block barriers a tile: the tile has landed, the row maxima are
//     exchanged, P and the rescale factors are written.
// Shared memory at RANK = 512, ROPE = 64: 225.5 KB, one block an SM; 255
// registers a thread (nvcc -Xptxas -v, sm_90a; 20 bytes spilled). On an
// H100 at 64 slots x 128 heads over contexts of 1k-6k tokens it takes
// 0.39 ms a launch against a bound of 0.08 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BH = 64;        // heads a block
constexpr int BN = 64;        // tokens a tile
constexpr int STAGES = 2;     // the cp.async ring
constexpr int THREADS = 256;  // eight warps
constexpr float LOG2E = 1.4426950408889634f;
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

// Byte offset of 16-byte chunk `ch` of row `row` in a tile of CH chunks a
// row: XOR-swizzled where CH is a multiple of 8, else padded by a chunk.
template <int CH>
__device__ __forceinline__ uint32_t chunk_at(int row, int ch) {
  if constexpr (CH % 8 == 0)
    return static_cast<uint32_t>(row * CH * 16 + ((ch ^ (row & 7)) << 4));
  else
    return static_cast<uint32_t>(row * (CH + 1) * 16 + (ch << 4));
}

template <int RANK, int ROPE>
struct LatentSmem {
  static constexpr int WIDTH = RANK + ROPE;
  static constexpr int CH = WIDTH / 8;  // 16-byte chunks a row
  static constexpr int PITCH = (CH % 8 == 0 ? CH : CH + 1) * 16;  // bytes a row
  static constexpr int P_CH = BN / 8;   // P's chunks a row (swizzled)
  static constexpr int Q = BH * PITCH;
  static constexpr int RING = STAGES * BN * PITCH;
  static constexpr int P = BH * BN * 2;
  static constexpr int STATS = 6 * BH * 4;  // row maxima [2][BH], l [2][BH], alpha, m
  static constexpr int BYTES = Q + RING + P + STATS;
  static_assert(P_CH % 8 == 0 && BYTES <= 232448, "P swizzled, and 227 KB at most");
};

template <int RANK, int ROPE>
__global__ void __launch_bounds__(THREADS, 1)
mla_latent_decode_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ pool,
                         const int* __restrict__ lengths, const int* __restrict__ page_tables,
                         float* __restrict__ part_o, float* __restrict__ part_ml, int H,
                         int page_size, int max_pages, int chunk, int n_split,
                         float scale_log2) {
  using L = LatentSmem<RANK, ROPE>;
  constexpr int WIDTH = L::WIDTH;
  constexpr int CH = L::CH;
  constexpr int KS = WIDTH / 16;     // k steps of the scores
  constexpr int VD = RANK / 4;       // latent values a warp accumulates
  constexpr int VT = VD / 8;         // its n8 tiles
  static_assert(RANK % 64 == 0 && ROPE % 16 == 0, "RANK a multiple of 64, ROPE of 16");
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* Qs = smem;
  uint8_t* ring = smem + L::Q;
  uint8_t* Ps = ring + L::RING;
  float* red_max = reinterpret_cast<float*>(Ps + L::P);  // [2][BH]
  float* red_l = red_max + 2 * BH;                       // [2][BH]
  float* alpha_s = red_l + 2 * BH;                       // [BH]
  float* m_s = alpha_s + BH;                             // [BH]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, mat = lane >> 3;
  const int hb = blockIdx.x, split = blockIdx.y, s = blockIdx.z;
  const int n_tok = min(lengths[s], max_pages * page_size);
  const int t_begin = split * chunk;
  if (t_begin >= n_tok) return;  // the merge reads only live splits
  const int t_end = min(t_begin + chunk, n_tok);
  const int n_tiles = (t_end - t_begin + BN - 1) / BN;
  const int h0 = hb * BH;
  const int* table = page_tables + (size_t)s * max_pages;

  for (int i = tid; i < BH * CH; i += THREADS) {
    const int r = i / CH, ch = i % CH;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (h0 + r < H)
      val = *reinterpret_cast<const uint4*>(q + ((size_t)s * H + h0 + r) * WIDTH + ch * 8);
    *reinterpret_cast<uint4*>(Qs + chunk_at<CH>(r, ch)) = val;
  }

  // A tile's copies: 8 threads a row (128 contiguous bytes an instruction),
  // THREADS / 8 rows a pass; each thread looks its rows up in the page
  // table once, before it issues their copies.
  auto load = [&](int tile, int stage) {
    constexpr int ROWS_PASS = THREADS / 8, PASSES = BN / ROWS_PASS, KCH = (CH + 7) / 8;
    const int t0 = t_begin + tile * BN;
    const uint32_t dst = smem_u32(ring + stage * BN * L::PITCH);
    const uint16_t* src[PASSES];
#pragma unroll
    for (int ps = 0; ps < PASSES; ++ps) {
      const int pos = t0 + ps * ROWS_PASS + (tid >> 3);
      src[ps] = pool;
      if (pos < t_end)
        src[ps] += ((size_t)table[pos / page_size] * page_size + pos % page_size) * WIDTH;
    }
#pragma unroll
    for (int ps = 0; ps < PASSES; ++ps) {
      const int row = ps * ROWS_PASS + (tid >> 3);
      const bool ok = t0 + row < t_end;
#pragma unroll
      for (int k = 0; k < KCH; ++k) {
        const int ch = (tid & 7) + 8 * k;
        if (CH % 8 == 0 || ch < CH)
          cp_async16(dst + chunk_at<CH>(row, ch), src[ps] + (ok ? ch * 8 : 0), ok);
      }
    }
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load(st, st);
    cp_async_commit();
  }

  // Scores: heads sh0 + (g, g + 8), tokens th * 32 + (0..31) of the tile.
  const int sh0 = (warp & 3) * 16, th = warp >> 2;
  // Values: heads vh0 + mt * 16 + (g, g + 8), latent values vd0 + (0..VD).
  const int vh0 = (warp >> 2) * 32, vd0 = (warp & 3) * VD;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[2][VT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < VT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][nt][e] = 0.f;
  const uint32_t qs = smem_u32(Qs), ps = smem_u32(Ps);

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // the tile has landed; the previous tile's P is consumed
    if (tile + STAGES - 1 < n_tiles) load(tile + STAGES - 1, (tile + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint32_t kv = smem_u32(ring + (tile % STAGES) * BN * L::PITCH);
    const int t0 = t_begin + tile * BN;

    float sc[4][4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4];
      ldsm_x4(qa, qs + chunk_at<CH>(sh0 + ((mat & 1) << 3) + (lane & 7), 2 * kk + (mat >> 1)));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, kv + chunk_at<CH>(th * 32 + np * 16 + ((mat >> 1) << 3) + (lane & 7),
                                      2 * kk + (mat & 1)));
        mma_bf16(sc[2 * np], qa, bk[0], bk[1]);
        mma_bf16(sc[2 * np + 1], qa, bk[2], bk[3]);
      }
    }
    float mx[2] = {MASK_VALUE, MASK_VALUE};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = t0 + th * 32 + nt * 8 + 2 * c + (e & 1);
        const float x = tok < t_end ? sc[nt][e] * scale_log2 : MASK_VALUE;
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = quad_max(mx[hf]);
      if (c == 0) red_max[th * BH + sh0 + g + hf * 8] = mx[hf];
    }
    __syncthreads();  // the two token halves' row maxima
    float rs[2] = {0.f, 0.f}, alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = sh0 + g + hf * 8;
      const float mn = fmaxf(m[hf], fmaxf(mx[hf], red_max[(1 - th) * BH + r]));
      alpha[hf] = exp2f(m[hf] - mn);  // 0 on the first tile
      m[hf] = mn;
      if (th == 0 && c == 0) alpha_s[r] = alpha[hf];
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int tok = t0 + th * 32 + nt * 8 + 2 * c + (e & 1);
        const float p = tok < t_end ? exp2f(sc[nt][e] - m[e >> 1]) : 0.f;
        sc[nt][e] = p;
        rs[e >> 1] += p;
      }
      const int ch = th * 4 + nt, within = 4 * c;  // P's chunk and byte in it
      *reinterpret_cast<uint32_t*>(Ps + chunk_at<L::P_CH>(sh0 + g, ch) + within) =
          pack_bf16(sc[nt][0], sc[nt][1]);
      *reinterpret_cast<uint32_t*>(Ps + chunk_at<L::P_CH>(sh0 + g + 8, ch) + within) =
          pack_bf16(sc[nt][2], sc[nt][3]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + quad_sum(rs[hf]);
    __syncthreads();  // P and the rescale factors

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const float a0 = alpha_s[vh0 + mt * 16 + g], a1 = alpha_s[vh0 + mt * 16 + g + 8];
#pragma unroll
      for (int nt = 0; nt < VT; ++nt) {
        o[mt][nt][0] *= a0;
        o[mt][nt][1] *= a0;
        o[mt][nt][2] *= a1;
        o[mt][nt][3] *= a1;
      }
    }
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      uint32_t pa[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        ldsm_x4(pa[mt], ps + chunk_at<L::P_CH>(vh0 + mt * 16 + ((mat & 1) << 3) + (lane & 7),
                                               2 * ks + (mat >> 1)));
#pragma unroll
      for (int np = 0; np < VD / 16; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, kv + chunk_at<CH>(ks * 16 + ((mat & 1) << 3) + (lane & 7),
                                        vd0 / 8 + 2 * np + (mat >> 1)));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_bf16(o[mt][2 * np], pa[mt], bv[0], bv[1]);
          mma_bf16(o[mt][2 * np + 1], pa[mt], bv[2], bv[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (c == 0) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = sh0 + g + hf * 8;
      red_l[th * BH + r] = l[hf];
      if (th == 0) m_s[r] = m[hf];
    }
  }
  __syncthreads();
  const size_t base = ((size_t)s * n_split + split) * H + h0;  // + head in the block
  if (tid < BH && h0 + tid < H) {
    part_ml[(base + tid) * 2] = m_s[tid];
    part_ml[(base + tid) * 2 + 1] = red_l[tid] + red_l[BH + tid];
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = vh0 + mt * 16 + g + hf * 8;
      if (h0 + r >= H) continue;
      float* dst = part_o + (base + r) * RANK + vd0 + 2 * c;
#pragma unroll
      for (int nt = 0; nt < VT; ++nt)
        *reinterpret_cast<float2*>(dst + nt * 8) =
            make_float2(o[mt][nt][2 * hf], o[mt][nt][2 * hf + 1]);
    }
}

// One warp a (slot, head): the log-sum-exp merge of the slot's live splits
// in split order; exact zeros for a slot of length 0.
template <int RANK>
__global__ void mla_latent_merge_kernel(const float* __restrict__ part_o,
                                        const float* __restrict__ part_ml,
                                        const int* __restrict__ lengths,
                                        uint16_t* __restrict__ out, int S, int H, int cap,
                                        int chunk, int n_split) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= S * H) return;  // uniform across the warp
  const int s = w / H, h = w % H;
  const int n_live = (min(lengths[s], cap) + chunk - 1) / chunk;
  const size_t row0 = (size_t)s * n_split * H + h;  // split j: row0 + j * H
  float mb = -INFINITY;
  for (int j = 0; j < n_live; ++j) mb = fmaxf(mb, part_ml[(row0 + (size_t)j * H) * 2]);
  float lb = 0.f;
  for (int j = 0; j < n_live; ++j) {
    const size_t row = row0 + (size_t)j * H;
    lb += part_ml[row * 2 + 1] * exp2f(part_ml[row * 2] - mb);
  }
  const float inv = lb > 0.f ? 1.f / lb : 0.f;
  constexpr int PER = RANK / 32;
  float x[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) x[i] = 0.f;
  for (int j = 0; j < n_live; ++j) {
    const size_t row = row0 + (size_t)j * H;
    const float f = exp2f(part_ml[row * 2] - mb);
#pragma unroll
    for (int i = 0; i < PER; ++i) x[i] += part_o[row * RANK + lane + 32 * i] * f;
  }
  uint16_t* dst = out + ((size_t)s * H + h) * RANK;
#pragma unroll
  for (int i = 0; i < PER; ++i)
    dst[lane + 32 * i] = __bfloat16_as_ushort(__float2bfloat16_rn(x[i] * inv));
}

template <int RANK, int ROPE>
int launch(const void* q, const void* pool, const void* lengths, const void* page_tables,
           float* part_o, float* part_ml, void* out, int S, int H, int page_size, int max_pages,
           int chunk, int n_split, float scale_log2, cudaStream_t st) {
  auto kernel = mla_latent_decode_kernel<RANK, ROPE>;
  constexpr int smem = LatentSmem<RANK, ROPE>::BYTES;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((H + BH - 1) / BH, n_split, S), THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(pool),
      static_cast<const int*>(lengths), static_cast<const int*>(page_tables), part_o, part_ml, H,
      page_size, max_pages, chunk, n_split, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps = S * H;
  mla_latent_merge_kernel<RANK><<<(warps + 3) / 4, 128, 0, st>>>(
      part_o, part_ml, static_cast<const int*>(lengths), static_cast<uint16_t*>(out), S, H,
      max_pages * page_size, chunk, n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, pool, lengths, page_tables, part_o [S, n_split, H, rank] and part_ml
// [S, n_split, H, 2] (float32 scratch), out: the split kernel, then its
// merge, on `stream`. Takes (rank, rope) = (512, 64), DeepSeek-V3's, or
// (64, 16), a small test model's; chunk a positive multiple of the tile
// with n_split * chunk covering the table.
extern "C" int dots_mla_latent_decode_bf16(const void* q, const void* pool, const void* lengths,
                                           const void* page_tables, void* part_o, void* part_ml,
                                           void* out, int S, int H, int rank, int rope,
                                           int page_size, int max_pages, int chunk,
                                           int n_split, float sm_scale, void* stream) {
  if (chunk <= 0 || chunk % BN != 0 ||
      (long long)n_split * chunk < (long long)max_pages * page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* po = static_cast<float*>(part_o);
  auto* pml = static_cast<float*>(part_ml);
  const float scale_log2 = sm_scale * LOG2E;
  if (rank == 512 && rope == 64)
    return launch<512, 64>(q, pool, lengths, page_tables, po, pml, out, S, H, page_size,
                           max_pages, chunk, n_split, scale_log2, st);
  if (rank == 64 && rope == 16)
    return launch<64, 16>(q, pool, lengths, page_tables, po, pml, out, S, H, page_size,
                          max_pages, chunk, n_split, scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
