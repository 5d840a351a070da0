// Flash attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces the Pallas kernel dots_ocr_tpu/ops/flash_attention.py:
// flash_attention -> _flash_kernel (the pl.pallas_call at line 330).
// Same function: online-softmax attention over q [B, Tq, H, D] and
// k, v [B, S, KV, D] with GQA (query head h reads KV head h / (H / KV)),
// block-diagonal masking by segment id (-1 is padding and matches nothing;
// ids need not be sorted), an optional causal mask col <= row + q_offset,
// and exact zero output for a fully masked row (l == 0 -> 0, finite mask).
//
// What bounds it on this card: operations. At the serving shapes (T ~
// 1.4k-14k tokens, D = 128) attention does 4 D operations per (query, key)
// pair the masks keep and reads each K/V byte once per 128-row Q tile, far
// above the H100's ~295 FLOP/byte bf16 ridge: the tensor cores set the
// floor, and on the way to it the softmax's exp2 (the MUFU unit, 16 a
// clock per SM against the tensor cores' 2,048 bf16 FMA) and the tile
// bookkeeping between the two products are the costs to hide.
//
// The design that landed:
// (a) A tile list. A pre-pass (tile_info_kernel) reduces each 64-key tile
//     of kv_seg to (min id >= 0, max id, the id if the whole tile is one
//     segment with no -1). Each block (128 query rows of one head) then
//     builds, in one warp-parallel pass over those records, the list of KV
//     tiles it must visit, each marked masked or unmasked. A tile is
//     skipped when its id range cannot meet the Q tile's (an equal id
//     would lie in both ranges, so this is exact for unsorted ids) or when
//     it lies wholly above the causal diagonal; it is unmasked when Q tile
//     and KV tile are one and the same segment and the tile lies wholly at
//     or below the diagonal (the Pallas body's no_mask_needed): then no
//     segment id is read, no mask is computed, and p = 2^(s * scale - m) is
//     one FMA and one ex2. Skipped tiles cost nothing, and a Q tile of
//     padding rows only (a short row's tail) writes its zeros and reads no
//     Q, K or V.
// (b) A two-stage ring of K/V tiles in shared memory, filled by a producer
//     warp with 16-byte cp.async.cg copies (zero-filled past S) that
//     arrive on the stage's full mbarrier (cp.async.mbarrier.arrive); the
//     consumers release a stage on its empty mbarrier, so tile i + 1 loads
//     while tile i computes and no block-wide barrier is taken per tile.
//     Tiles use the 128-byte swizzle (16-byte chunk c of row r at chunk
//     c ^ (r % 8) of a 128-byte row; 64-column blocks stacked), the layout
//     wgmma's descriptors name.
// (c) wgmma.mma_async for both products: two consumer warpgroups, one per
//     64 query rows, 128 query rows per block, each walking the list on its
//     own. S = Q K^T as m64n64k16 with Q and K read from shared memory
//     through K-major descriptors; O += P V as m64nDk16 with P in
//     registers (re-packed as bf16 from the S accumulators) and V read
//     through an MN-major (transposed) descriptor. The base-2 softmax runs
//     on the f32 scores (sm_scale * log2(e) applied to them), with P
//     rounded to bf16 before P V and l summed from the unrounded p; the
//     rescale of O is skipped by a warp whose row maxima did not move.
//
// Registers and shared memory (nvcc -Xptxas -v, sm_90a, as chip_smoke.py
// prints them from the build log): 168 registers a thread at D = 128, 145
// at D = 64, no spills, 96 bytes of static shared memory; dynamic shared
// memory Q 128 x D + 2 stages x (K + V) 64 x D bf16 + the tile list (4
// bytes per 64 keys): 97 KB at D = 128 and S = 6,656, so one 288-thread
// block per SM (the registers allow no second one either).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 128;  // 2 warpgroups x 64 rows; 8 warps x 16 rows
constexpr int BLOCK_K = 64;
constexpr int CONSUMERS = 256;                // two warpgroups
constexpr int NUM_THREADS = CONSUMERS + 32;  // + one producer warp
// K/V stages: the producer fills one while the consumers read the other.
constexpr int STAGES = 2;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `ch` of row `r` in a swizzled tile of `rows`
// rows: 64-column (128-byte) blocks of rows x 128 bytes, chunk ^= row % 8.
__device__ __forceinline__ uint32_t swz(int r, int ch, int rows) {
  return (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(pred ? 16 : 0)
               : "memory");
}
// Waits until every cp.async copy this thread issued has landed. (Not
// cp.async.wait_group 0 alone: that waits only for committed groups, and
// copies never committed to a group are not waited for.)
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Arrives once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// wgmma, bf16 x bf16 -> f32. _ss: A and B from shared memory (both
// K-major); _rs_tb: A from registers, B MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
      "}, {%32,%33,%34,%35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs_tb(float (&d)[64], const uint32_t (&a)[4],
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
      "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
      "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
      "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
      "}, {%64,%65,%66,%67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Two floats -> bf16x2, the first in the low half (the lower index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ int warp_sum(int x) {
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

// One warp per (batch row, 64-key tile): {min id >= 0 (INT_MAX if none),
// max id (-1 if none), the id if all 64 keys lie in S and share it (else
// -1), 0}.
__global__ void tile_info_kernel(const int* __restrict__ kv_seg, int4* __restrict__ info, int B,
                                 int S, int n_kt) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (w >= B * n_kt) return;  // uniform across the warp
  const int b = w / n_kt, kt = w % n_kt;
  int lo = INT_MAX, hi = -1, nn = 0;
#pragma unroll
  for (int e = 0; e < BLOCK_K / 32; ++e) {
    const int s = kt * BLOCK_K + lane + 32 * e;
    const int id = s < S ? kv_seg[(size_t)b * S + s] : -1;
    if (id >= 0) {
      lo = min(lo, id);
      hi = max(hi, id);
      ++nn;
    }
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  nn = warp_sum(nn);
  if (lane == 0) info[w] = make_int4(lo, hi, (nn == BLOCK_K && lo == hi) ? lo : -1, 0);
}

template <int D>
struct Smem {
  static constexpr int Q_BYTES = BLOCK_Q * D * 2;
  static constexpr int KV_BYTES = BLOCK_K * D * 2;
  static constexpr int RING = Q_BYTES;  // ring offset
  static constexpr int LIST = Q_BYTES + STAGES * 2 * KV_BYTES;
  static size_t bytes(int n_kt) { return 1024 + LIST + 4 * (size_t)n_kt; }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(NUM_THREADS, 1)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, const int* __restrict__ q_seg,
                 const int* __restrict__ kv_seg, const int4* __restrict__ tinfo,
                 uint16_t* __restrict__ out, int Tq, int S, int H, int KV, int n_kt, int causal,
                 int q_offset, float scale_log2) {
  using L = Smem<D>;
  constexpr int CH = D / 8;  // 16-byte chunks per row
  extern __shared__ uint8_t smem_raw[];
  __shared__ int red[4][3];
  __shared__ int n_list;
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-aligned
  int* list = reinterpret_cast<int*>(smem_raw + (base - raw) + L::LIST);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // fragment row group / column pair
  const int wg = warp >> 2;               // warpgroup: query rows 64 wg .. 64 wg + 63
  // Longest (causal) Q tiles first.
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BLOCK_Q;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const size_t q_pitch = (size_t)H * D, kv_pitch = (size_t)KV * D;
  const uint16_t* qb = q + ((size_t)b * Tq * H + h) * D;
  const uint16_t* kb = k + ((size_t)b * S * KV + kvh) * D;
  const uint16_t* vb = v + ((size_t)b * S * KV + kvh) * D;

  // The Q tile's id range over ids >= 0, and its single id if all 128 rows
  // lie in Tq and share one.
  if (warp < 4) {
    const int t = q0 + tid;
    const int id = t < Tq ? q_seg[(size_t)b * Tq + t] : -1;
    const int lo = warp_min(id >= 0 ? id : INT_MAX), hi = warp_max(id);
    const int nn = warp_sum(id >= 0 ? 1 : 0);
    if (lane == 0) {
      red[warp][0] = lo;
      red[warp][1] = hi;
      red[warp][2] = nn;
    }
  }
  __syncthreads();
  const int q_lo = min(min(red[0][0], red[1][0]), min(red[2][0], red[3][0]));
  const int q_hi = max(max(red[0][1], red[1][1]), max(red[2][1], red[3][1]));
  const int q_uni =
      (red[0][2] + red[1][2] + red[2][2] + red[3][2] == BLOCK_Q && q_lo == q_hi) ? q_lo : -1;
  uint16_t* ob = out + ((size_t)b * Tq * H + h) * D;
  if (q_hi < 0) {  // padding rows only (a short row's tail): zeros, nothing read
    for (int i = tid; i < BLOCK_Q * CH; i += NUM_THREADS) {
      const int r = i / CH, ch = i % CH;
      if (q0 + r < Tq)
        *reinterpret_cast<uint4*>(ob + (q0 + r) * q_pitch + ch * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // Q tile -> shared memory (rows past Tq zero-filled), beside the list.
  for (int i = tid; i < BLOCK_Q * CH; i += NUM_THREADS) {
    const int r = i / CH, ch = i % CH;
    const bool ok = q0 + r < Tq;
    cp_async16(base + swz(r, ch, BLOCK_Q), ok ? qb + (q0 + r) * q_pitch + ch * 8 : qb, ok);
  }

  // The tile list, in key order. Causal: the tile's last row sees keys
  // <= q0 + 127 + q_offset.
  const int kv_end = causal ? min(S, q0 + BLOCK_Q + q_offset) : S;
  const int kt_end = kv_end > 0 ? (kv_end + BLOCK_K - 1) / BLOCK_K : 0;
  if (warp == 0) {
    int count = 0;
    for (int kt0 = 0; kt0 < kt_end; kt0 += 32) {
      const int kt = kt0 + lane;
      int entry = -1;
      if (kt < kt_end) {
        const int4 in = tinfo[(size_t)b * n_kt + kt];
        if (q_hi >= 0 && in.y >= 0 && q_lo <= in.y && in.x <= q_hi) {
          const bool unmasked = q_uni >= 0 && in.z == q_uni &&
                                (!causal || kt * BLOCK_K + BLOCK_K - 1 <= q0 + q_offset);
          entry = (kt << 1) | (unmasked ? 0 : 1);
        }
      }
      const unsigned run = __ballot_sync(0xffffffffu, entry >= 0);
      if (entry >= 0) list[count + __popc(run & ((1u << lane) - 1u))] = entry;
      count += __popc(run);
    }
    if (lane == 0) n_list = count;
  }
  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(smem_u32(&full_bar[st]), 32);          // the producer warp's lanes
      mbar_init(smem_u32(&empty_bar[st]), CONSUMERS);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cp_async_wait_all();  // Q
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int n_tiles = n_list;
  auto stage_k = [&](int it) { return base + L::RING + (it % STAGES) * 2 * L::KV_BYTES; };

  if (warp == CONSUMERS / 32) {
    // Producer warp: fills the stage of tile it once the consumers have
    // released the tile before it there, and has the copies arrive on the
    // stage's full barrier.
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES, round = it / STAGES;
      if (round > 0) mbar_wait(smem_u32(&empty_bar[st]), (round - 1) & 1);
      const uint32_t ks = stage_k(it), vs = ks + L::KV_BYTES;
      const int k0 = (list[it] >> 1) * BLOCK_K;
      const int ch = lane % CH;  // this lane's 16-byte chunk of every row it copies
#pragma unroll 4
      for (int r = lane / CH; r < BLOCK_K; r += 32 / CH) {
        const bool ok = k0 + r < S;
        const size_t off = ok ? (k0 + r) * kv_pitch + ch * 8 : 0;
        cp_async16(ks + swz(r, ch, BLOCK_K), kb + off, ok);
        cp_async16(vs + swz(r, ch, BLOCK_K), vb + off, ok);
      }
      mbar_arrive_cp_async(smem_u32(&full_bar[st]));
    }
    cp_async_wait_all();
    return;
  }

  // Consumers: each warpgroup walks the list on its own.
  // This thread's two query rows (fragment rows g, g + 8 of its warp's 16).
  const int r0 = warp * 16 + g, r1 = r0 + 8;
  const int seg0 = q0 + r0 < Tq ? q_seg[(size_t)b * Tq + q0 + r0] : -1;
  const int seg1 = q0 + r1 < Tq ? q_seg[(size_t)b * Tq + q0 + r1] : -1;
  const int pos0 = q0 + r0 + q_offset, pos1 = q0 + r1 + q_offset;
  // Running max (base 2, scaled) and this thread's share of the row sums
  // (its quad's four shares add up at the end).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    mbar_wait(smem_u32(&full_bar[it % STAGES]), (it / STAGES) & 1);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t ks = stage_k(it), vs = ks + L::KV_BYTES;

    // S = Q K^T: the warpgroup's 64 rows x BLOCK_K keys, Q and K K-major.
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          make_desc(base + (kk >> 2) * (BLOCK_Q * 128) + wg * 64 * 128 + (kk & 3) * 32, 16, 1024);
      const uint64_t db = make_desc(ks + (kk >> 2) * (BLOCK_K * 128) + (kk & 3) * 32, 16, 1024);
      wgmma_m64n64k16_ss(s, da, db, kk > 0 ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait0();

    // The online-softmax update, base 2.
    const int entry = list[it];
    float mn0, mn1;
    if (entry & 1) {  // masked tile: finite MASK_VALUE, p = 0 off the mask
      const int k0 = (entry >> 1) * BLOCK_K;
      uint32_t valid = 0u;  // bit 4j + e: element e of n-tile j
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + j * 8 + 2 * c + e;
          const int id = key < S ? __ldg(kv_seg + (size_t)b * S + key) : -1;
          const bool ok0 = id == seg0 && seg0 >= 0 && (!causal || key <= pos0);
          const bool ok1 = id == seg1 && seg1 >= 0 && (!causal || key <= pos1);
          valid |= (ok0 ? 1u : 0u) << (j * 4 + e);
          valid |= (ok1 ? 1u : 0u) << (j * 4 + 2 + e);
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const float x = ((valid >> i) & 1) ? s[i] * scale_log2 : MASK_VALUE;
        s[i] = x;
        if ((i & 3) < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
      mn0 = fmaxf(m0, quad_max(mx0));
      mn1 = fmaxf(m1, quad_max(mx1));
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = ((valid >> i) & 1) ? ex2(s[i] - ((i & 3) < 2 ? mn0 : mn1)) : 0.f;
    } else {  // unmasked: max of the raw scores, p = 2^(s * scale - m) in one FMA
      float mx0 = s[0], mx1 = s[2];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if ((i & 3) < 2) mx0 = fmaxf(mx0, s[i]); else mx1 = fmaxf(mx1, s[i]);
      }
      mn0 = fmaxf(m0, quad_max(mx0) * scale_log2);
      mn1 = fmaxf(m1, quad_max(mx1) * scale_log2);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        s[i] = ex2(fmaf(s[i], scale_log2, -((i & 3) < 2 ? mn0 : mn1)));
    }
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if ((i & 3) < 2) rs0 += s[i]; else rs1 += s[i];
    }
    l0 = l0 * a0 + rs0;
    l1 = l1 * a1 + rs1;
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {  // the max moved
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 3) < 2 ? a0 : a1;
    }

    // O += P V: P (bf16) in registers - the S accumulators of n-tiles 2t,
    // 2t + 1 are the A fragment of the 16-key step t; V MN-major, its
    // 64-column blocks BLOCK_K * 128 bytes apart (LBO), 8-key groups 1024 apart
    // (SBO).
    uint32_t pa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      pa[t][0] = pack_bf16(s[8 * t + 0], s[8 * t + 1]);
      pa[t][1] = pack_bf16(s[8 * t + 2], s[8 * t + 3]);
      pa[t][2] = pack_bf16(s[8 * t + 4], s[8 * t + 5]);
      pa[t][3] = pack_bf16(s[8 * t + 6], s[8 * t + 7]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const uint64_t db = make_desc(vs + t * 16 * 128, BLOCK_K * 128, 1024);
      if constexpr (D == 128) {
        wgmma_m64n128k16_rs_tb(o, pa[t], db, 1);
      } else {
        wgmma_m64n64k16_rs_tb(o, pa[t], db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    mbar_arrive(smem_u32(&empty_bar[it % STAGES]));
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * c;
    if (q0 + r0 < Tq)
      *reinterpret_cast<uint32_t*>(ob + (q0 + r0) * q_pitch + col) =
          pack_bf16(o[4 * nd] * inv0, o[4 * nd + 1] * inv0);
    if (q0 + r1 < Tq)
      *reinterpret_cast<uint32_t*>(ob + (q0 + r1) * q_pitch + col) =
          pack_bf16(o[4 * nd + 2] * inv1, o[4 * nd + 3] * inv1);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* q_seg, const void* kv_seg,
           void* tile_info, void* out, int B, int Tq, int S, int H, int KV, int causal,
           int q_offset, float sm_scale, cudaStream_t st) {
  const int n_kt = (S + BLOCK_K - 1) / BLOCK_K;
  const size_t smem = Smem<D>::bytes(n_kt);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* info = static_cast<int4*>(tile_info);
  const int warps = B * n_kt;
  tile_info_kernel<<<(warps + 3) / 4, 128, 0, st>>>(static_cast<const int*>(kv_seg), info, B,
                                                         S, n_kt);
  const dim3 grid((Tq + BLOCK_Q - 1) / BLOCK_Q, H, B);
  kernel<<<grid, NUM_THREADS, smem, st>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const int*>(q_seg),
      static_cast<const int*>(kv_seg), info, static_cast<uint16_t*>(out), Tq, S, H, KV, n_kt,
      causal, q_offset, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tile_info: int32 scratch of B * ceil(S / 64) * 4 values.
extern "C" int dots_flash_attention_bf16(const void* q, const void* k, const void* v,
                                         const void* q_seg, const void* kv_seg, void* tile_info,
                                         void* out, int B, int Tq, int S, int H, int KV, int D,
                                         int causal, int q_offset, float sm_scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128)
    return launch<128>(q, k, v, q_seg, kv_seg, tile_info, out, B, Tq, S, H, KV, causal, q_offset,
                       sm_scale, st);
  if (D == 64)
    return launch<64>(q, k, v, q_seg, kv_seg, tile_info, out, B, Tq, S, H, KV, causal, q_offset,
                      sm_scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
