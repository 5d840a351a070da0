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
// H100's ~295 bf16 ridge, so memory bound on paper (0.029 ms at 31 windows
// against 0.011 ms of products). In practice what a design has to keep out
// of the way is shared-memory traffic, instruction issue, and the time the
// tensor cores sit idle behind loads and the softmax.
//
// What the design does about it:
// (a) One 128-thread block, a warpgroup, per (window, head, 64 query rows).
//     At most 168 registers a thread and 67 KB of shared memory, so THREE
//     blocks share an SM and one block's loads and softmax hide behind the
//     others' products (the first design staged K and V whole, 139 KB: one
//     block per SM, and nothing computed until 128 KB had landed).
// (b) wgmma for both products: S = Q K^T as m64n64k16 per 64-key tile with
//     Q and K read from shared memory through K-major descriptors, O += P V
//     as m64nDk16 with P in registers and V, stored [key][D] like K, read
//     through an MN-major (transposed) descriptor: no transposed copy of V,
//     no ldmatrix, one shared-memory read of a tile for all 64 rows (an
//     mma.sync variant with ldmatrix operands read each tile once a warp,
//     four times a block, and spent a third of its instructions on it).
// (c) One pass, scores kept: the warpgroup's 64 x W float32 scores stay in
//     the accumulators (128 registers a thread at W = 256), so Q K^T runs
//     once. p is formed from the float32 s against the FINAL row max, l
//     sums the unrounded float32 p, and P is rounded to bf16 only as the A
//     operand of P V: the Pallas order of rounding, with no running max to
//     rescale. exp(x) is computed as 2^(x log2 e) by the special-function
//     unit (ex2.approx, 2 ulp), and O / l as O times one reciprocal a row.
// (d) K and V stream through a ring of three 64-key tiles (16 KB each at
//     D = 128) filled by cp.async, one commit group and one block barrier
//     a tile, read strided
//     straight from the [nw, W, H, D] layout (no head-major copy): the
//     block starts Q K^T on the first K tile while the rest are in flight,
//     and V tiles land during the last K tiles and the softmax. Tiles use
//     the 128-byte swizzle wgmma's descriptors name (16-byte chunk c of row
//     r at chunk c ^ (r % 8) of its 64-column block). The four blocks of a
//     (window, head) read the same K and V; they are launched side by side
//     so the repeats are L2 hits.
// (e) The output tile goes back through shared memory (the warp's own Q
//     rows) and is written as 16-byte row segments.
// Registers (nvcc -Xptxas -v, sm_90a): 168 a thread at W = 256 (the cap for
// three blocks), 86 to 152 at the shorter windows, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NUM_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int TILE = 64;          // keys per ring tile, query rows per block
constexpr int STAGES = 3;
constexpr float MASK_VALUE = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
// Makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy wgmma reads through.
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// 2^x by the special-function unit (2 ulp; denormal results flush to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Byte offset of 16-byte chunk `ch` of row `row` in a 64-row swizzled tile:
// 64-column (128-byte) blocks of 64 x 128 bytes, chunk ^= row % 8.
__device__ __forceinline__ uint32_t swz(int row, int ch) {
  return static_cast<uint32_t>((ch >> 3) * (64 * 128) + row * 128 + (((ch & 7) ^ (row & 7)) << 4));
}

// NT = W / 64 key tiles. Shared memory (1,024-byte aligned: the swizzle's
// atom): the block's Q tile, then STAGES ring tiles, each 64 rows x D bf16
// swizzled, then W key-validity flags.
template <int D, int NT>
__global__ void __launch_bounds__(NUM_THREADS, 3)
window_attention_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v, const int* __restrict__ seg,
                        uint16_t* __restrict__ out, int H, float scale_log2) {
  constexpr int W = NT * TILE;
  constexpr int CH = D / 8;                // 16-byte chunks a row
  constexpr int TILE_BYTES = TILE * D * 2;
  constexpr int N_TILES = 2 * NT;          // K tiles, then V tiles
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* q_tile = smem_raw + (q_s - smem_u32(smem_raw));
  const uint32_t ring = q_s + TILE_BYTES;
  int* valid_s = reinterpret_cast<int*>(q_tile + (1 + STAGES) * TILE_BYTES);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;  // accumulator fragment row group / column pair
  const int qb = blockIdx.x % NT, h = blockIdx.x / NT, w = blockIdx.y;
  const size_t pitch = (size_t)H * D;  // elements between consecutive tokens
  const size_t base = (size_t)w * W * pitch + (size_t)h * D;

  // One 64-row tile, global rows row0.. of `src`, into swizzled shared memory.
  auto load_tile = [&](const uint16_t* src, int row0, uint32_t dst) {
#pragma unroll
    for (int i = tid; i < TILE * CH; i += NUM_THREADS) {
      const int row = i / CH, ch = i % CH;
      cp_async16(dst + swz(row, ch), src + base + (size_t)(row0 + row) * pitch + ch * 8);
    }
  };
  auto load_kv = [&](int t) {
    load_tile(t < NT ? k : v, (t % NT) * TILE, ring + (t % STAGES) * TILE_BYTES);
  };

  load_tile(q, qb * TILE, q_s);
  cp_async_commit();
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < N_TILES) load_kv(t);
    cp_async_commit();
  }
  for (int i = tid; i < W; i += NUM_THREADS) valid_s[i] = seg[(size_t)w * W + i] >= 0;

  // s[t][4 j + e]: key t * 64 + j * 8 + 2c + (e & 1) of row warp * 16 + g
  // (e < 2) or + 8; o likewise over the D columns.
  float s[NT][32];
  float o[D / 2];
  uint32_t pa[NT][4][4];  // P as bf16 A fragments, one per 16-key step
  float l0 = 0.f, l1 = 0.f;

#pragma unroll
  for (int t = 0; t < N_TILES; ++t) {
    // One group was committed per tile so far, after Q's: tile t is group
    // t + 1 of STAGES + t, so at most STAGES - 2 younger groups may be
    // pending (Q's, the oldest, has landed with tile 0). After the barrier
    // every warp has the tile and is done with the one before, whose stage
    // takes the tile STAGES - 1 ahead.
    cp_async_wait<STAGES - 2>();
    fence_async_proxy();
    __syncthreads();
    if (t + STAGES - 1 < N_TILES) load_kv(t + STAGES - 1);
    cp_async_commit();
    const uint32_t tile = ring + (t % STAGES) * TILE_BYTES;
    if (t < NT) {
      // S = Q K^T for keys [64 t, 64 t + 64): Q and K K-major, 16 columns
      // (32 bytes of a 64-column block) a step.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * (TILE * 128) + (kk & 3) * 32;
        wgmma_m64n64k16_ss(s[t], make_desc(q_s + off, 16, 1024), make_desc(tile + off, 16, 1024),
                           kk > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait0();
      if (t == NT - 1) {
        // Every score is here: mask, the final row max, p, l, P as bf16.
        float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
        for (int tt = 0; tt < NT; ++tt)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int2 ok = *reinterpret_cast<const int2*>(&valid_s[tt * TILE + j * 8 + 2 * c]);
            s[tt][4 * j + 0] = ok.x ? s[tt][4 * j + 0] * scale_log2 : MASK_VALUE;
            s[tt][4 * j + 1] = ok.y ? s[tt][4 * j + 1] * scale_log2 : MASK_VALUE;
            s[tt][4 * j + 2] = ok.x ? s[tt][4 * j + 2] * scale_log2 : MASK_VALUE;
            s[tt][4 * j + 3] = ok.y ? s[tt][4 * j + 3] * scale_log2 : MASK_VALUE;
            m0 = fmaxf(m0, fmaxf(s[tt][4 * j + 0], s[tt][4 * j + 1]));
            m1 = fmaxf(m1, fmaxf(s[tt][4 * j + 2], s[tt][4 * j + 3]));
          }
        m0 = quad_max(m0);
        m1 = quad_max(m1);
#pragma unroll
        for (int tt = 0; tt < NT; ++tt) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            s[tt][i] = ex2(s[tt][i] - ((i & 3) < 2 ? m0 : m1));
            if ((i & 3) < 2) l0 += s[tt][i]; else l1 += s[tt][i];
          }
          // The S accumulators of n-tiles 2u, 2u + 1 are the A fragment of
          // the 16-key step u.
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            pa[tt][u][0] = pack_bf16(s[tt][8 * u + 0], s[tt][8 * u + 1]);
            pa[tt][u][1] = pack_bf16(s[tt][8 * u + 2], s[tt][8 * u + 3]);
            pa[tt][u][2] = pack_bf16(s[tt][8 * u + 4], s[tt][8 * u + 5]);
            pa[tt][u][3] = pack_bf16(s[tt][8 * u + 6], s[tt][8 * u + 7]);
          }
        }
        l0 = quad_sum(l0);
        l1 = quad_sum(l1);
      }
    } else {
      // O += P V for keys [64 (t - NT), + 64): V MN-major, its 64-column
      // blocks TILE * 128 bytes apart (LBO), 8-key groups 1,024 apart (SBO).
      if (t == NT) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      }
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint64_t dv = make_desc(tile + u * 16 * 128, TILE * 128, 1024);
        if constexpr (D == 128) {
          wgmma_m64n128k16_rs_tb(o, pa[t - NT][u], dv, 1);
        } else {
          wgmma_m64n64k16_rs_tb(o, pa[t - NT][u], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait0();
    }
  }
  cp_async_wait<0>();

  // O / l (one division a row, then products) as bf16 into this warp's own
  // rows of the Q tile (no other warp touches them, and the products that
  // read Q have long completed), then 16-byte row segments to global memory.
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int r0 = warp * 16 + g, r1 = r0 + 8;
    *reinterpret_cast<uint32_t*>(q_tile + swz(r0, nd) + 4 * c) =
        pack_bf16(o[4 * nd] * inv0, o[4 * nd + 1] * inv0);
    *reinterpret_cast<uint32_t*>(q_tile + swz(r1, nd) + 4 * c) =
        pack_bf16(o[4 * nd + 2] * inv1, o[4 * nd + 3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * CH; i += 32) {
    const int row = warp * 16 + i / CH, ch = i % CH;
    const uint4 val = *reinterpret_cast<const uint4*>(q_tile + swz(row, ch));
    *reinterpret_cast<uint4*>(out + base + (size_t)(qb * TILE + row) * pitch + ch * 8) = val;
  }
}

template <int D, int NT>
int launch(const uint16_t* q, const uint16_t* k, const uint16_t* v, const int* seg,
           uint16_t* out, int nw, int H, float scale_log2, cudaStream_t st) {
  const size_t smem = 1024 + (size_t)(1 + STAGES) * TILE * D * 2 + NT * TILE * sizeof(int);
  auto kernel = window_attention_kernel<D, NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(NT * H, nw), NUM_THREADS, smem, st>>>(q, k, v, seg, out, H, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_nt(const uint16_t* q, const uint16_t* k, const uint16_t* v, const int* seg,
              uint16_t* out, int nw, int W, int H, float scale_log2, cudaStream_t st) {
  switch (W / TILE) {
    case 1: return launch<D, 1>(q, k, v, seg, out, nw, H, scale_log2, st);
    case 2: return launch<D, 2>(q, k, v, seg, out, nw, H, scale_log2, st);
    case 3: return launch<D, 3>(q, k, v, seg, out, nw, H, scale_log2, st);
    case 4: return launch<D, 4>(q, k, v, seg, out, nw, H, scale_log2, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int dots_window_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* seg, void* out, int nw, int W, int H,
                                          int D, float sm_scale, void* stream) {
  if (W <= 0 || W % TILE != 0 || W > 4 * TILE) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const uint16_t*>(q);
  const auto* kp = static_cast<const uint16_t*>(k);
  const auto* vp = static_cast<const uint16_t*>(v);
  const auto* sp = static_cast<const int*>(seg);
  auto* op = static_cast<uint16_t*>(out);
  const float scale_log2 = sm_scale * LOG2E;
  if (D == 128) return launch_nt<128>(qp, kp, vp, sp, op, nw, W, H, scale_log2, st);
  if (D == 64) return launch_nt<64>(qp, kp, vp, sp, op, nw, W, H, scale_log2, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
