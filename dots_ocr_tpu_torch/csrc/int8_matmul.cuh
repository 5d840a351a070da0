// W8A16 matmul for Hopper (sm_90a): bf16 activations against int8
// weight-only weights with a float32 scale per output column. The kernel
// and its launch; int8_matmul.cu holds the C entry, the tensor maps and the
// dispatch, and int8_matmul_{kn1,kn2,nk}.cu instantiate the tiles (one nvcc
// each, built in parallel).
//
// No Pallas kernel to replace: the JAX package computes the same function
// as einsum(x, q.astype(bf16)) * s (dots_ocr_tpu/models/layers.py:62-67,
// linear; :101-108, unembed), and XLA fuses the convert into the dot's
// operand read. Same function, two layouts:
//   linear  (KN): x [M, K] bf16 . q [K, N] int8 (N contiguous), the float32
//                 sum times scale[n], plus the optional bias[n] (float32
//                 or bf16), rounded to bf16 (or float32 with out_f32);
//   unembed (NK): x [M, K] bf16 . q [N, K]^T (K contiguous: the tied
//                 embedding [vocab, d]), the float32 sum times scale[n],
//                 returned as float32.
// int8 -> bf16 is exact (below, s8x2_bf16), so the only difference from
// the plain version (ops/int8_matmul.py) is the order of the float32 sums.
// Scale, bias and the cast run in the epilogue, in that order.
//
// What bounds it on this card: the flagship decoder's linears and tied
// lm_head hold 1.54 GB of int8 weights, each byte used for 2 M FLOPs. Up
// to M ~ 150 the read of the weights bounds a call (1.54 GB a step: 0.46 ms
// at 3.35 TB/s); at a k = 2 verify (M = 192) the bf16 tensor cores do (0.60
// ms), and a 2,048-row prefill chunk is far on the compute side. The
// earlier design lost to cuBLAS bf16 on a converted weight in both
// regimes: up to 192 rows its mma.sync kernel read the weights once per row
// tile (three times at 192 rows), every column tile re-read x, its loads
// were 16-byte cp.async issued by the consumers, and above 192 rows it
// converted each weight tile into a bf16 shared-memory tile before wgmma
// could read it.
//
// This kernel computes the transposed product out^T = q^T x^T with wgmma
// in both regimes:
// - The converted weight is wgmma's A operand, built in registers: output
//   columns are A's 64 rows, the contraction its k. x's rows are wgmma's N
//   (RT, a multiple of 8: every row of a decode or verify step in one tile,
//   8 for one slot, 64, 192; 128-row tiles above 192 rows) and x [M, K] is
//   already the K-major B operand, read from shared memory through a
//   descriptor. So at M <= 192 one CTA's column tile serves every row and
//   each weight byte is read from HBM once a call.
// - A thread (g, c) of warp w takes the four output columns of word q =
//   8 w + g of its warpgroup's 128 ([K, N]: columns 4q .. 4q + 3, whose
//   epilogue stores are 4 consecutive values; [N, K]: columns q + 32 s,
//   which keeps its 16-byte row loads conflict-free). A k16 step needs the
//   column's bytes at k = 2c, 2c + 1, 2c + 8, 2c + 9: [K, N] loads the four
//   words of those rows and one byte permute a pair gathers a column's two
//   bytes; [N, K] loads the column's 16 bytes and picks the four. The four
//   converted columns are the A fragments of two m64 tiles (rows g and
//   g + 8 of tile t: columns 2t and 2t + 1 of the thread's four); the
//   epilogue puts the columns back.
// - Loads: a producer warp keeps a ring of 4-8 stages (by tile size) of
//   64-deep contraction blocks in flight by TMA, through full / empty
//   mbarriers: x's RT x 64 slice and the weight tile ([K, N]: 64 x 128 bytes
//   a warpgroup; [N, K]: 128 rows x 64 bytes), 128- and 64-byte swizzled,
//   so the fragment loads hit distinct banks. Rows of x past M arrive as
//   zeros (the tensor map's bounds) and are never stored.
// - The consumers convert the fragments of the next one or two k16 steps
//   while the current ones' products run (A registers double-buffered,
//   wgmma.wait_group 1), with every instruction that defines them pinned
//   before the wgmma.fence, so that ptxas keeps the products asynchronous.
// - A CTA has one consumer warpgroup of 128 columns (two CTAs an SM up to
//   96 rows), or two: of 128 columns each (prefill: x shared by 256
//   columns), or splitting the contraction of the same 128 columns (long
//   contractions: down in prefill), added in warpgroup order at the end.
//   At decode the plan's launch depends on the weight's shape alone, so a
//   row's sums are taken in one order at every decode row count.
// - Shapes with few column tiles (wk / wv: N = 256; wq / wo and down: 12
//   tiles of 128) also split the contraction over the ranks of a thread
//   block cluster (<= 8, from the plan): each rank writes its float32
//   tiles into its own shared memory, and after a cluster barrier every
//   rank adds an even share of the tile over the ranks in rank order
//   through distributed shared memory, applies the epilogue and stores:
//   one launch, no float32 partials in device memory, bit-identical repeats.
// What holds it now (PERF.md; kernel_ab.py's ablation and sweep, one H100):
// at decode no single part: taking out the loads, the products or the
// convert each saves 5-15%, and a CTA's time is its serial chain of
// batches (one warpgroup an SM waits on each batch's products) plus a
// fixed 2-4 us of launch, pipeline fill and the cluster reduction's
// barriers; at the prefill tiles the products and their convert chain
// (without loads it keeps 95% of its time). Left out: TMA multicast of x
// across a cluster, setmaxnreg (ptxas sized a two-warpgroup CTA as three
// warpgroups, so the producer's release could not cover the consumers'
// raise), persistent CTAs; splitting the 192-row tile's rows between two
// warpgroups ran slower (their converts duplicate).

#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace w8a16 {

// Internal linkage: each library built from these sources (kernel_ab.py's
// ablation loads several in one process) keeps its own kernels and its own
// once-a-device state.
namespace {

namespace cg = cooperative_groups;

constexpr int KB = 64;              // contraction rows of a ring stage
constexpr int COLS = 128;           // output columns of a consumer warpgroup
constexpr int W_BYTES = KB * COLS;  // a warpgroup's weight tile of a stage
constexpr int MAX_STAGES = 8;
constexpr int MAX_CLUSTER = 8;

// How a CTA's CW consumer warpgroups share its tile: 128 columns each
// (COLUMNS: a 128 CW-column tile), or the same 128 columns and every CW-th
// contraction block each (CONTRACTION: summed in warpgroup order at the
// end).
enum Split : int { COLUMNS = 0, CONTRACTION = 1 };

// A CTA of CW consumer warpgroups and one producer warp, RT rows of x.
// Two CTAs an SM for the small one-warpgroup tiles (a ring of <= 100 KB
// each), one otherwise (<= 200 KB). The float32 tiles of the reductions
// reuse the ring.
template <int RT, int CW, int MODE>
struct Config {
  static constexpr int THREADS = 128 * CW + 32;
  static constexpr int BN = MODE == COLUMNS ? COLS * CW : COLS;  // output columns of a CTA
  static constexpr int WT = MODE == COLUMNS ? CW : 1;            // weight tiles of a stage
  static constexpr int READERS = MODE == CONTRACTION ? 4 : 4 * CW;  // warps that read a stage
  static constexpr int MIN_BLOCKS = (CW == 1 && RT <= 96) ? 2 : 1;
  static constexpr int X_BYTES = RT * 128;  // RT rows x 64 bf16
  static constexpr int STAGE = X_BYTES + WT * W_BYTES;
  static constexpr int BUDGET = (MIN_BLOCKS == 2 ? 100 : 200) * 1024;
  static constexpr int STAGES = BUDGET / STAGE < MAX_STAGES ? BUDGET / STAGE : MAX_STAGES;
  static constexpr int RP = BN + 4;         // floats of a row of a reduction tile (padded)
  static constexpr int PARTS = MODE == CONTRACTION ? CW : 1;  // the CTA's float32 tiles
  static constexpr int RED = PARTS * RT * RP * 4;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = (RING > RED ? RING : RED) + 1024;  // + the swizzle atom's alignment
  // k16 steps converted together (registers: the 192-row tile's
  // accumulators leave room for one, double-buffered).
  static constexpr int BATCH = RT >= 192 || (CW == 2 && RT >= 128) ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}
// Waits for the phase of parity `parity` to complete. A pipeline fault
// (a wait that can never end) traps after ~2^32 cycles instead of hanging
// the card: the launch then fails with an error the wrapper raises.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// A 2-D tile of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Every thread of the cluster (producer warps included) arrives, then waits:
// with release / acquire, so that shared memory written before is visible to
// the cluster after; relaxed, only to hold every rank until all arrive (the
// release would also wait for this thread's global stores).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\nbarrier.cluster.wait;\n" ::: "memory");
}
// The consumer warpgroups' own barrier (the producer warp is not in it).
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for an A fragment: every instruction that defines it runs before
// the wgmma.fence that opens the products' window.
__device__ __forceinline__ void fence_frag(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// wgmma m64nNk16, bf16 x bf16 -> f32: A (the converted weight) from
// registers, B (x's rows, K-major, 128-byte swizzled) through `desc`.
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3"
        "}, {%4,%5,%6,%7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7"
        "}, {%8,%9,%10,%11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15"
        "}, {%16,%17,%18,%19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31"
        "}, {%32,%33,%34,%35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<96> {
  __device__ static __forceinline__ void mma(float (&d)[48], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47"
        "}, {%48,%49,%50,%51}, %52, p, 1, 1, 0;\n}\n"
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
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63"
        "}, {%64,%65,%66,%67}, %68, p, 1, 1, 0;\n}\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], const uint32_t (&a)[4],
                                              uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
        "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
        "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
        "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,"
        "%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,"
        "%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95"
        "}, {%96,%97,%98,%99}, %100, p, 1, 1, 0;\n}\n"
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
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

// Two signed bytes -> two bf16, exactly: bytes 0 and 2 of t (the others
// are ignored) become the low and high element. With s the byte's sign
// bit, b = (128 + (b & 0x7f)) - (128 + 128 s): both terms are bf16 with
// exponent 7 (0x4300 | (b & 0x7f), and 0x4300 | (b & 0x80), which is 256
// when s is set), and their difference, an integer in [-128, 127], is
// exact. Two lop3 (the constant 0x43004300 in register k) and one bf16x2
// subtract.
template <uint32_t MASK>
__device__ __forceinline__ uint32_t and_or(uint32_t t, uint32_t k) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(t), "n"(MASK), "r"(k));  // (t & MASK) | k
  return r;
}
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t t, uint32_t k) {
  uint32_t v = and_or<0x007F007Fu>(t, k), s = and_or<0x00800080u>(t, k);
#ifdef W8A16_ABLATE_NO_CONVERT  // kernel_ab.py's ablation: the bytes passed on unconverted
  return v;
#endif
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                             *reinterpret_cast<const __nv_bfloat162*>(&s));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// The byte-permute selector that puts byte j of x in byte 0 and byte j of y
// in byte 2.
__host__ __device__ constexpr uint32_t pair_sel(int j) {
  return static_cast<uint32_t>(j | j << 4 | (4 + j) << 8 | (4 + j) << 12);
}

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// The bias of two consecutive output columns n, n + 1 as float32 (exact
// from bf16).
__device__ __forceinline__ float2 bias2(const void* bias, int bias_bf16, int n) {
  if (bias_bf16) {
    const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(static_cast<const uint16_t*>(bias) + n));
    return make_float2(bf_lo(w), bf_hi(w));
  }
  return __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(bias) + n));
}

// The epilogue of four consecutive output columns n..n+3 of one row:
// sum * scale (+ bias), stored as bf16 or float32.
__device__ __forceinline__ void store4(float4 v, const float* __restrict__ scale,
                                       const void* __restrict__ bias, int bias_bf16, void* out,
                                       int out_f32, size_t row, int N, int n) {
  const float4 s = __ldg(reinterpret_cast<const float4*>(scale + n));
  v.x = __fmul_rn(v.x, s.x);
  v.y = __fmul_rn(v.y, s.y);
  v.z = __fmul_rn(v.z, s.z);
  v.w = __fmul_rn(v.w, s.w);
  if (bias != nullptr) {
    const float2 b0 = bias2(bias, bias_bf16, n), b1 = bias2(bias, bias_bf16, n + 2);
    v.x = __fadd_rn(v.x, b0.x);
    v.y = __fadd_rn(v.y, b0.y);
    v.z = __fadd_rn(v.z, b1.x);
    v.w = __fadd_rn(v.w, b1.y);
  }
  if (out_f32) {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + row * N + n) = v;
  } else {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + row * N + n) = make_uint2(
        *reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// grid (C, N / BN, row tiles of RT), cluster (C, 1, 1): rank r takes the
// contraction's 64-deep blocks [r nkb / C, (r + 1) nkb / C). Warps 0 .. 4 CW - 1
// consume (warpgroup wg: the tile's columns 128 wg ..), warp 4 CW produces.
template <bool NK, int RT, int CW, int MODE>
__global__ void __launch_bounds__(Config<RT, CW, MODE>::THREADS, Config<RT, CW, MODE>::MIN_BLOCKS)
w8a16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
             const float* __restrict__ scale, const void* __restrict__ bias,
             void* __restrict__ out, int M, int K, int N, int out_f32, int bias_bf16) {
  using C = Config<RT, CW, MODE>;
  constexpr int STAGES = C::STAGES;
  constexpr bool KS = MODE == CONTRACTION;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[MAX_STAGES], empty_bar[MAX_STAGES];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (base - smem_u32(smem_raw));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_ranks = static_cast<int>(cluster.num_blocks());
  const int n0 = blockIdx.y * C::BN, m0 = blockIdx.z * RT;
  const int blocks = K / KB;
  const int kb0 = rank * blocks / n_ranks;
  const int nkb = (rank + 1) * blocks / n_ranks - kb0;  // this rank's blocks
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);              // the producer's arrive + bytes
      mbar_init(smem_u32(&empty_bar[s]), C::READERS);  // every warp that reads the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * CW) {
    // Producer: block i into stage i % STAGES once the consumers have
    // released the block before it there.
    if (lane == 0) {
      for (int i = 0; i < nkb; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(smem_u32(&empty_bar[st]), (i / STAGES - 1) & 1);
        const uint32_t full = smem_u32(&full_bar[st]);
        const uint32_t xs = base + st * C::STAGE, ws = xs + C::X_BYTES;
        const int k0 = (kb0 + i) * KB;
#ifdef W8A16_ABLATE_NO_TMA_WAIT  // kernel_ab.py's ablation: no loads, nothing to wait for
        mbar_arrive(full);
        continue;
#endif
        mbar_expect_tx(full, C::STAGE);
        tma_load_2d(xs, &xmap, k0, m0, full);
        if constexpr (NK) {
          tma_load_2d(ws, &wmap, k0, n0, full);
        } else {
#pragma unroll
          for (int b = 0; b < C::WT; ++b)
            tma_load_2d(ws + b * W_BYTES, &wmap, n0 + b * COLS, k0, full);
        }
      }
    }
    if (n_ranks > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync_relaxed();
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3, g = lane >> 2, c = lane & 3;
  const int q = 8 * w + g;
  // [K, N]: this thread's word q of weight rows 2c (+ 8) and 2c + 1 (+ 8):
  // 16-byte chunk q / 4 XOR the row's index in its 8-row swizzle atom.
  const uint32_t kn_off0 = (((q >> 2) ^ (2 * c)) << 4) | ((q & 3) << 2);
  const uint32_t kn_off1 = (((q >> 2) ^ (2 * c + 1)) << 4) | ((q & 3) << 2);
  // [N, K]: rows 32 s + q (64 bytes each), chunk XOR (row / 2) % 4; bytes
  // 2c, 2c + 1 of the chunk's word c / 2 and 2c + 8, 2c + 9 of word 2 + c / 2
  // (to bytes 0 and 2).
  const int nk_sw = (q >> 1) & 3;
  const uint32_t nk_sel = (c & 1) ? 0x3322u : 0x1100u;
  // The convert's constant in a register (its lop3 takes one immediate);
  // opaque to the compiler, which would otherwise fold it back in.
  uint32_t k4300;
  asm("mov.b32 %0, 0x43004300;" : "=r"(k4300));

  // The A fragments of BATCH k16 steps from the weight tile at `wt`, steps
  // k0 .. k0 + BATCH - 1 of its 64-deep block (independent loads and
  // converts), pinned so that every instruction defining them runs before
  // the wgmma.fence that opens their products' window.
  auto convert = [&](const unsigned char* wt, int k0, uint32_t (&a)[C::BATCH][2][4]) {
#pragma unroll
    for (int b = 0; b < C::BATCH; ++b) {
      const int kk = k0 + b;
      uint2 cv[4];  // the thread's four columns at k = 2c, 2c + 1 (.x) and 2c + 8, 2c + 9 (.y)
      if constexpr (NK) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(wt + (32 * s + q) * 64 + ((kk ^ nk_sw) << 4));
          const uint32_t lo = (c & 2) ? v.y : v.x, hi = (c & 2) ? v.w : v.z;
          cv[s] = make_uint2(s8x2_bf16(__byte_perm(lo, lo, nk_sel), k4300),
                             s8x2_bf16(__byte_perm(hi, hi, nk_sel), k4300));
        }
      } else {
        // Rows 2c, 2c + 1, 2c + 8, 2c + 9 of the block, word q: column j's
        // pairs are byte j of the first two and of the last two.
        const unsigned char* r = wt + (16 * kk + 2 * c) * 128;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(r + kn_off0);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(r + 128 + kn_off1);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(r + 8 * 128 + kn_off0);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(r + 9 * 128 + kn_off1);
#pragma unroll
        for (int s = 0; s < 4; ++s)
          cv[s] = make_uint2(s8x2_bf16(__byte_perm(w0, w1, pair_sel(s)), k4300),
                             s8x2_bf16(__byte_perm(w2, w3, pair_sel(s)), k4300));
      }
      // tile 0: rows g, g + 8 = columns 0, 1 of the four; tile 1: 2, 3
      a[b][0][0] = cv[0].x;
      a[b][0][1] = cv[1].x;
      a[b][0][2] = cv[0].y;
      a[b][0][3] = cv[1].y;
      a[b][1][0] = cv[2].x;
      a[b][1][1] = cv[3].x;
      a[b][1][2] = cv[2].y;
      a[b][1][3] = cv[3].y;
    }
#pragma unroll
    for (int b = 0; b < C::BATCH; ++b) {
      fence_frag(a[b][0]);
      fence_frag(a[b][1]);
    }
  };
  auto weights = [&](int st) {
    return sm + st * C::STAGE + C::X_BYTES + (MODE == COLUMNS ? wg * W_BYTES : 0);
  };

  float acc[2][RT / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < RT / 2; ++i) acc[t][i] = 0.f;

  // Software-pipelined over batches: batch j's products run while batch
  // j + 1 is converted into the other fragment buffer (the products of
  // batch j - 1, which read that buffer, are retired first). KS: this
  // warpgroup's blocks are wg, wg + CW, ...
  constexpr int NB = KB / 16 / C::BATCH;  // batches a stage: even
  constexpr int STEP = KS ? CW : 1;
  const int first = KS ? wg : 0;
  uint32_t frag[2][C::BATCH][2][4];
  if (first < nkb) {
    mbar_wait(smem_u32(&full_bar[first % STAGES]), (first / STAGES) & 1);
    convert(weights(first % STAGES), 0, frag[0]);
  }
  for (int i = first; i < nkb; i += STEP) {
    const int st = i % STAGES;
    const uint64_t desc0 = make_desc(base + st * C::STAGE, 16, 1024);
#pragma unroll
    for (int jb = 0; jb < NB; ++jb) {
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < C::BATCH; ++b) {
        const uint64_t desc = desc0 + 2 * (jb * C::BATCH + b);  // + 32 bytes a k16 step
        uint32_t(&a)[2][4] = frag[jb & 1][b];
#ifdef W8A16_ABLATE_NO_WGMMA  // kernel_ab.py's ablation: the operands kept live, no products
        acc[0][0] += __uint_as_float((a[0][0] ^ a[0][1] ^ a[0][2] ^ a[0][3] ^ a[1][0] ^
                                      a[1][1] ^ a[1][2] ^ a[1][3] ^ static_cast<uint32_t>(desc)) &
                                     0x3fffffffu);
#else
        Wgmma<RT>::mma(acc[0], a[0], desc);
        Wgmma<RT>::mma(acc[1], a[1], desc);
#endif
      }
      wgmma_commit();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_wait<1>();  // the batch before this one has completed
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      // Every product that reads this warpgroup's previous block's x has
      // completed: release its stage.
      if (jb == 0 && i > first && lane == 0)
        mbar_arrive(smem_u32(&empty_bar[(i - STEP) % STAGES]));
      if (jb + 1 < NB) {
        convert(weights(st), (jb + 1) * C::BATCH, frag[(jb + 1) & 1]);
      } else if (i + STEP < nkb) {
        const int next = (i + STEP) % STAGES;
        mbar_wait(smem_u32(&full_bar[next]), ((i + STEP) / STAGES) & 1);
        convert(weights(next), 0, frag[0]);
      }
    }
  }
  wgmma_wait<0>();
  fence_acc(acc[0]);
  fence_acc(acc[1]);

  // acc[t][4j + 2s + h]: output column (slot) 2t + s of the thread's four,
  // row 8j + 2c + h of the tile; a slot's column in the CTA's tile:
  const int col0 = MODE == COLUMNS ? COLS * wg : 0;
  auto slot_col = [&](int s) { return col0 + (NK ? 32 * s + q : 4 * q + s); };
  float* red = reinterpret_cast<float*>(sm);
  // This thread's sums into a float32 tile [RT][RP], or a tile's values
  // added to them (accumulator indices compile-time: no local memory).
  auto tile_store = [&](float* tile) {
#pragma unroll
    for (int j = 0; j < RT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* r = tile + (8 * j + 2 * c + h) * C::RP;
        const float v[4] = {acc[0][4 * j + h], acc[0][4 * j + 2 + h], acc[1][4 * j + h],
                            acc[1][4 * j + 2 + h]};
        if constexpr (NK) {
#pragma unroll
          for (int s = 0; s < 4; ++s) r[slot_col(s)] = v[s];
        } else {
          *reinterpret_cast<float4*>(r + slot_col(0)) = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
  };
  auto tile_add = [&](const float* tile) {
#pragma unroll
    for (int j = 0; j < RT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* r = tile + (8 * j + 2 * c + h) * C::RP;
        float o[4];
        if constexpr (NK) {
#pragma unroll
          for (int s = 0; s < 4; ++s) o[s] = r[slot_col(s)];
        } else {
          const float4 f = *reinterpret_cast<const float4*>(r + slot_col(0));
          o[0] = f.x, o[1] = f.y, o[2] = f.z, o[3] = f.w;
        }
        acc[0][4 * j + h] = __fadd_rn(acc[0][4 * j + h], o[0]);
        acc[0][4 * j + 2 + h] = __fadd_rn(acc[0][4 * j + 2 + h], o[1]);
        acc[1][4 * j + h] = __fadd_rn(acc[1][4 * j + h], o[2]);
        acc[1][4 * j + 2 + h] = __fadd_rn(acc[1][4 * j + 2 + h], o[3]);
      }
  };

  if (n_ranks == 1) {
    if constexpr (KS) {
      // Warpgroups 1.. hand their sums to warpgroup 0, which adds them in
      // order and stores.
      consumers_sync(128 * CW);  // every product is done: the ring is free
      if (wg > 0) tile_store(red + (wg - 1) * RT * C::RP);
      consumers_sync(128 * CW);
      if (wg > 0) return;
#pragma unroll
      for (int p = 1; p < CW; ++p) tile_add(red + (p - 1) * RT * C::RP);
    }
    // The thread's four columns' scale and bias, loaded once for its rows.
    float sc[4], bi[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (NK) {
#pragma unroll
      for (int s = 0; s < 4; ++s) sc[s] = __ldg(scale + n0 + slot_col(s));
    } else {
      const float4 s4 = __ldg(reinterpret_cast<const float4*>(scale + n0 + slot_col(0)));
      sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
      if (bias != nullptr) {
        const float2 b0 = bias2(bias, bias_bf16, n0 + slot_col(0));
        const float2 b1 = bias2(bias, bias_bf16, n0 + slot_col(2));
        bi[0] = b0.x, bi[1] = b0.y, bi[2] = b1.x, bi[3] = b1.y;
      }
    }
#pragma unroll
    for (int j = 0; j < RT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + 2 * c + h;
        if (m >= M) continue;
        float v[4] = {acc[0][4 * j + h], acc[0][4 * j + 2 + h], acc[1][4 * j + h],
                      acc[1][4 * j + 2 + h]};
#pragma unroll
        for (int s = 0; s < 4; ++s) {  // scale, then bias (exact float32 steps)
          v[s] = __fmul_rn(v[s], sc[s]);
          if (bias != nullptr) v[s] = __fadd_rn(v[s], bi[s]);
        }
        if constexpr (NK) {
#pragma unroll
          for (int s = 0; s < 4; ++s) static_cast<float*>(out)[(size_t)m * N + n0 + slot_col(s)] = v[s];
        } else if (out_f32) {
          *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)m * N + n0 + slot_col(0)) =
              make_float4(v[0], v[1], v[2], v[3]);
        } else {
          const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
          *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + (size_t)m * N + n0 +
                                    slot_col(0)) =
              make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
        }
      }
    return;
  }

  // The rank's float32 tiles into its shared memory once every consumer is
  // done with the ring, then this rank's share of the tile's 4-column
  // groups summed over the ranks in rank order (and over a rank's tiles in
  // warpgroup order), every value loaded before the first add, so the
  // distributed shared memory loads overlap.
  consumers_sync(128 * CW);
  tile_store(red + (KS ? wg : 0) * RT * C::RP);
  cluster_sync();
  constexpr int GROUPS = RT * C::BN / 4;
  const int lo = rank * GROUPS / n_ranks, hi = (rank + 1) * GROUPS / n_ranks;
  for (int gi = lo + tid; gi < hi; gi += 128 * CW) {
    const int row = gi / (C::BN / 4), col = (gi % (C::BN / 4)) * 4;
    if (m0 + row >= M) continue;
    const int off = row * C::RP + col;
    float4 p[MAX_CLUSTER][C::PARTS];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < n_ranks) {
        const float* remote = cluster.map_shared_rank(red, r);
#pragma unroll
        for (int t = 0; t < C::PARTS; ++t)
          p[r][t] = *reinterpret_cast<const float4*>(remote + t * RT * C::RP + off);
      }
    float4 v = p[0][0];
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
#pragma unroll
      for (int t = 0; t < C::PARTS; ++t)
        if (r < n_ranks && r + t > 0) {
          v.x = __fadd_rn(v.x, p[r][t].x);
          v.y = __fadd_rn(v.y, p[r][t].y);
          v.z = __fadd_rn(v.z, p[r][t].z);
          v.w = __fadd_rn(v.w, p[r][t].w);
        }
    store4(v, scale, bias, bias_bf16, out, out_f32, (size_t)(m0 + row), N, n0 + col);
  }
  cluster_sync_relaxed();  // no rank leaves while another still reads its tiles
}

// One launch at tile (NK, RT, CW, MODE) over a cluster of `cluster` ranks;
// the kernel's shared memory allowance is set once a device.
template <bool NK, int RT, int CW, int MODE>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& wmap, const float* scale,
                   const void* bias, void* out, int M, int K, int N, int out_f32, int bias_bf16,
                   int cluster, cudaStream_t stream) {
  using C = Config<RT, CW, MODE>;
  constexpr int MAX_DEVICES = 64;
  static bool allowed[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES || !allowed[dev]) {
    err = cudaFuncSetAttribute(w8a16_kernel<NK, RT, CW, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) allowed[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, N / C::BN, (M + RT - 1) / RT);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, w8a16_kernel<NK, RT, CW, MODE>, xmap, wmap, scale, bias, out, M, K,
                            N, out_f32, bias_bf16);
}

}  // namespace

// The arguments of every launch entry (int8_matmul_{kn1,kn2,nk}.cu).
#define W8A16_LAUNCH_ARGS                                                                     \
  const CUtensorMap &xmap, const CUtensorMap &wmap, const float *scale, const void *bias,     \
      void *out, int M, int K, int N, int out_f32, int bias_bf16, int cluster,                \
      cudaStream_t stream
#define W8A16_LAUNCH_PASS xmap, wmap, scale, bias, out, M, K, N, out_f32, bias_bf16, cluster, stream

// rows_tile and the consumers' split -> the file's launch, or
// cudaErrorInvalidValue for a tile it does not instantiate.
cudaError_t launch_kn1(int rows_tile, W8A16_LAUNCH_ARGS);  // [K, N], one warpgroup
cudaError_t launch_kn2(int rows_tile, int split, W8A16_LAUNCH_ARGS);  // [K, N], two
cudaError_t launch_nk(int rows_tile, W8A16_LAUNCH_ARGS);               // [N, K], one

}  // namespace w8a16
