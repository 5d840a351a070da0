// W8A16 matmul: the C entry, the tensor maps and the dispatch. The kernel,
// its design and what bounds it on the card: int8_matmul.cuh; its tiles are
// instantiated in int8_matmul_{kn1,kn2,nk}.cu.
//
// TMA needs a tensor map a (tensor, tile): cuTensorMapEncodeTiled, reached
// through cudaGetDriverEntryPoint (the library links no libcuda). Maps are
// passed to the kernel as __grid_constant__ parameters, so a CUDA graph
// capture keeps them, and cached by (pointer, shape, tile): a layer's
// weight is a fixed view of its stacked tensor and the decode graphs' x
// lives in fixed buffers, so after the first call a launch encodes nothing.

#include <mutex>
#include <unordered_map>

#include "int8_matmul.cuh"

namespace {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D map of [rows, cols] elements (cols contiguous, `pitch` bytes a row)
// read in boxes of [box_rows, box_cols].
struct MapKey {
  uint64_t ptr, rows, cols;
  uint32_t box_rows, box_cols, kind;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && rows == o.rows && cols == o.cols && box_rows == o.box_rows &&
           box_cols == o.box_cols && kind == o.kind;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    uint64_t h = k.ptr * 0x9E3779B97F4A7C15ull;
    for (const uint64_t v : {k.rows, k.cols, (uint64_t)k.box_rows << 32 | k.box_cols,
                             (uint64_t)k.kind})
      h = (h ^ v) * 0x100000001B3ull;
    return static_cast<size_t>(h);
  }
};

enum MapKind : uint32_t { X_BF16 = 0, W_KN = 1, W_NK = 2 };
constexpr size_t MAX_MAPS = 4096;  // the cache is cleared when it holds more

cudaError_t get_map(const void* ptr, uint64_t rows, uint64_t cols, uint32_t box_rows,
                    uint32_t box_cols, MapKind kind, CUtensorMap* map) {
  static std::mutex mutex;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{reinterpret_cast<uint64_t>(ptr), rows, cols, box_rows, box_cols, kind};
  std::lock_guard<std::mutex> lock(mutex);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const bool bf16 = kind == X_BF16;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * (bf16 ? 2 : 1)};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = encode(
      map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
      const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      kind == W_NK ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);  // rows past the tensor arrive as zeros
  if (res != CUDA_SUCCESS) return cudaErrorInvalidValue;
  if (cache.size() >= MAX_MAPS) cache.clear();
  cache.emplace(key, *map);
  return cudaSuccess;
}

}  // namespace

// x [M, K] bf16; q int8 [K, N] (nk 0) or [N, K] (nk 1); scale [N] float32;
// bias [N] float32 (bias_bf16 0) or bf16 (1), or null ([K, N] only); out
// [M, N] bf16 (out_f32 0) or float32 (always for [N, K]). The plan's tile:
// rows_tile rows of x a CTA; `consumers` warpgroups a CTA, which share it
// by `split` (0: 128 columns each; 1: the contraction of the same 128
// columns); the contraction over clusters of `cluster` ranks. Needs K a multiple of 128 and N of the
// CTA's columns.
extern "C" int dots_w8a16_matmul(const void* x, const void* q, const void* scale,
                                 const void* bias, void* out, int M, int K, int N, int nk,
                                 int out_f32, int bias_bf16, int rows_tile, int consumers,
                                 int split, int cluster, void* stream) {
  using namespace w8a16;
  const int cols = COLS * (split == COLUMNS ? consumers : 1);
  if (M < 1 || K < 2 * KB || K % (2 * KB) != 0 || (consumers != 1 && consumers != 2) ||
      split < COLUMNS || split > CONTRACTION || N < cols || N % cols != 0 || N / cols > 65535 ||
      rows_tile < 8 || (M + rows_tile - 1) / rows_tile > 65535 || cluster < 1 ||
      cluster > MAX_CLUSTER || cluster > K / KB || (nk && !out_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  cudaError_t err = get_map(x, M, K, rows_tile, KB, X_BF16, &xmap);
  if (err == cudaSuccess)
    err = nk ? get_map(q, N, K, cols, KB, W_NK, &wmap) : get_map(q, K, N, KB, COLS, W_KN, &wmap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* sp = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nk)
    err = consumers == 1 ? launch_nk(rows_tile, xmap, wmap, sp, bias, out, M, K, N, out_f32,
                                     bias_bf16, cluster, st)
                         : cudaErrorInvalidValue;
  else if (consumers == 1)
    err = launch_kn1(rows_tile, xmap, wmap, sp, bias, out, M, K, N, out_f32, bias_bf16, cluster,
                     st);
  else
    err = launch_kn2(rows_tile, split, xmap, wmap, sp, bias, out, M, K, N, out_f32, bias_bf16,
                     cluster, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
