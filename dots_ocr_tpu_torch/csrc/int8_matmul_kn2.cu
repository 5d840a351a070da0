// The W8A16 kernel's [K, N] (linear) tiles with two consumer warpgroups a CTA: 256
// columns at 128 rows; the contraction split up to 128 rows
// (int8_matmul.cuh).

#include "int8_matmul.cuh"

namespace w8a16 {

cudaError_t launch_kn2(int rows_tile, int split, W8A16_LAUNCH_ARGS) {
  if (split == COLUMNS && rows_tile == 128) return launch<false, 128, 2, COLUMNS>(W8A16_LAUNCH_PASS);
  if (split == CONTRACTION) {
    switch (rows_tile) {
      case 8:
        return launch<false, 8, 2, CONTRACTION>(W8A16_LAUNCH_PASS);
      case 16:
        return launch<false, 16, 2, CONTRACTION>(W8A16_LAUNCH_PASS);
      case 32:
        return launch<false, 32, 2, CONTRACTION>(W8A16_LAUNCH_PASS);
      case 64:
        return launch<false, 64, 2, CONTRACTION>(W8A16_LAUNCH_PASS);
      case 96:
        return launch<false, 96, 2, CONTRACTION>(W8A16_LAUNCH_PASS);
      case 128:
        return launch<false, 128, 2, CONTRACTION>(W8A16_LAUNCH_PASS);
      default:
        return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace w8a16
