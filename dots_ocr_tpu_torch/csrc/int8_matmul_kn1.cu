// The W8A16 kernel's [K, N] (linear) tiles with one consumer warpgroup a CTA: rows_tile in
// {8, 16, 32, 64, 96, 128, 192}
// (int8_matmul.cuh).

#include "int8_matmul.cuh"

namespace w8a16 {

cudaError_t launch_kn1(int rows_tile, W8A16_LAUNCH_ARGS) {
  switch (rows_tile) {
    case 8:
      return launch<false, 8, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 16:
      return launch<false, 16, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 32:
      return launch<false, 32, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 64:
      return launch<false, 64, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 96:
      return launch<false, 96, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 128:
      return launch<false, 128, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 192:
      return launch<false, 192, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace w8a16
