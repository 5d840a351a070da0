// The W8A16 kernel's [N, K] (unembed) tiles with one consumer warpgroup a CTA:
// rows_tile in {8, 16, 32, 64, 96, 128, 192}
// (int8_matmul.cuh).

#include "int8_matmul.cuh"

namespace w8a16 {

cudaError_t launch_nk(int rows_tile, W8A16_LAUNCH_ARGS) {
  switch (rows_tile) {
    case 8:
      return launch<true, 8, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 16:
      return launch<true, 16, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 32:
      return launch<true, 32, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 64:
      return launch<true, 64, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 96:
      return launch<true, 96, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 128:
      return launch<true, 128, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    case 192:
      return launch<true, 192, 1, COLUMNS>(W8A16_LAUNCH_PASS);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace w8a16
