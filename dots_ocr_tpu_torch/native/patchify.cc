// Native im2col for the vision patcher (models/preprocess.py), compiled
// with the host C++ compiler at first use by native/__init__.py and loaded
// through ctypes. The port's copy of the patchify routine of the JAX
// package's native library; the numpy path in extract_patches computes the
// same array where no compiler exists.

#include <cstdint>
#include <cstring>

extern "C" {

// Single-pass im2col + emission-order reorder for the vision patcher
// (preprocess.extract_patches). The numpy path makes 2-3 full-image
// passes (reshape/transpose copy, then a gather by the emission perm);
// on a 1-core serving host that's a measurable slice of per-page submit
// time. Here each emitted token's 14x14x3 patch is copied straight from
// the strided image rows to its final row — one pass, pure memcpy.
//
// img:  [H, W, C] uint8, row-major;  perm: [n_tokens] int32 patch index
// in (gy * grid_w + gx) order, -1 = padded window slot (zero-filled);
// out:  [n_tokens, p*p*C] uint8.  Returns 0, or -1 on bad geometry.
long patchify(const unsigned char* img, int H, int W, int C, int p,
              const int* perm, long n_tokens, int grid_w,
              unsigned char* out) {
    if (p <= 0 || C <= 0 || grid_w <= 0 || W < p * grid_w) return -1;
    const long patch_bytes = (long)p * p * C;
    const long row_bytes = (long)p * C;
    const long img_row = (long)W * C;
    const int grid_h = H / p;
    for (long t = 0; t < n_tokens; ++t) {
        unsigned char* dst = out + t * patch_bytes;
        int q = perm[t];
        if (q < 0) {
            std::memset(dst, 0, (size_t)patch_bytes);
            continue;
        }
        int gy = q / grid_w, gx = q % grid_w;
        if (gy >= grid_h) return -1;
        const unsigned char* src = img + (long)gy * p * img_row
                                       + (long)gx * row_bytes;
        for (int r = 0; r < p; ++r) {
            std::memcpy(dst + r * row_bytes, src + r * img_row,
                        (size_t)row_bytes);
        }
    }
    return 0;
}

}  // extern "C"
