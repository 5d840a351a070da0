// The merge pass of the split paged decode kernels (kernels 2 and 3:
// csrc/paged_attention.cu, csrc/paged_attention_v1.cu): each live split of
// a row wrote float32 partials part_o [B, KV, n_split, R, D] and part_ml
// [..., 2] = (m, l), R = (H / KV) * nq query rows a (row, KV head).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// One warp per output row (slot b, KV head, row r): the log-sum-exp merge
// of the row's live splits; exact zeros where nothing was seen. BASE2: the
// partials' m is in the base-2 domain (the bf16 mode) or the natural-exp
// domain (the int8 mode, whose sums are issued unfused, in split order, as
// its plain version takes them).
template <bool BASE2>
__global__ void paged_merge_kernel(const float* __restrict__ part_o,
                                   const float* __restrict__ part_ml,
                                   const int* __restrict__ lengths, uint16_t* __restrict__ out,
                                   int B, int nq, int H, int KV, int D, int cap, int chunk,
                                   int n_split) {
  const int w = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const int G = H / KV, R = G * nq;
  if (w >= B * KV * R) return;  // uniform across the warp
  const int b = w / (KV * R), kvh = (w / R) % KV, r = w % R;
  const int len = lengths[b];
  const int n_tok = len > 0 ? min(len + nq - 1, cap) : 0;
  const int n_live = (n_tok + chunk - 1) / chunk;
  const size_t row0 = ((size_t)b * KV + kvh) * n_split * R + r;  // split s: row0 + s * R
  float mb = -INFINITY;
  for (int s = 0; s < n_live; ++s) mb = fmaxf(mb, part_ml[(row0 + (size_t)s * R) * 2]);
  float lb = 0.f;
  for (int s = 0; s < n_live; ++s) {
    const float ms = part_ml[(row0 + (size_t)s * R) * 2];
    if (ms == -INFINITY) continue;
    const float ls = part_ml[(row0 + (size_t)s * R) * 2 + 1];
    if (BASE2) lb += ls * exp2f(ms - mb);
    else lb = __fadd_rn(lb, __fmul_rn(ls, expf(__fsub_rn(ms, mb))));
  }
  const float inv = lb == 0.f ? 0.f : __fdiv_rn(1.f, lb);
  const int gh = r / nq, j = r % nq;
  uint16_t* dst = out + (((size_t)b * nq + j) * H + kvh * G + gh) * D;
  for (int d = lane; d < D; d += 32) {
    float x = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const size_t row = row0 + (size_t)s * R;
      const float ms = part_ml[row * 2];
      if (ms == -INFINITY) continue;
      if (BASE2) x += part_o[row * D + d] * exp2f(ms - mb);
      else x = __fadd_rn(x, __fmul_rn(part_o[row * D + d], expf(__fsub_rn(ms, mb))));
    }
    dst[d] = __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(x, inv)));
  }
}

}  // namespace
