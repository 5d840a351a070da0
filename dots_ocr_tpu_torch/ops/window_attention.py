"""Dense attention within uniform windows (windowed vision layers): the
hand-written Hopper kernel (``csrc/window_attention.cu``) and its plain
PyTorch version.

Port of the Pallas kernel ``dots_ocr_tpu.ops.window_attention.
window_attention`` (body ``_window_kernel``). The windowed vision layers
pack tokens window-major with every window padded to exactly W =
window_size^2 tokens, so the token axis reshapes to [nw, W]; each (window,
head) is one dense single-tile softmax:

  s = (q . k^T in float32) * D^-0.5; keys with segment id < 0 get -1e30
  m = rowmax(s); p = exp(s - m); l = sum(p) (float32, unrounded p)
  o = (p rounded to bf16 @ v, float32 sum) / l, stored in q.dtype

Masking is by key validity only: window-major packing never splits an
image across a window. A query row whose keys are all padding (a fully
padded window of the bucket tail) therefore gets the uniform average of
V, as the Pallas kernel gives it; padded query rows are dropped
downstream, and both versions compute them the same way so the card can
compare every row.

The wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dots_ocr_tpu_torch.ops import kernel_lib
from dots_ocr_tpu_torch.ops.attention import make_segment_mask, mha_reference

MASK_VALUE = -1e30  # the Pallas body's fill (not flash's -0.7 * f32 max)
MAX_WINDOW = 256  # tokens per window the kernel stages in shared memory


def window_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segment_ids: torch.Tensor
) -> torch.Tensor:
    """Plain version of :func:`window_attention`, in the Pallas body's
    order of rounding. q, k, v [nw, W, H, D]; segment_ids [nw, W] int32
    (-1 = padding). Returns [nw, W, H, D] in q.dtype."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("nqhd,nkhd->nhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    s = torch.where((segment_ids >= 0)[:, None, None, :], s, MASK_VALUE)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("nhqk,nkhd->nhqd", p.to(v.dtype).to(torch.float32), v.to(torch.float32))
    return (o / l).permute(0, 2, 1, 3).to(q.dtype)


def window_attention_xla(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segment_ids: torch.Tensor
) -> torch.Tensor:
    """The JAX package's default windowed path (a batched einsum): the
    dense oracle with the windows' segment mask. It masks padded queries
    too and rounds the normalized probabilities; valid rows agree with the
    kernel within bf16 rounding."""
    return mha_reference(q, k, v, make_segment_mask(segment_ids, segment_ids))


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"window_attention: {message}")


def window_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, segment_ids: torch.Tensor
) -> torch.Tensor:
    """Dense attention within each window (module notes). q, k, v
    [nw, W, H, D]; segment_ids [nw, W] int32. On CUDA: bf16, contiguous
    (the kernel reads the strided [nw, W, H, D] rows directly, no
    head-major copy), W a multiple of 64 up to 256, D in {64, 128}."""
    if q.device.type == "cpu":
        return window_attention_reference(q, k, v, segment_ids)
    nw, w, heads, head_dim = q.shape
    tensors = (q, k, v, segment_ids)
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "all inputs must be on q's CUDA device")
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16, "q, k, v must be bfloat16")
    _require(k.shape == q.shape and v.shape == q.shape,
             f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    _require(w % 64 == 0 and 0 < w <= MAX_WINDOW, f"window {w} not a multiple of 64 <= 256")
    _require(head_dim in (64, 128), f"head_dim {head_dim} not in (64, 128)")
    _require(segment_ids.dtype == torch.int32 and segment_ids.shape == (nw, w),
             "segment_ids must be int32 [nw, W]")

    out = torch.empty_like(q)
    if nw == 0:
        return out
    with torch.cuda.device(q.device):
        err = kernel_lib.load().dots_window_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            nw, w, heads, head_dim, ctypes.c_float(head_dim**-0.5),
            torch.cuda.current_stream().cuda_stream,
        )
    kernel_lib.check(err, "window_attention")
    window_attention.launches += 1
    return out


window_attention.launches = 0

# attn_impl of the vision encoder's windowed layers (see
# ops.flash_attention.IMPLEMENTATIONS): the kernel, its plain version, or
# the JAX package's einsum path.
IMPLEMENTATIONS = {"kernel": window_attention, "reference": window_attention_reference,
                   "xla": window_attention_xla}
