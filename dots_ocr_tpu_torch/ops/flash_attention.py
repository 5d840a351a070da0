"""Flash attention: the hand-written Hopper kernel (``csrc/flash_attention.cu``)
and its plain PyTorch version.

Port of the Pallas kernel ``dots_ocr_tpu.ops.flash_attention.flash_attention``
(the ``pl.pallas_call`` of ``_flash_kernel``). One function serves NaViT
packed vision attention (segment ids give block-diagonal masking, -1 is
padding) and causal decoder prefill (causal flag, padding as segment -1).

The wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dots_ocr_tpu_torch.ops import kernel_lib
from dots_ocr_tpu_torch.ops.attention import make_causal_mask, make_segment_mask, mha_reference

# Finite, not -inf: exp(-inf - (-inf)) is NaN, exp of this underflows to 0.
DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _segments(ids: Optional[torch.Tensor], batch: int, length: int, device) -> torch.Tensor:
    if ids is None:
        return torch.zeros((batch, length), dtype=torch.int32, device=device)
    return ids


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of :func:`flash_attention`: dense float32 scores and
    softmax, the kernel's exact mask, and exact zeros for a fully masked
    row. q [B, Tq, H, D]; k, v [B, S, KV, D]; returns [B, Tq, H, D]."""
    batch, q_len, num_heads, head_dim = q.shape
    kv_len, kv_heads = k.shape[1], k.shape[2]
    group = num_heads // kv_heads
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    q_seg = _segments(q_segment_ids, batch, q_len, q.device)
    kv_seg = _segments(kv_segment_ids, batch, kv_len, q.device)

    mask = (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] >= 0)
    if causal:
        rows = torch.arange(q_len, device=q.device) + q_offset
        cols = torch.arange(kv_len, device=q.device)
        mask = mask & (cols[None, :] <= rows[:, None])[None]
    mask = mask[:, None, None]  # [B, 1, 1, Tq, S]

    qg = q.reshape(batch, q_len, kv_heads, group, head_dim).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32)) * scale
    scores = scores.masked_fill(~mask, DEFAULT_MASK_VALUE)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)) * mask
    denom = p.sum(dim=-1).permute(0, 3, 1, 2)[..., None]  # [B, Tq, KV, G, 1]
    out = torch.einsum(
        "bkgts,bskd->btkgd", p.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    out = torch.where(denom > 0, out / denom.clamp_min(1e-30), 0.0)
    return out.reshape(batch, q_len, num_heads, head_dim).to(q.dtype)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {message}")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention over model-layout tensors.

    q [B, Tq, H, D]; k, v [B, S, KV, D] with H % KV == 0 (GQA);
    q_segment_ids [B, Tq] and kv_segment_ids [B, S] int32 (-1 = padding;
    None = one segment). ``causal`` masks key positions above query
    position + ``q_offset``. On CUDA: bf16, contiguous, D in {64, 128}.
    """
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, q_segment_ids, kv_segment_ids, causal, q_offset, sm_scale
        )
    batch, q_len, num_heads, head_dim = q.shape
    kv_len, kv_heads = k.shape[1], k.shape[2]
    q_seg = _segments(q_segment_ids, batch, q_len, q.device)
    kv_seg = _segments(kv_segment_ids, batch, kv_len, q.device)
    tensors = (q, k, v, q_seg, kv_seg)
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "all inputs must be on q's CUDA device")
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _require(q.dtype == k.dtype == v.dtype == torch.bfloat16, "q, k, v must be bfloat16")
    _require(head_dim in (64, 128), f"head_dim {head_dim} not in (64, 128)")
    _require(k.shape == (batch, kv_len, kv_heads, head_dim) and v.shape == k.shape,
             f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    _require(num_heads % kv_heads == 0, f"{num_heads} heads vs {kv_heads} KV heads")
    _require(q_seg.dtype == kv_seg.dtype == torch.int32, "segment ids must be int32")
    _require(q_seg.shape == (batch, q_len) and kv_seg.shape == (batch, kv_len),
             "segment id shapes")
    _require(q_offset >= 0, "q_offset must be >= 0")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kernel_lib.load().dots_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
            kv_seg.data_ptr(), out.data_ptr(), batch, q_len, kv_len, num_heads,
            kv_heads, head_dim, int(causal), int(q_offset), ctypes.c_float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    kernel_lib.check(err, "flash_attention")
    flash_attention.launches += 1
    if q_offset > 0:  # chunked-prefill chunks after the first
        flash_attention.offset_launches += 1
    return out


flash_attention.launches = 0
flash_attention.offset_launches = 0

def flash_attention_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = False,
    q_offset: int = 0,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """The JAX package's XLA path for the same call: the dense oracle on the
    equivalent mask. It rounds the probabilities to v.dtype after
    normalizing them (the kernel rounds them before), and a fully masked
    row averages instead of giving zeros."""
    batch, q_len = q.shape[:2]
    q_seg = _segments(q_segment_ids, batch, q_len, q.device)
    kv_seg = _segments(kv_segment_ids, batch, k.shape[1], q.device)
    mask = make_segment_mask(q_seg, kv_seg)
    if causal:
        rows = (torch.arange(q_len, device=q.device) + q_offset).expand(batch, q_len)
        mask = mask & make_causal_mask(rows, k.shape[1])
    return mha_reference(q, k, v, mask, sm_scale)


# attn_impl of the model functions: "kernel" is the serving path,
# "reference" runs the plain version on any device (consistency checks),
# and "xla" is the JAX package's CPU path (token parity with its engine).
IMPLEMENTATIONS = {"kernel": flash_attention, "reference": flash_attention_reference,
                   "xla": flash_attention_xla}
