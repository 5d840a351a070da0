"""Dense attention oracle and mask builders (port of
``dots_ocr_tpu.ops.attention``).

Conventions: q [B, T, H, D], k/v [B, S, KV, D] with H a multiple of KV
(GQA); masks are bool [B, T, S] (True = attend); softmax in float32,
outputs in q.dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def make_causal_mask(q_positions: torch.Tensor, kv_len: int) -> torch.Tensor:
    """q_positions [B, T] absolute query positions; keys are 0..kv_len-1.
    Returns bool [B, T, kv_len]."""
    kv_pos = torch.arange(kv_len, device=q_positions.device)[None, None, :]
    return kv_pos <= q_positions[:, :, None]


def make_length_mask(seq_lens: torch.Tensor, length: int) -> torch.Tensor:
    """[B] lengths -> bool [B, length]."""
    return torch.arange(length, device=seq_lens.device)[None, :] < seq_lens[:, None]


def make_segment_mask(
    q_segments: torch.Tensor, kv_segments: torch.Tensor
) -> torch.Tensor:
    """Block-diagonal mask for packed sequences; segment id < 0 is padding.
    Returns bool [..., T, S]."""
    same = q_segments[..., :, None] == kv_segments[..., None, :]
    valid = (q_segments[..., :, None] >= 0) & (kv_segments[..., None, :] >= 0)
    return same & valid


def mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Grouped-query attention by dense einsums (float32 softmax).

    mask: bool [B, T, S]. A fully masked row averages over every key (the
    -1e30 fill), exactly like the JAX oracle; the kernels zero such rows.
    """
    batch, q_len, num_heads, head_dim = q.shape
    kv_heads = k.shape[2]
    group = num_heads // kv_heads
    scale = scale if scale is not None else head_dim**-0.5

    qg = q.reshape(batch, q_len, kv_heads, group, head_dim)
    scores = torch.einsum(
        "btkgd,bskd->bkgts", qg.to(torch.float32), k.to(torch.float32)
    ) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bkgts,bskd->btkgd", probs.to(v.dtype).to(torch.float32),
        v.to(torch.float32),
    )
    return out.reshape(batch, q_len, num_heads, head_dim).to(q.dtype)


def decode_attention_reference(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    seq_lens: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Single-token decode attention over a contiguous KV cache: q [B, H, D]
    (one new token per sequence); k_cache / v_cache [B, MAX_S, KV, D];
    seq_lens [B] valid entries (the token written this step included)."""
    mask = make_length_mask(seq_lens, k_cache.shape[1])  # [B, S]
    return mha_reference(q[:, None], k_cache, v_cache, mask=mask[:, None, :], scale=scale)[:, 0]
