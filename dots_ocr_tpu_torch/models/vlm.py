"""The full VLM: vision tokens spliced into the decoder's embedding stream
(port of ``dots_ocr_tpu.models.vlm``).

The prompt carries ``<|img|><|imgpad|>*N<|endofimg|>`` per image, N the
merged vision token count. The host computes, per merged vision row, the
(batch, position) of the imgpad token it fills; padding rows get the
out-of-bounds sentinel (B, T) and are dropped by the splice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.decoder import (
    KVCache,
    decoder_decode_step,
    decoder_prefill,
    embed_tokens,
    logits_from_hidden,
)
from dots_ocr_tpu_torch.models.vision import encode_images


def splice_vision_embeddings(
    token_embeds: torch.Tensor,
    vision_tokens: torch.Tensor,
    batch_idx: torch.Tensor,
    pos_idx: torch.Tensor,
) -> torch.Tensor:
    """Insert vision tokens at imgpad positions. token_embeds [B, T, D];
    vision_tokens [M, D]; batch_idx/pos_idx [M]. Rows whose batch index is
    out of bounds (the sentinel) are dropped: they land in a scratch row
    that is cut off again, so no host sync is needed to filter them."""
    b, t, d = token_embeds.shape
    flat_idx = torch.where(batch_idx < b, batch_idx.long() * t + pos_idx.long(), b * t)
    flat = torch.cat([token_embeds.reshape(b * t, d), token_embeds.new_zeros(1, d)])
    flat.index_copy_(0, flat_idx, vision_tokens.to(token_embeds.dtype))
    return flat[: b * t].reshape(b, t, d)


def build_scatter_indices(
    input_ids: np.ndarray,
    imgpad_id: int,
    num_merged_padded: int,
    valid_rows: "np.ndarray | None" = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host helper: destination (batch, position) of each merged vision row.

    The k-th imgpad token is filled by the k-th valid merged row (row
    ``valid_rows[k]`` when given, else row k); every other row gets the
    sentinel (B, T)."""
    batch_idx, pos_idx = np.nonzero(input_ids == imgpad_id)
    m = len(batch_idx)
    available = len(valid_rows) if valid_rows is not None else num_merged_padded
    if m > available:
        raise ValueError(f"{m} imgpad tokens but only {available} valid vision rows")
    rows = np.asarray(valid_rows)[:m] if valid_rows is not None else np.arange(m)
    out_b = np.full(num_merged_padded, input_ids.shape[0], np.int32)
    out_p = np.full(num_merged_padded, input_ids.shape[1], np.int32)
    out_b[rows] = batch_idx
    out_p[rows] = pos_idx
    return out_b, out_p


def vlm_embed(
    params: dict,
    config: DotsOCRConfig,
    input_ids: torch.Tensor,
    patches: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    scatter_batch: Optional[torch.Tensor] = None,
    scatter_pos: Optional[torch.Tensor] = None,
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """Token embeddings with the vision tokens spliced in: [B, T, D]."""
    x = embed_tokens(params["decoder"], input_ids)
    if patches is not None:
        vision_tokens = encode_images(
            params["vision"], config.vision, patches, rope_cos, rope_sin,
            segment_ids, attn_impl=attn_impl,
        )
        x = splice_vision_embeddings(x, vision_tokens, scatter_batch, scatter_pos)
    return x


def vlm_prefill(
    params: dict,
    config: DotsOCRConfig,
    input_ids: torch.Tensor,
    positions: torch.Tensor,
    seq_lens: torch.Tensor,
    patches: Optional[torch.Tensor] = None,
    rope_cos: Optional[torch.Tensor] = None,
    rope_sin: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    scatter_batch: Optional[torch.Tensor] = None,
    scatter_pos: Optional[torch.Tensor] = None,
    attn_impl: str = "kernel",
    last_logit_only: bool = False,
    remat: bool = False,
):
    """Full multimodal prefill. input_ids/positions [B, T]; seq_lens [B];
    vision arguments as from ``preprocess.pack_images`` and
    :func:`build_scatter_indices` (absent for text-only prompts).

    ``remat`` recomputes each decoder layer in the backward pass (the
    vision encoder is not rematerialized, as in the JAX package).

    Returns (logits, cache): logits [B, T, V] float32, or [B, V] with
    ``last_logit_only``; a KVCache with k/v [L, B, T, KV, hd]."""
    x = vlm_embed(
        params, config, input_ids, patches=patches, rope_cos=rope_cos,
        rope_sin=rope_sin, segment_ids=segment_ids, scatter_batch=scatter_batch,
        scatter_pos=scatter_pos, attn_impl=attn_impl,
    )
    hidden, cache = decoder_prefill(
        params["decoder"], config.decoder, x, positions, seq_lens, attn_impl, remat=remat
    )
    if last_logit_only:
        hidden = hidden[torch.arange(hidden.shape[0], device=hidden.device), seq_lens.long() - 1]
    return logits_from_hidden(params["decoder"], config.decoder, hidden), cache


def vlm_decode_step(
    params: dict,
    config: DotsOCRConfig,
    token_ids: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    seq_lens: torch.Tensor,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step over the dense cache (updated in place).
    token_ids / positions / seq_lens [B]. Returns (logits [B, V] float32,
    cache)."""
    x = embed_tokens(params["decoder"], token_ids)
    hidden, cache = decoder_decode_step(
        params["decoder"], config.decoder, x, positions, cache, seq_lens
    )
    return logits_from_hidden(params["decoder"], config.decoder, hidden), cache
