"""Batch generation over a dense KV cache: bucketed prefill, then a decode
loop with early exit once every sequence has emitted EOS (port of
``dots_ocr_tpu.engine.generate``).

The JAX ``lax.while_loop`` becomes a host loop of device steps. The host
reads the "all done" flag only every ``DONE_CHECK_EVERY`` steps, so it
keeps enqueueing work while the device runs; a step past the last EOS
records nothing (finished rows record padding), so the tokens are those of
a loop that checks every step. The sampling keys follow the JAX chain
exactly: one ``split`` before the first draw and one per step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dots_ocr_tpu_torch.engine.sampling import sample_logits, split
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.decoder import KVCache
from dots_ocr_tpu_torch.models.rope import vision_rope_device
from dots_ocr_tpu_torch.models.vlm import vlm_decode_step, vlm_prefill

DONE_CHECK_EVERY = 8


class GenerateResult(NamedTuple):
    tokens: torch.Tensor         # [B, max_new_tokens] int64 (pad after EOS)
    num_generated: torch.Tensor  # [B] int64, includes the EOS token if hit


@torch.no_grad()
def generate(
    params: dict,
    config: DotsOCRConfig,
    input_ids: torch.Tensor,
    seq_lens: torch.Tensor,
    rng: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    max_new_tokens: int,
    patches: Optional[torch.Tensor] = None,
    pos2d: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    scatter_batch: Optional[torch.Tensor] = None,
    scatter_pos: Optional[torch.Tensor] = None,
    attn_impl: str = "kernel",
    nucleus: bool = True,
) -> GenerateResult:
    """Generate up to ``max_new_tokens`` per sequence.

    input_ids [B, T_bucket] (right-padded) and seq_lens [B] true prompt
    lengths on the device; rng: one key [2] (int64 uint32 words, on the
    CPU: the chain is host-side) shared by the batch's draws;
    temperature / top_p [B]; ``attn_impl`` names the prefill's attention
    (``flash_attention.IMPLEMENTATIONS``).

    Memory: the dense cache is [L, B, T_bucket + max_new_tokens] (~28 KB a
    token and sequence in bf16 at flagship size, 0.53 GB for one sequence
    of 18.6k positions).
    """
    batch, t_bucket = input_ids.shape
    dev = input_ids.device
    eos, pad = config.special.eos_token_id, config.special.pad_token_id
    rope_cos = rope_sin = None
    if pos2d is not None:
        rope_cos, rope_sin = vision_rope_device(pos2d, config.vision.head_dim,
                                                config.vision.rope_theta)
    positions = torch.arange(t_bucket, device=dev).expand(batch, t_bucket)
    logits, prefill_cache = vlm_prefill(
        params, config, input_ids, positions, seq_lens, patches=patches,
        rope_cos=rope_cos, rope_sin=rope_sin, segment_ids=segment_ids,
        scatter_batch=scatter_batch, scatter_pos=scatter_pos, attn_impl=attn_impl,
        last_logit_only=True,
    )
    # Widen the cache for the decode phase.
    cache = KVCache.create(config.decoder, batch, t_bucket + max_new_tokens,
                           dtype=prefill_cache.k.dtype, device=dev)
    cache.k[:, :, :t_bucket] = prefill_cache.k
    cache.v[:, :, :t_bucket] = prefill_cache.v
    del prefill_cache

    any_sampled = bool((temperature > 0).any())

    def draw(rng, logits):
        rng, step_rng = split(rng)
        return rng, sample_logits(step_rng.to(dev), logits, temperature, top_p,
                                  nucleus=nucleus, any_sampled=any_sampled)

    rng, current = draw(rng, logits)
    tokens = torch.full((batch, max_new_tokens), pad, dtype=torch.int64, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    count = torch.zeros(batch, dtype=torch.int64, device=dev)
    seq_lens = seq_lens.to(torch.int64)
    for step in range(max_new_tokens):
        if step % DONE_CHECK_EVERY == 0 and step > 0 and bool(done.all()):
            break
        # Record the token sampled for this step (finished rows keep pad).
        tokens[:, step] = torch.where(done, pad, current)
        count += (~done).to(torch.int64)
        newly_done = current == eos
        # Feed the token through the decoder (harmless for finished rows).
        pos = seq_lens + step
        logits, cache = vlm_decode_step(params, config, current, pos, cache, pos + 1)
        rng, current = draw(rng, logits)
        done = done | newly_done
    return GenerateResult(tokens=tokens, num_generated=count)


def bucket_length(n: int, step: int = 128, minimum: int = 128) -> int:
    """Round a length up to the bucket grid."""
    return max(minimum, ((n + step - 1) // step) * step)
