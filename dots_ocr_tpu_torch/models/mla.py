"""DeepSeek-V3's decoder (dots.vlm1's): latent attention (MLA) over a paged
latent cache, dense MLPs in the first ``first_k_dense_replace`` layers and
mixture-of-experts layers after them (``models/moe.py``).

``decoder.py``'s entries dispatch here when ``DecoderConfig.deepseek`` is
set, so the scheduler's programs (and the spans around them) are the same
for both decoders.

Per layer, from the normed hidden h:
  q = q_b(RMSNorm(q_a(h)))                 -> per head [q_nope 128 | q_pe 64]
  [c_kv 512 | k_pe 64] = kv_a(h); c_kv = RMSNorm(c_kv)
  q_pe, k_pe: YaRN rope in DeepSeek's interleaved order (k_pe one for all heads)
  kv_b(c_kv)                               -> per head [k_nope 128 | v 128]
  out = o_proj(softmax(q . [k_nope | k_pe] * scale) v)

The cache holds [c_kv | k_pe] (576 values) a token a layer
(``engine/kv_cache.py``). Prefill runs expanded: k and v through kv_b and
one library attention call (q / k 192 wide, v zero-padded to 192 so that
the flash path takes it); a chunk after the first gathers the earlier
chunks' latent rows from the pages. Decode runs absorbed: q_nope times
kv_b's key half (W_UK) gives a 512-wide query a head, the paged latent
kernel (``ops/mla_attention.py``) attends over the pages, and its output
times kv_b's value half (W_UV) goes into o_proj.

Parameters of the decoder tree (kernels ``[in, out]``):
  blocks: input_norm, post_attn_norm [L, D]; attn: q_a [L, D, q_lora],
          q_a_norm [L, q_lora], q_b [L, q_lora, H * 192], kv_a [L, D, 576],
          kv_a_norm [L, 512], kv_b [L, 512, H * 256], wo [L, H * 128, D]
  dense:  gate / up [first_k, D, I], down [first_k, I, D]
  moe, shared: the MoE layers' (``models/moe.py``), stacked [L - first_k, ...]
  embed [V, D], lm_head [D, V], final_norm [D]
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch.nn.attention.bias import causal_lower_right

from dots_ocr_tpu_torch.models.config import DecoderConfig
from dots_ocr_tpu_torch.models.layers import layer_params, linear, rms_norm, swiglu
from dots_ocr_tpu_torch.models.moe import moe_block
from dots_ocr_tpu_torch.models.rope import apply_rope_interleaved, yarn_rope_table
from dots_ocr_tpu_torch.ops.mla_attention import mla_paged_decode


def _rope(positions: torch.Tensor, cfg: DecoderConfig):
    ds = cfg.deepseek
    return yarn_rope_table(positions, ds.qk_rope_head_dim, cfg.rope_theta, ds.rope_scaling)


def latent_rows(h: torch.Tensor, ap: dict, cfg: DecoderConfig, cos: torch.Tensor,
                sin: torch.Tensor):
    """h [..., D] -> (q_nope [..., H, dn], q_pe [..., H, dr] roped, the
    cache rows [..., rank + dr]: the normed latent and the roped k_pe);
    cos / sin [..., dr]."""
    ds, eps = cfg.deepseek, cfg.rms_norm_eps
    q = linear(rms_norm(linear(h, ap["q_a"]), ap["q_a_norm"], eps), ap["q_b"])
    q = q.unflatten(-1, (cfg.num_heads, ds.qk_head_dim))
    q_nope, q_pe = q.split([ds.qk_nope_head_dim, ds.qk_rope_head_dim], dim=-1)
    c, k_pe = linear(h, ap["kv_a"]).split([ds.kv_lora_rank, ds.qk_rope_head_dim], dim=-1)
    q_pe = apply_rope_interleaved(q_pe, cos[..., None, :], sin[..., None, :])
    k_pe = apply_rope_interleaved(k_pe, cos, sin)
    return q_nope, q_pe, torch.cat([rms_norm(c, ap["kv_a_norm"], eps), k_pe], dim=-1)


def _expanded_attention(q_nope, q_pe, rows, ap: dict, cfg: DecoderConfig, mask) -> torch.Tensor:
    """Attention of queries [B, C, H, *] over cache rows [B, S, rank + dr]
    through kv_b, one library call (``mask``: ``is_causal`` True or an
    attention bias). Returns [B, C, H * dv]."""
    ds = cfg.deepseek
    b, c, heads = q_nope.shape[:3]
    dn, dv = ds.qk_nope_head_dim, ds.v_head_dim
    rows = rows.to(q_nope.dtype)
    kv = linear(rows[..., :ds.kv_lora_rank], ap["kv_b"]).unflatten(-1, (heads, dn + dv))
    k_pe = rows[..., None, ds.kv_lora_rank:].expand(-1, -1, heads, -1)
    k = torch.cat([kv[..., :dn], k_pe], dim=-1)
    v = F.pad(kv[..., dn:], (0, ds.qk_head_dim - dv))
    q = torch.cat([q_nope, q_pe], dim=-1)
    causal = mask is True
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=None if causal else mask, is_causal=causal, scale=ds.softmax_scale)
    return out[..., :dv].transpose(1, 2).reshape(b, c, heads * dv)


def _mlp(x: torch.Tensor, params: dict, bp: dict, cfg: DecoderConfig, layer: int,
         live: Optional[torch.Tensor], stats: Optional[torch.Tensor]) -> torch.Tensor:
    """The residual after the layer's MLP: dense below first_k_dense_replace,
    MoE from there on."""
    ds = cfg.deepseek
    h = rms_norm(x, bp["post_attn_norm"], cfg.rms_norm_eps)
    if layer < ds.first_k_dense_replace:
        m = layer_params(params["dense"], layer)
        return x + swiglu(h, m["gate"], m["up"], m["down"])
    j = layer - ds.first_k_dense_replace
    return x + moe_block(h, layer_params(params["moe"], j), layer_params(params["shared"], j),
                         ds, live, stats)


def deepseek_prefill(params: dict, cfg: DecoderConfig, inputs_embeds: torch.Tensor,
                     positions: torch.Tensor, seq_lens: torch.Tensor,
                     moe_stats: Optional[torch.Tensor] = None):
    """Full-sequence forward (``decoder_prefill``'s contract): inputs_embeds
    [B, T, D], positions [B, T], seq_lens [B]. Padding tokens follow each
    row's prompt, so causal attention keeps them out of its valid rows.
    Returns (hidden [B, T, D], the cache rows [L, B, T, 1, rank + dr])."""
    cos, sin = _rope(positions, cfg)
    t = inputs_embeds.shape[1]
    live = torch.arange(t, device=seq_lens.device)[None, :] < seq_lens[:, None]
    x, rows = inputs_embeds, []
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        h = rms_norm(x, bp["input_norm"], cfg.rms_norm_eps)
        q_nope, q_pe, latent = latent_rows(h, bp["attn"], cfg, cos, sin)
        out = _expanded_attention(q_nope, q_pe, latent, bp["attn"], cfg, True)
        x = x + linear(out, bp["attn"]["wo"])
        x = _mlp(x, params, bp, cfg, i, live, moe_stats)
        rows.append(latent[:, :, None])
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), torch.stack(rows)


def deepseek_decode_step_paged(params: dict, cfg: DecoderConfig, inputs_embeds: torch.Tensor,
                               positions: torch.Tensor, pools: List[torch.Tensor],
                               page_tables: torch.Tensor, seq_lens: torch.Tensor,
                               slots: torch.Tensor, page_size: int,
                               moe_stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step over the paged latent cache
    (``decoder_decode_step_paged``'s contract; ``pools`` the per-layer
    latent pools [1, N, rank + dr], updated in place). Absorbed: each head's
    query is taken into the latent space, the paged latent kernel attends,
    and the output leaves it through W_UV. Returns hidden [S, D]."""
    ds = cfg.deepseek
    cos, sin = _rope(positions, cfg)
    heads, rank, dn = cfg.num_heads, ds.kv_lora_rank, ds.qk_nope_head_dim
    live = seq_lens > 0
    x = inputs_embeds
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        ap = bp["attn"]
        h = rms_norm(x, bp["input_norm"], cfg.rms_norm_eps)
        q_nope, q_pe, latent = latent_rows(h, ap, cfg, cos, sin)
        pools[i][0].index_copy_(0, slots.long(), latent.to(pools[i].dtype))
        w = ap["kv_b"].to(x.dtype).view(rank, heads, dn + ds.v_head_dim)
        q_lat = torch.matmul(q_nope.transpose(0, 1), w[..., :dn].permute(1, 2, 0))  # [H, S, rank]
        q = torch.cat([q_lat.transpose(0, 1), q_pe], dim=-1).to(pools[i].dtype)
        o_lat = mla_paged_decode(q, pools[i], page_tables, seq_lens, page_size, rank,
                                 ds.softmax_scale).to(x.dtype)
        out = torch.matmul(o_lat.transpose(0, 1), w[..., dn:].transpose(0, 1))  # [H, S, dv]
        x = x + linear(out.transpose(0, 1).reshape(x.shape[0], -1), ap["wo"])
        x = _mlp(x, params, bp, cfg, i, live, moe_stats)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def deepseek_prefill_extend(params: dict, cfg: DecoderConfig, inputs_embeds: torch.Tensor,
                            positions: torch.Tensor, prompt_len: torch.Tensor,
                            pools: List[torch.Tensor], page_table: torch.Tensor,
                            slots: torch.Tensor, page_size: int, q_offset: int,
                            moe_stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One lockstep chunk of a chunked prefill
    (``decoder_prefill_extend_batched``'s contract): the chunk's latent rows
    are written first, then each row's [0, q_offset + C) rows gathered from
    the pages and attended expanded, causally from the bottom right (a key
    past q_offset + C is seen by no query of the chunk). Returns hidden
    [B, C, D] after the final norm."""
    b, c, _ = inputs_embeds.shape
    cos, sin = _rope(positions.expand(b, c), cfg)
    kv = q_offset + c
    pos = torch.arange(kv, device=positions.device)
    gather = page_table[:, pos // page_size].long() * page_size + pos % page_size  # [B, kv]
    flat_slots = slots.reshape(-1).long()
    live = positions[None, :] < prompt_len[:, None]
    mask = causal_lower_right(c, kv)
    x = inputs_embeds
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        h = rms_norm(x, bp["input_norm"], cfg.rms_norm_eps)
        q_nope, q_pe, latent = latent_rows(h, bp["attn"], cfg, cos, sin)
        rows = pools[i][0]
        rows.index_copy_(0, flat_slots, latent.reshape(b * c, -1).to(rows.dtype))
        out = _expanded_attention(q_nope, q_pe, rows[gather], bp["attn"], cfg, mask)
        x = x + linear(out, bp["attn"]["wo"])
        x = _mlp(x, params, bp, cfg, i, live, moe_stats)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)

