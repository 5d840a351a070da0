"""Qwen2.5-style causal decoder with GQA (port of
``dots_ocr_tpu.models.decoder``): monolithic prefill, the dense-cache
decode step of the batch engine (``KVCache``), and over the paged KV cache
the chunked prefill extend, the paged decode step and the speculative
verify step, over bf16 or int8 pools.

PyTorch runs eagerly, so the JAX ``lax.scan`` over stacked layers is a
Python loop indexing the layer axis of the parameter tree. The decode
steps update the dense cache, the per-layer pools (and, in int8 mode, the
flat scale vectors) in place, where the JAX package returns new arrays.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from dots_ocr_tpu_torch.engine.kv_cache import PagedKV, write_kv_rows
from dots_ocr_tpu_torch.models.config import DecoderConfig
from dots_ocr_tpu_torch.models.layers import (
    embed,
    layer_params,
    linear,
    matmul_f32,
    rms_norm,
    swiglu,
    unembed,
    unstack_layers,
)
from dots_ocr_tpu_torch.models.rope import apply_rope, rope_table
from dots_ocr_tpu_torch.ops import flash_attention, paged_attention
from dots_ocr_tpu_torch.ops.attention import decode_attention_reference
from dots_ocr_tpu_torch.ops.int8_matmul import w8a16_matmul


class KVCache(NamedTuple):
    """Contiguous per-layer KV cache: k/v [num_layers, B, max_len, KV, D]."""

    k: torch.Tensor
    v: torch.Tensor

    @staticmethod
    def create(cfg: DecoderConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> "KVCache":
        shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))


def _project_qkv(x: torch.Tensor, attn_p: dict, cfg: DecoderConfig):
    """x [..., D] -> q [..., H, hd], k/v [..., KV, hd]."""
    lead = x.shape[:-1]
    q = linear(x, attn_p["wq"], attn_p.get("bq")).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = linear(x, attn_p["wk"], attn_p.get("bk")).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = linear(x, attn_p["wv"], attn_p.get("bv")).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def scatter_kv_rows(pool: torch.Tensor, slots: torch.Tensor,
                    updates: torch.Tensor) -> torch.Tensor:
    """Write per-token K/V rows into a [KV, N, D] pool leaf, in place, and
    return it. slots [T] flat slot ids; updates [T, KV, D]."""
    return pool.index_copy_(1, slots.long(), updates.transpose(0, 1).to(pool.dtype))


def decoder_layer_prefill(
    x: torch.Tensor,
    block_params: dict,
    cfg: DecoderConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    segment_ids: torch.Tensor,
    attn_impl: str = "kernel",
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One layer over x [B, T, D]: causal attention with padding as segment
    -1 (``attn_impl`` names a ``flash_attention.IMPLEMENTATIONS`` entry).
    Returns (x, (k, v)) for cache capture."""
    b, t = x.shape[:2]
    h = rms_norm(x, block_params["input_norm"], cfg.rms_norm_eps)
    q, k, v = _project_qkv(h, block_params["attn"], cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = flash_attention.IMPLEMENTATIONS[attn_impl](q, k, v, segment_ids, segment_ids,
                                                     causal=True)
    return _mlp_block(x, block_params, cfg, out.reshape(b, t, cfg.q_dim)), (k, v)


def decoder_layer_decode(
    x: torch.Tensor,
    block_params: dict,
    cfg: DecoderConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    write_pos: torch.Tensor,
    seq_lens: torch.Tensor,
) -> torch.Tensor:
    """One layer, one new token per sequence, over a dense cache.

    x [B, D]; k_cache / v_cache [B, S, KV, hd], written IN PLACE at
    write_pos [B]; seq_lens [B] valid length AFTER this write. Attention is
    the dense ``decode_attention_reference`` (XLA in the JAX package, no
    Pallas kernel). Returns x."""
    h = rms_norm(x, block_params["input_norm"], cfg.rms_norm_eps)
    q, k, v = _project_qkv(h, block_params["attn"], cfg)  # q [B, H, hd], k/v [B, KV, hd]
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache[rows, write_pos] = k.to(k_cache.dtype)
    v_cache[rows, write_pos] = v.to(v_cache.dtype)
    out = decode_attention_reference(q, k_cache, v_cache, seq_lens)
    return _mlp_block(x, block_params, cfg, out.reshape(x.shape[0], cfg.q_dim))


def decoder_prefill(
    params: dict,
    cfg: DecoderConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    seq_lens: torch.Tensor,
    attn_impl: str = "kernel",
    remat: bool = False,
) -> Tuple[torch.Tensor, KVCache]:
    """Full-sequence forward. inputs_embeds [B, T, D]; positions [B, T];
    seq_lens [B]. Attention is causal flash attention with padding as
    segment -1. ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``, as the JAX package wraps its layer in
    ``jax.checkpoint``): activation memory traded for a second forward.
    Returns (hidden [B, T, D], KVCache with k/v [L, B, T, KV, hd])."""
    t = inputs_embeds.shape[1]
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    segment_ids = torch.where(
        torch.arange(t, device=seq_lens.device)[None, :] < seq_lens[:, None], 0, -1
    ).to(torch.int32)
    x = inputs_embeds
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for block in unstack_layers(params["blocks"]):
        args = (x, block, cfg, cos, sin, segment_ids, attn_impl)
        if remat:
            x, (k, v) = checkpoint(decoder_layer_prefill, *args, use_reentrant=False)
        else:
            x, (k, v) = decoder_layer_prefill(*args)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    return x, KVCache(torch.stack(ks), torch.stack(vs))


def decoder_decode_step(
    params: dict,
    cfg: DecoderConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    cache: KVCache,
    seq_lens: torch.Tensor,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step over the dense cache for a batch of sequences.

    inputs_embeds [B, D] the latest token's embedding; positions [B] its
    absolute position (= the cache write slot); seq_lens [B] valid length
    after this token. The cache is updated in place. Returns (hidden
    [B, D], cache)."""
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = inputs_embeds
    for i in range(cfg.num_layers):
        x = decoder_layer_decode(x, layer_params(params["blocks"], i), cfg, cos, sin,
                                 cache.k[i], cache.v[i], positions, seq_lens)
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps), cache


def _mlp_block(x: torch.Tensor, bp: dict, cfg: DecoderConfig, out: torch.Tensor) -> torch.Tensor:
    """The residual after attention (``out`` [..., q_dim]) and the MLP."""
    x = x + linear(out, bp["attn"]["wo"])
    h = rms_norm(x, bp["post_attn_norm"], cfg.rms_norm_eps)
    m = bp["mlp"]
    return x + swiglu(h, m["gate"], m["up"], m["down"])


def _paged_views(paged: PagedKV, layer: int, page_size: int):
    """One layer's pools as [KV, num_pages, page_size, D] views, and its
    scales as keyword arguments of the paged kernel (empty in bf16 mode)."""
    kv_heads, n_slots, head_dim = paged.k[layer].shape
    shape = (kv_heads, n_slots // page_size, page_size, head_dim)
    ks, vs = paged.layer_scales(layer, page_size)
    scales = {} if ks is None else {"k_scales": ks, "v_scales": vs}
    return paged.k[layer].view(shape), paged.v[layer].view(shape), scales


def decoder_decode_step_paged(
    params: dict,
    cfg: DecoderConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    k_pages: List[torch.Tensor],
    v_pages: List[torch.Tensor],
    page_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    slots: torch.Tensor,
    page_size: int,
    attn_impl: str = "kernel",
    k_scales: Optional[List[torch.Tensor]] = None,
    v_scales: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """One decode step over the paged cache (continuous batching path).

    inputs_embeds [S, D] (one token per slot); positions [S]; k_pages /
    v_pages: per-layer lists of [KV, N_slots, D] pools, updated IN PLACE
    with this token's K/V; k_scales / v_scales: per-layer flat float32
    [KV * N_slots] scales of int8 pools (None in bf16 mode), written at
    ``head * N_slots + slot``; page_tables [S, max_pages] int32; seq_lens
    [S] int32 valid length AFTER this token (0 = inactive slot); slots [S]
    physical flat slot of the new token (inactive slots point at the null
    page). ``attn_impl="v1"`` runs kernel 3 (``paged_attention.paged_attention``)
    on every layer, the JAX decoder's ``paged_v1`` branch; the verify step
    refuses it. Returns hidden [S, D].
    """
    return decoder_spec_step_paged(
        params, cfg, inputs_embeds[:, None], positions[:, None], k_pages, v_pages,
        page_tables, seq_lens, slots[:, None], page_size, attn_impl, k_scales, v_scales,
    )[:, 0]


def decoder_spec_step_paged(
    params: dict,
    cfg: DecoderConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    k_pages: List[torch.Tensor],
    v_pages: List[torch.Tensor],
    page_tables: torch.Tensor,
    seq_lens: torch.Tensor,
    slots: torch.Tensor,
    page_size: int,
    attn_impl: str = "kernel",
    k_scales: Optional[List[torch.Tensor]] = None,
    v_scales: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """One speculative-verify step: nq tokens per slot (the current token
    and nq - 1 drafts) in one pass.

    inputs_embeds [S, nq, D]; positions [S, nq] (= base + j); pools and
    scales as in :func:`decoder_decode_step_paged`; seq_lens [S] BASE
    lengths (position of token 0 plus one; 0 = inactive); slots [S, nq]
    write slots. The drafts' K/V are scattered before attention, so query j
    sees tokens < len + j including the earlier drafts; a rejected draft
    leaves a dead slot that a later write overwrites (reads mask by
    length). bf16 and int8 pools go through the same kernel call. nq = 1 is
    the plain decode step. Returns hidden [S, nq, D].
    """
    attend = paged_attention.IMPLEMENTATIONS[attn_impl]
    paged = PagedKV(k_pages, v_pages, k_scales, v_scales)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    s, nq, _ = inputs_embeds.shape
    flat_slots = slots.reshape(-1)
    x = inputs_embeds
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        h = rms_norm(x, bp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(h, bp["attn"], cfg)  # q [S, nq, H, hd]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        write_kv_rows(paged, i, flat_slots, k.reshape(s * nq, cfg.num_kv_heads, cfg.head_dim),
                      v.reshape(s * nq, cfg.num_kv_heads, cfg.head_dim))
        kp, vp, scales = _paged_views(paged, i, page_size)
        out = attend(q, kp, vp, seq_lens, page_tables, **scales)
        x = _mlp_block(x, bp, cfg, out.reshape(s, nq, cfg.q_dim))
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def decoder_prefill_extend_batched(
    params: dict,
    cfg: DecoderConfig,
    inputs_embeds: torch.Tensor,
    positions: torch.Tensor,
    prompt_len: torch.Tensor,
    k_pages: List[torch.Tensor],
    v_pages: List[torch.Tensor],
    page_table: torch.Tensor,
    slots: torch.Tensor,
    page_size: int,
    kv_hi: int,
    q_offset: int,
    attn_impl: str = "kernel",
    k_scales: Optional[List[torch.Tensor]] = None,
    v_scales: Optional[List[torch.Tensor]] = None,
) -> torch.Tensor:
    """One lockstep chunk of a chunked prefill for a batch of sequences,
    writing straight into the paged cache.

    inputs_embeds [B, C, D] chunk embeddings (rows past each prompt are
    padding); positions [C] absolute positions (= q_offset + arange(C));
    prompt_len [B] total prompt tokens per row (0 = inert pad row); pools
    and scales as in :func:`decoder_decode_step_paged`; page_table [B, W]
    with W * page_size >= kv_hi; slots [B, C] write slots (padding -> the
    null page); kv_hi: gather bound (>= q_offset + C, a page multiple).

    Per layer the chunk's K/V are scattered first, each row's [0, kv_hi)
    prefix is gathered from the pages (an int8 pool dequantized straight
    to bf16, as the JAX package does), and flash attention runs causally
    with ``q_offset``; keys past each row's prompt and padding queries are
    segment -1. Returns hidden [B, C, D] after the final norm.
    """
    attend = flash_attention.IMPLEMENTATIONS[attn_impl]
    paged = PagedKV(k_pages, v_pages, k_scales, v_scales)
    b, c, _ = inputs_embeds.shape
    kv_heads, head_dim = cfg.num_kv_heads, cfg.head_dim
    cos, sin = rope_table(positions.expand(b, c), head_dim, cfg.rope_theta)
    gather_pos = torch.arange(kv_hi, device=positions.device)
    gather_slots = (page_table[:, gather_pos // page_size].long() * page_size
                    + gather_pos % page_size)  # [B, kv_hi]
    flat_gather = gather_slots.reshape(-1)
    q_seg = torch.where(positions[None, :] < prompt_len[:, None], 0, -1).to(torch.int32)
    kv_seg = torch.where(gather_pos[None, :] < prompt_len[:, None], 0, -1).to(torch.int32)
    flat_slots = slots.reshape(-1)

    def gather(pool, scale):
        rows = pool[:, flat_gather]  # [KV, B * kv_hi, D]
        if scale is not None:
            n_slots = pool.shape[1]
            idx = (torch.arange(kv_heads, device=pool.device)[:, None] * n_slots
                   + flat_gather[None, :])
            rows = rows.to(torch.bfloat16) * scale[idx].to(torch.bfloat16)[..., None]
        # [KV, B * kv_hi, D] -> [B, kv_hi, KV, D]
        return rows.reshape(kv_heads, b, kv_hi, head_dim).permute(1, 2, 0, 3).contiguous()

    x = inputs_embeds
    for i in range(cfg.num_layers):
        bp = layer_params(params["blocks"], i)
        h = rms_norm(x, bp["input_norm"], cfg.rms_norm_eps)
        q, k, v = _project_qkv(h, bp["attn"], cfg)  # q [B, C, H, hd]
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        write_kv_rows(paged, i, flat_slots, k.reshape(b * c, kv_heads, head_dim),
                      v.reshape(b * c, kv_heads, head_dim))
        kc = gather(paged.k[i], paged.k_scale[i] if paged.quantized else None)
        vc = gather(paged.v[i], paged.v_scale[i] if paged.quantized else None)
        out = attend(q, kc, vc, q_seg, kv_seg, causal=True, q_offset=q_offset)
        x = _mlp_block(x, bp, cfg, out.reshape(b, c, cfg.q_dim))
    return rms_norm(x, params["final_norm"], cfg.rms_norm_eps)


def logits_from_hidden(params: dict, cfg: DecoderConfig, hidden: torch.Tensor) -> torch.Tensor:
    """Vocab logits (tied or separate head), the float32 sum of the
    product; an int8 head's per-vocab scale multiplies that sum."""
    if cfg.tie_word_embeddings or "lm_head" not in params:
        return unembed(hidden, params["embed"])
    head = params["lm_head"]
    if isinstance(head, dict):
        return w8a16_matmul(hidden, head["qint8"], head["scale"], out_f32=True)
    return matmul_f32(hidden, head)


def embed_tokens(params: dict, input_ids: torch.Tensor) -> torch.Tensor:
    return embed(input_ids, params["embed"])
