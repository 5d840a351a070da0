"""dots.vlm1's architecture, as the harness needs it: dots.ocr's 42-layer
NaViT encoder (its shapes and reference shared through ``weights.py`` and
``reference.py``), a merger that projects to 7,168, and DeepSeek-V3's
decoder: MLA (q and kv through low-rank projections, 128 heads, a 576-wide
latent cache row a token), YaRN rope on the 64 rope dims, dense layers
first, then mixture-of-experts layers (a sigmoid ``noaux_tc`` router over
256 experts, top-8, one shared expert), an untied lm_head.

A configuration names this module by ``"arch": "dotsvlm1"``; its ``model``
section's ``decoder`` holds DeepSeek-V3's config.json keys (with
``experts_held``: the first expert and the count one device holds), which
:func:`program_config` maps onto the program's ``DecoderConfig``.

The reference here is the benchmark's copy of ``reference/dotsvlm1.py``
(the repository's plain reference; ``gpubench/tests`` holds the two equal),
in float32, with the same departures: no MTP layer, the held experts' part
alone, ties to the lower index. The reference side (``make_weights``,
``prompt_ids``, ``served_gaps``) imports nothing of the program;
``program_config`` and ``serve_params`` import it inside them.

Model FLOPs count the expanded attention (2 H (192 + 128) a query-key
pair and layer), every linear a token passes (the MLA projections, the
dense MLPs, the router and the shared expert) and, of the routed experts,
the held share a token is expected to reach: top-k x held / routed (8 x 8 /
256 = 0.25 expert a token and MoE layer).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import BLOCK, encode_page, exact_float32, page_patches
from gpubench.weights import SCALE, tower, vision_shapes

IMAGE_PLACEHOLDER = "<|img|><|imgpad|><|endofimg|>"
YARN_KEYS = ("factor", "original_max_position_embeddings", "beta_fast", "beta_slow", "mscale",
             "mscale_all_dim")


# -- the program's side ------------------------------------------------------------

def program_config(dims: dict):
    """The program's ``DotsOCRConfig`` of the configuration's ``model``."""
    from dots_ocr_tpu_torch.models.config import (
        DeepseekConfig,
        DeepseekDecoderConfig,
        DotsOCRConfig,
        SpecialTokens,
        VisionConfig,
        YarnRope,
    )

    c = dims["decoder"]
    y = c["rope_scaling"]
    deepseek = DeepseekConfig(
        q_lora_rank=c["q_lora_rank"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"], qk_rope_head_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], first_k_dense_replace=c["first_k_dense_replace"],
        moe_intermediate_size=c["moe_intermediate_size"], n_routed_experts=c["n_routed_experts"],
        experts_held=tuple(c["experts_held"]), num_experts_per_tok=c["num_experts_per_tok"],
        n_group=c["n_group"], topk_group=c["topk_group"],
        routed_scaling_factor=c["routed_scaling_factor"], norm_topk_prob=c["norm_topk_prob"],
        n_shared_experts=c["n_shared_experts"],
        rope_scaling=YarnRope(**{k: y[k] for k in YARN_KEYS}) if y else None)
    decoder = DeepseekDecoderConfig(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_layers=c["num_hidden_layers"], num_heads=c["num_attention_heads"],
        num_kv_heads=c["num_key_value_heads"], head_dim=c["v_head_dim"],
        intermediate_size=c["intermediate_size"], rms_norm_eps=c["rms_norm_eps"],
        rope_theta=float(c["rope_theta"]), qkv_bias=c["attention_bias"],
        tie_word_embeddings=c["tie_word_embeddings"],
        max_position_embeddings=c["max_position_embeddings"], deepseek=deepseek)
    vision = {k: tuple(v) if isinstance(v, list) else v for k, v in dims["vision"].items()}
    return DotsOCRConfig(vision=VisionConfig(**vision), decoder=decoder,
                         special=SpecialTokens(**dims["special"]), dtype=dims["dtype"])


def serve_params(weights: dict, dims: dict, quantize: str, vision_quantize: str) -> dict:
    """The program's parameter tree over the benchmark's weights, its decoder
    at ``quantize`` ("none", or "int8": W8A16 on the MLA query and output
    projections, the dense and shared-expert MLPs, the embedding and the
    lm_head) and its vision tower at ``vision_quantize`` ("none" or W8A8
    "int8")."""
    from dots_ocr_tpu_torch.models.quantize import (
        quantize_decoder_params,
        quantize_vision_params,
    )

    params = {"vision": weights["vision"], "decoder": weights["decoder"]}
    if quantize == "int8":
        params = quantize_decoder_params(params)
    elif quantize != "none":
        raise ValueError(f"QUANTIZE {quantize!r}")
    if vision_quantize == "int8":
        params = quantize_vision_params(params)
    elif vision_quantize != "none":
        raise ValueError(f"VISION_QUANTIZE {vision_quantize!r}")
    return params


# -- the seeded weights ------------------------------------------------------------

def decoder_shapes(dims: dict) -> Dict:
    """The decoder tree in the program's layout (``models/mla.py``)."""
    c = dims["decoder"]
    n, d, heads = c["num_hidden_layers"], c["hidden_size"], c["num_attention_heads"]
    nd, rank = c["first_k_dense_replace"], c["kv_lora_rank"]
    nm, e, ie = n - nd, c["n_routed_experts"], c["moe_intermediate_size"]
    held, shared = c["experts_held"][1], c["n_shared_experts"] * c["moe_intermediate_size"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return {
        "embed": (c["vocab_size"], d),
        "blocks": {
            "input_norm": (n, d), "post_attn_norm": (n, d),
            "attn": {"q_a": (n, d, c["q_lora_rank"]), "q_a_norm": (n, c["q_lora_rank"]),
                     "q_b": (n, c["q_lora_rank"], heads * qk),
                     "kv_a": (n, d, rank + c["qk_rope_head_dim"]), "kv_a_norm": (n, rank),
                     "kv_b": (n, rank, heads * (c["qk_nope_head_dim"] + c["v_head_dim"])),
                     "wo": (n, heads * c["v_head_dim"], d)},
        },
        "dense": {"gate": (nd, d, c["intermediate_size"]), "up": (nd, d, c["intermediate_size"]),
                  "down": (nd, c["intermediate_size"], d)},
        "moe": {"router": (nm, d, e), "correction": (nm, e), "gate": (nm, held, d, ie),
                "up": (nm, held, d, ie), "down": (nm, held, ie, d)},
        "shared": {"gate": (nm, d, shared), "up": (nm, d, shared), "down": (nm, shared, d)},
        "final_norm": (d,),
        "lm_head": (d, c["vocab_size"]),
    }


def make_weights(dims: dict, seed: int, device, dtype=torch.bfloat16,
                 init: Optional[dict] = None) -> Dict:
    """{"vision", "decoder"} of the configuration's shapes, from ``seed``;
    ``init`` is the configuration's ``weights`` ({"std", "final_norm_gain"})."""
    init = init or {}
    std = float(init.get("std", SCALE))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & 0xFFFF_FFFF_FFFF_FFFF)
    gain = {"final_norm": float(init.get("final_norm_gain", 1.0))}
    return {"vision": tower(vision_shapes(dims), gen, dtype, device, std, {}),
            "decoder": tower(decoder_shapes(dims), gen, dtype, device, std, gain)}


# -- the plain reference (a copy of reference/dotsvlm1.py's decoder) ------------------

def _rms(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight.float()


def _lin(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x.float() @ w.float()


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal softmax attention in float32 over [T, H, *], in blocks of
    query rows."""
    t = q.shape[0]
    kt, vt = k.transpose(0, 1), v.transpose(0, 1)
    out = q.new_empty(t, q.shape[1], v.shape[-1])
    for lo in range(0, t, BLOCK):
        hi = min(t, lo + BLOCK)
        s = torch.matmul(q[lo:hi].transpose(0, 1), kt.transpose(1, 2)) * scale
        keep = (torch.arange(k.shape[0], device=q.device)[None]
                <= torch.arange(lo, hi, device=q.device)[:, None])
        s = s.masked_fill(~keep, float("-inf"))
        out[lo:hi] = torch.matmul(torch.softmax(s, -1), vt).transpose(0, 1)
    return out


def yarn_get_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def softmax_scale(c: dict) -> float:
    """qk_head_dim^-0.5 times mscale(factor, mscale_all_dim)^2."""
    scale = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    y = c.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        scale *= yarn_get_mscale(y["factor"], y["mscale_all_dim"]) ** 2
    return scale


def yarn_cos_sin(t: int, c: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek's YaRN cos and sin [t, rope_dim] at positions 0 .. t - 1."""
    dim, base, y = c["qk_rope_head_dim"], float(c["rope_theta"]), c["rope_scaling"]
    factor, orig = y["factor"], y["original_max_position_embeddings"]
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra, inter = 1.0 / pos_freqs, 1.0 / (factor * pos_freqs)

    def correction_dim(rotations):
        return (dim * math.log(orig / (rotations * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(correction_dim(y["beta_fast"])), 0)
    high = min(math.ceil(correction_dim(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low), 0, 1)
    mask = 1.0 - ramp
    inv_freq = inter * (1 - mask) + extra * mask
    freqs = torch.outer(torch.arange(t, dtype=torch.float32), inv_freq)
    emb = torch.cat([freqs, freqs], -1)
    m = yarn_get_mscale(factor, y["mscale"]) / yarn_get_mscale(factor, y["mscale_all_dim"])
    return (emb.cos() * m).to(device), (emb.sin() * m).to(device)


def rope_interleaved(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1) * sin


def mla(x: torch.Tensor, a: dict, c: dict, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Multi-head latent attention over x [T, D], expanded, causal."""
    t, heads, eps = x.shape[0], c["num_attention_heads"], c["rms_norm_eps"]
    dn, dr, dv, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                        c["kv_lora_rank"])
    q = _lin(_rms(_lin(x, a["q_a"]), a["q_a_norm"], eps), a["q_b"]).reshape(t, heads, dn + dr)
    q_nope, q_pe = q[..., :dn], rope_interleaved(q[..., dn:], cos[:, None], sin[:, None])
    kv = _lin(x, a["kv_a"])
    latent, k_pe = _rms(kv[:, :rank], a["kv_a_norm"], eps), rope_interleaved(kv[:, rank:],
                                                                              cos, sin)
    kvb = _lin(latent, a["kv_b"]).reshape(t, heads, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe[:, None].expand(t, heads, dr)], -1)
    out = _attention(torch.cat([q_nope, q_pe], -1), k, kvb[..., dn:], softmax_scale(c))
    return _lin(out.reshape(t, heads * dv), a["wo"])


def route(x: torch.Tensor, router: torch.Tensor, correction: torch.Tensor,
          c: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """``noaux_tc`` over all experts: (expert ids [T, k], weights [T, k])."""
    scores = torch.sigmoid(_lin(x, router))
    choice = scores + correction.float()
    t, e = choice.shape
    g = c["n_group"]
    group_scores = choice.view(t, g, e // g).topk(2, dim=-1).values.sum(-1)
    top_groups = torch.sort(group_scores, dim=-1, descending=True, stable=True).indices
    keep = torch.zeros(t, g, dtype=torch.bool, device=x.device)
    keep.scatter_(1, top_groups[:, :c["topk_group"]], True)
    choice = choice.masked_fill(~keep.repeat_interleave(e // g, 1), 0.0)
    order = torch.sort(choice, dim=-1, descending=True, stable=True).indices
    idx = order[:, :c["num_experts_per_tok"]]
    w = scores.gather(1, idx)
    if c["norm_topk_prob"] and c["num_experts_per_tok"] > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * c["routed_scaling_factor"]


def _swiglu(x: torch.Tensor, gate, up, down) -> torch.Tensor:
    return _lin(F.silu(_lin(x, gate)) * _lin(x, up), down)


def moe(x: torch.Tensor, m: dict, s: dict, c: dict) -> torch.Tensor:
    """The shared experts plus the held routed experts' weighted outputs."""
    idx, w = route(x, m["router"], m["correction"], c)
    first, count = c["experts_held"]
    out = _swiglu(x, s["gate"], s["up"], s["down"])
    for e in range(count):
        tok, slot = torch.nonzero(idx == first + e, as_tuple=True)
        if tok.numel():
            y = _swiglu(x[tok], m["gate"][e], m["up"][e], m["down"][e])
            out = out.index_add(0, tok, y * w[tok, slot, None])
    return out


def decoder_hidden(decoder: dict, dims: dict, x: torch.Tensor) -> torch.Tensor:
    """Input embeddings [T, D] -> final-normed hidden states [T, D]."""
    c = dims["decoder"]
    eps, t = c["rms_norm_eps"], x.shape[0]
    cos, sin = yarn_cos_sin(t, c, x.device)
    b = decoder["blocks"]
    x = x.float()
    for i in range(c["num_hidden_layers"]):
        x = x + mla(_rms(x, b["input_norm"][i], eps), {k: w[i] for k, w in b["attn"].items()},
                    c, cos, sin)
        h = _rms(x, b["post_attn_norm"][i], eps)
        j = i - c["first_k_dense_replace"]
        if j < 0:
            d = decoder["dense"]
            x = x + _swiglu(h, d["gate"][i], d["up"][i], d["down"][i])
        else:
            x = x + moe(h, {k: w[j] for k, w in decoder["moe"].items()},
                        {k: w[j] for k, w in decoder["shared"].items()}, c)
    return _rms(x, decoder["final_norm"], eps)


def special_ids(dims: dict) -> Dict[str, int]:
    s = dims["special"]
    return {"<|endoftext|>": s["pad_token_id"], "<|im_start|>": s["im_start_id"],
            "<|im_end|>": s["im_end_id"], "<|img|>": s["img_id"],
            "<|imgpad|>": s["imgpad_id"], "<|endofimg|>": s["endofimg_id"]}


def prompt_ids(prompt: str, vision_tokens: int, dims: dict) -> List[int]:
    """The chat-formatted prompt of one page (dots.ocr's layout over the byte
    tokenizer with the configuration's special ids)."""
    from gpubench.reference import byte_tokens

    sp = special_ids(dims)
    text = f"<|im_start|>user\n{IMAGE_PLACEHOLDER}{prompt}<|im_end|>\n<|im_start|>assistant\n"
    before, after = text.split(IMAGE_PLACEHOLDER)
    return (byte_tokens(before, sp) + [sp["<|img|>"]] + [sp["<|imgpad|>"]] * vision_tokens
            + [sp["<|endofimg|>"]] + byte_tokens(after, sp))


def served_gaps(weights: dict, dims: dict, quantize: str, pixels: Optional[np.ndarray],
                prompt: str, served: Sequence[int]) -> torch.Tensor:
    """For each served token, the reference's best logit minus its logit for
    that token, at the position the program produced it. The reference is
    float32 at the configuration's precision (bf16 weights as drawn):
    ``quantize`` must be "none". Returns float32 [len(served)] on the
    weights' device."""
    if quantize != "none":
        raise ValueError("the dots.vlm1 reference holds bf16 weights only")
    device = weights["decoder"]["embed"].device
    with torch.no_grad(), exact_float32():
        merged, vision_tokens = None, 0
        if pixels is not None:
            patches, pos = page_patches(pixels, dims, device)
            merged = encode_page(weights["vision"], dims, patches, pos)
            vision_tokens = merged.shape[0]
        ids = prompt_ids(prompt, vision_tokens, dims)
        seq = torch.tensor(ids + list(served[:-1]), device=device)
        x = weights["decoder"]["embed"][seq].float()
        if merged is not None:  # the prompt's pads; a served pad token keeps its embedding
            pads = torch.nonzero(seq == dims["special"]["imgpad_id"])[:vision_tokens, 0]
            x[pads] = merged
        del merged
        hidden = decoder_hidden(weights["decoder"], dims, x)[len(ids) - 1:]
        head = weights["decoder"]["lm_head"].float()
        served_t = torch.tensor(list(served), device=device)
        gaps = []
        for lo in range(0, hidden.shape[0], BLOCK):
            logits = hidden[lo:lo + BLOCK] @ head
            chosen = logits.gather(1, served_t[lo:lo + BLOCK, None])[:, 0]
            gaps.append(logits.amax(1) - chosen)
        return torch.cat(gaps)


# -- parameter counts, model FLOPs, KV bytes -------------------------------------------

def vision_linear_params(dims: dict) -> Tuple[int, int, int]:
    """(patch-embed, block linears over all layers, merger) weights."""
    v = dims["vision"]
    d, i, a = v["hidden_size"], v["intermediate_size"], v["num_heads"] * v["head_dim"]
    patch_dim = v["in_channels"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    md = d * v["spatial_merge_size"] ** 2
    blocks = v["num_layers"] * (3 * d * a + a * d + 3 * d * i)
    merger = md * md + md * dims["decoder"]["hidden_size"]
    return patch_dim * d, blocks, merger


def decoder_linear_shapes(dims: dict) -> List[Tuple[int, int]]:
    """(in, out) of one layer's MLA linears (q_a, q_b, kv_a, kv_b, o_proj)."""
    c = dims["decoder"]
    d, heads, rank = c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    return [(d, c["q_lora_rank"]), (c["q_lora_rank"], heads * qk),
            (d, rank + c["qk_rope_head_dim"]),
            (rank, heads * (c["qk_nope_head_dim"] + c["v_head_dim"])),
            (heads * c["v_head_dim"], d)]


def token_linear_params(dims: dict) -> float:
    """Weights of the decoder's linears one token passes, over all layers:
    MLA, the dense MLPs, and in each MoE layer the router, the shared
    experts and the held share of its routed experts (top-k x held /
    routed)."""
    c = dims["decoder"]
    n, nd, d = c["num_hidden_layers"], c["first_k_dense_replace"], c["hidden_size"]
    mla_params = sum(k * m for k, m in decoder_linear_shapes(dims))
    dense = 3 * d * c["intermediate_size"]
    expert = 3 * d * c["moe_intermediate_size"]
    reached = c["num_experts_per_tok"] * c["experts_held"][1] / c["n_routed_experts"]
    moe_layer = d * c["n_routed_experts"] + expert * (c["n_shared_experts"] + reached)
    return n * mla_params + nd * dense + (n - nd) * moe_layer


def attention_flops_per_pair(dims: dict) -> float:
    """Expanded MLA over all layers: 2 H (qk_head_dim + v_head_dim) a
    (query, key) pair and layer."""
    c = dims["decoder"]
    per = 2.0 * c["num_attention_heads"] * (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
                                             + c["v_head_dim"])
    return per * c["num_hidden_layers"]


def kv_bytes_per_token(dims: dict, kv_dtype: str = "bf16") -> int:
    """Bytes of the latent cache a token of context holds over all layers
    (bf16: (512 + 64) x 2 B x 7 layers = 8,064)."""
    if kv_dtype != "bf16":
        raise ValueError("the latent cache is bf16")
    c = dims["decoder"]
    return (c["kv_lora_rank"] + c["qk_rope_head_dim"]) * 2 * c["num_hidden_layers"]


def vision_flops(patches: int, dims: dict) -> float:
    """One page through the encoder, the merge and the projector: 2 x
    weights x tokens, and image-wide attention 4 T^2 H d a layer."""
    v = dims["vision"]
    embed, blocks, merger = vision_linear_params(dims)
    merged = patches // v["spatial_merge_size"] ** 2
    attn = 4.0 * patches * patches * v["num_heads"] * v["head_dim"] * v["num_layers"]
    return 2.0 * (embed + blocks) * patches + 2.0 * merger * merged + attn


def prompt_flops(prompt_tokens: int, dims: dict) -> float:
    """A prompt's prefill: every token's linears, causal attention over its
    prefix, and one vocabulary projection for the first token."""
    c = dims["decoder"]
    pairs = prompt_tokens * (prompt_tokens + 1) / 2.0
    return (2.0 * token_linear_params(dims) * prompt_tokens
            + attention_flops_per_pair(dims) * pairs + 2.0 * c["vocab_size"] * c["hidden_size"])


def generated_flops(tokens: float, context_sum: float, dims: dict) -> float:
    """``tokens`` generated tokens whose contexts add up to ``context_sum``."""
    c = dims["decoder"]
    per = 2.0 * token_linear_params(dims) + 2.0 * c["vocab_size"] * c["hidden_size"]
    return per * tokens + attention_flops_per_pair(dims) * context_sum


def mla_decode_work(context_tokens: float, rows: float, dims: dict) -> Tuple[float, float]:
    """(operations, bytes) of the paged latent kernel over one layer:
    ``context_tokens`` tokens of context for ``rows`` query rows. Scores over
    576 values and values over 512 a head, a multiply-add each; each
    context row read once (bf16), each query row read and its output
    written once."""
    c = dims["decoder"]
    width, rank = c["kv_lora_rank"] + c["qk_rope_head_dim"], c["kv_lora_rank"]
    heads = c["num_attention_heads"]
    ops = context_tokens * heads * (width + rank) * 2.0
    nbytes = context_tokens * width * 2.0 + rows * heads * (width + rank) * 2.0
    return ops, nbytes
