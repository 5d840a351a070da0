"""dots.vlm1 (rednote-hilab/dots.vlm1.inst) in plain float32 PyTorch: the
NaViT encoder, the 2 x 2 merger that projects to the decoder's width, and
DeepSeek-V3's decoder (MLA, YaRN rope, dense layers then MoE layers).

No kernels, no cache, no batching: one page and one token sequence at a
time, attention expanded and causal in blocks of query rows. It imports
nothing of the program under test (``dots_ocr_tpu_torch``) and nothing of
JAX; it is written from the published description (the model's config.json
and DeepSeek-V3's modeling code), and the program is held to it.

Departures from the published model, each also made by the program:
  * the multi-token-prediction layer (``num_nextn_predict_layers`` 1) is
    left out: it drafts tokens and does not change the served logits;
  * expert parallelism's share: only the routed experts ``experts_held``
    (first, count) are computed. Routing runs over all ``n_routed_experts``;
    an assignment to an expert not held adds nothing (what one rank of an
    expert-parallel deployment computes before its exchange);
  * ties in the router's group and expert choice go to the lower index
    (DeepSeek's code leaves them to ``torch.topk``);
  * depth: as many layers as ``num_hidden_layers`` says (a cut
    configuration's, not 61).

``dims`` is a configuration's ``model`` section: ``vision`` (dots.ocr's
NaViT keys), ``decoder`` (the DeepSeek-V3 config.json keys, with
``experts_held``), ``special`` and ``dtype``. ``weights`` is the tree of
``{"vision", "decoder"}`` in the program's layout (kernels ``[in, out]``).

    logits = forward(weights, dims, ids, vision_tokens)   # [T, V] float32
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

BLOCK = 1024  # query rows per attention block


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight.float()


def lin(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x.float() @ w.float()
    return y if b is None else y + b.float()


# -- the encoder (dots.ocr's NaViT) and the merger ---------------------------------

def page_patches(pixels: np.ndarray, dims: dict, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """[h, w, 3] uint8 -> (normalised patches [T, 588] with each 2 x 2 merge
    group contiguous, merge groups row-major; (row, col) of each patch)."""
    v = dims["vision"]
    p, m = v["patch_size"], v["spatial_merge_size"]
    h, w, c = pixels.shape
    gh, gw = h // p, w // p
    x = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
    x = x.reshape(gh // m, m, p, gw // m, m, p, c).permute(0, 3, 1, 4, 2, 5, 6)
    patches = x.reshape(gh * gw, p * p * c).float() / 255.0
    mean = torch.tensor(v["image_mean"], device=device).repeat(p * p)
    std = torch.tensor(v["image_std"], device=device).repeat(p * p)
    r = torch.arange(gh, device=device).reshape(gh // m, m, 1, 1).expand(gh // m, m, gw // m, m)
    col = torch.arange(gw, device=device).reshape(1, 1, gw // m, m).expand(gh // m, m, gw // m, m)
    pos = torch.stack([r.permute(0, 2, 1, 3).reshape(-1), col.permute(0, 2, 1, 3).reshape(-1)], -1)
    return (patches - mean) / std, pos


def _inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim)


def _rope_halves(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    cos = torch.cat([angles.cos(), angles.cos()], -1)[:, None]
    sin = torch.cat([angles.sin(), angles.sin()], -1)[:, None]
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], -1) * sin


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
               scale: float) -> torch.Tensor:
    """Softmax attention in float32 over [T, H, *] (k, v with H heads too),
    in blocks of query rows."""
    t = q.shape[0]
    kt, vt = k.transpose(0, 1), v.transpose(0, 1)
    out = q.new_empty(t, q.shape[1], v.shape[-1])
    for lo in range(0, t, BLOCK):
        hi = min(t, lo + BLOCK)
        s = torch.matmul(q[lo:hi].transpose(0, 1), kt.transpose(1, 2)) * scale
        if causal:
            keep = (torch.arange(k.shape[0], device=q.device)[None]
                    <= torch.arange(lo, hi, device=q.device)[:, None])
            s = s.masked_fill(~keep, float("-inf"))
        out[lo:hi] = torch.matmul(torch.softmax(s, -1), vt).transpose(0, 1)
    return out


def encode_page(vision: dict, dims: dict, patches: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One page's patches -> its merged tokens [T / 4, hidden] (the merger
    projects to the decoder's width): post-norm blocks with 2D rope and
    image-wide attention, a final norm, then RMSNorm, fc1, GELU (tanh), fc2
    over each 2 x 2 group."""
    v = dims["vision"]
    hd, eps, t = v["head_dim"], v["rms_norm_eps"], patches.shape[0]
    freqs = _inv_freq(hd // 2, v["rope_theta"], patches.device)
    angles = torch.cat([pos[:, :1].float() * freqs, pos[:, 1:].float() * freqs], -1)
    x = lin(patches, vision["patch_embed"]["kernel"], vision["patch_embed"]["bias"])
    b = vision["blocks"]
    for i in range(v["num_layers"]):
        a = {k: w[i] for k, w in b["attn"].items()}
        q = _rope_halves(lin(x, a["wq"], a["bq"]).reshape(t, -1, hd), angles)
        k = _rope_halves(lin(x, a["wk"], a["bk"]).reshape(t, -1, hd), angles)
        val = lin(x, a["wv"], a["bv"]).reshape(t, -1, hd)
        x = rms_norm(x + lin(_attention(q, k, val, False, hd ** -0.5).reshape(t, -1), a["wo"]),
                     b["norm1"][i], eps)
        m = {k: w[i] for k, w in b["mlp"].items()}
        x = rms_norm(x + lin(F.silu(lin(x, m["gate"])) * lin(x, m["up"]), m["down"]),
                     b["norm2"][i], eps)
    x = rms_norm(x, vision["post_norm"], eps)
    mg = vision["merger"]
    h = rms_norm(x.reshape(t // v["spatial_merge_size"] ** 2, -1), mg["norm"], eps)
    return lin(F.gelu(lin(h, mg["fc1"], mg["b1"]), approximate="tanh"), mg["fc2"], mg["b2"])


# -- DeepSeek-V3's decoder -------------------------------------------------------

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
    """``DeepseekV3YarnRotaryEmbedding``'s cos and sin [t, rope_dim] at
    positions 0 .. t - 1."""
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
    """DeepSeek's ``apply_rotary_pos_emb``: interleaved pairs reordered to
    halves, then rotate-half."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return x * cos + torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1) * sin


def mla(x: torch.Tensor, a: dict, c: dict, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Multi-head latent attention over x [T, D], expanded, causal."""
    t, heads, eps = x.shape[0], c["num_attention_heads"], c["rms_norm_eps"]
    dn, dr, dv, rank = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                        c["kv_lora_rank"])
    q = lin(rms_norm(lin(x, a["q_a"]), a["q_a_norm"], eps), a["q_b"]).reshape(t, heads, dn + dr)
    q_nope, q_pe = q[..., :dn], rope_interleaved(q[..., dn:], cos[:, None], sin[:, None])
    kv = lin(x, a["kv_a"])
    latent, k_pe = rms_norm(kv[:, :rank], a["kv_a_norm"], eps), rope_interleaved(kv[:, rank:],
                                                                                  cos, sin)
    kvb = lin(latent, a["kv_b"]).reshape(t, heads, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe[:, None].expand(t, heads, dr)], -1)
    out = _attention(torch.cat([q_nope, q_pe], -1), k, kvb[..., dn:], True, softmax_scale(c))
    return lin(out.reshape(t, heads * dv), a["wo"])


def route(x: torch.Tensor, router: torch.Tensor, correction: torch.Tensor,
          c: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """``noaux_tc``: sigmoid scores; score plus correction for the choice
    only; groups by the sum of their top two, the best ``topk_group`` kept;
    the top ``num_experts_per_tok``; weights the chosen unbiased scores,
    normalised, times ``routed_scaling_factor``."""
    scores = torch.sigmoid(lin(x, router))
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


def swiglu(x: torch.Tensor, gate, up, down) -> torch.Tensor:
    return lin(F.silu(lin(x, gate)) * lin(x, up), down)


def moe(x: torch.Tensor, m: dict, s: dict, c: dict) -> torch.Tensor:
    """The shared experts plus the held routed experts' weighted outputs."""
    idx, w = route(x, m["router"], m["correction"], c)
    first, count = c["experts_held"]
    out = swiglu(x, s["gate"], s["up"], s["down"])
    for e in range(count):
        tok, slot = torch.nonzero(idx == first + e, as_tuple=True)
        if tok.numel():
            y = swiglu(x[tok], m["gate"][e], m["up"][e], m["down"][e])
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
        x = x + mla(rms_norm(x, b["input_norm"][i], eps), {k: w[i] for k, w in b["attn"].items()},
                    c, cos, sin)
        h = rms_norm(x, b["post_attn_norm"][i], eps)
        j = i - c["first_k_dense_replace"]
        if j < 0:
            d = decoder["dense"]
            x = x + swiglu(h, d["gate"][i], d["up"][i], d["down"][i])
        else:
            x = x + moe(h, {k: w[j] for k, w in decoder["moe"].items()},
                        {k: w[j] for k, w in decoder["shared"].items()}, c)
    return rms_norm(x, decoder["final_norm"], eps)


def embed(weights: dict, dims: dict, ids: List[int],
          vision_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embeddings [T, D], the k-th image pad taking the k-th merged
    vision token; pads past the vision tokens (a generated pad token) keep
    their embedding, as the program embeds a generated token."""
    table = weights["decoder"]["embed"]
    seq = torch.tensor(ids, device=table.device)
    x = table[seq].float()
    if vision_tokens is not None:
        pads = torch.nonzero(seq == dims["special"]["imgpad_id"])[:vision_tokens.shape[0], 0]
        x[pads] = vision_tokens.float()
    return x


def forward(weights: dict, dims: dict, ids: List[int],
            vision_tokens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Logits [T, V] float32 of every position of ``ids``."""
    hidden = decoder_hidden(weights["decoder"], dims, embed(weights, dims, ids, vision_tokens))
    return hidden @ weights["decoder"]["lm_head"].float()


def page_tokens(weights: dict, dims: dict, pixels: np.ndarray) -> torch.Tensor:
    """A page's merged vision tokens."""
    patches, pos = page_patches(pixels, dims, weights["decoder"]["embed"].device)
    return encode_page(weights["vision"], dims, patches, pos)

