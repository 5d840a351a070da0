"""dots.ocr's architecture, as the harness needs it: the 42-layer NaViT
encoder (its shapes and its reference shared through ``weights.py`` and
``reference.py``) and a dense Qwen2.5 decoder (pre-norm,
q / k / v bias, RoPE at theta 1e6 on positions 0.., GQA 12 / 2, SwiGLU,
final RMSNorm, tied lm_head).

A configuration names this module by ``"arch": "dotsocr"``, and the harness
calls only the contract's functions (README.md). The reference side
(``make_weights``, ``prompt_ids``, ``served_gaps``) imports nothing of the
program; ``program_config`` and ``serve_params`` import it inside them.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gpubench.reference import (
    BLOCK,
    attention,
    byte_tokens,
    encode_page,
    exact_float32,
    inv_freq,
    lin,
    page_patches,
    quantize_int8,
    rms_norm,
    rope_halves,
)
from gpubench.weights import SCALE, tower, vision_shapes

IMAGE_PLACEHOLDER = "<|img|><|imgpad|><|endofimg|>"


# -- the program's side ------------------------------------------------------------

def program_config(dims: dict):
    """The program's ``DotsOCRConfig`` of the configuration's ``model``."""
    from dots_ocr_tpu_torch.models.config import (
        DecoderConfig,
        DotsOCRConfig,
        SpecialTokens,
        VisionConfig,
    )

    vision = {k: tuple(v) if isinstance(v, list) else v for k, v in dims["vision"].items()}
    return DotsOCRConfig(vision=VisionConfig(**vision), decoder=DecoderConfig(**dims["decoder"]),
                         special=SpecialTokens(**dims["special"]), dtype=dims["dtype"])


def serve_params(weights: dict, dims: dict, quantize: str, vision_quantize: str) -> dict:
    """The program's parameter tree over the benchmark's weights, its decoder
    at ``quantize`` ("none", "int8" W8A16 or "int4") and its vision tower at
    ``vision_quantize`` ("none" or the program's W8A8 "int8")."""
    from dots_ocr_tpu_torch.models.quantize import (
        quantize_decoder_params,
        quantize_decoder_params_int4,
        quantize_vision_params,
    )

    params = {"vision": weights["vision"], "decoder": weights["decoder"]}
    if quantize == "int8":
        params = quantize_decoder_params(params)
    elif quantize == "int4":
        params = quantize_decoder_params_int4(params)
    elif quantize != "none":
        raise ValueError(f"QUANTIZE {quantize!r}")
    if vision_quantize == "int8":
        params = quantize_vision_params(params)
    elif vision_quantize != "none":
        raise ValueError(f"VISION_QUANTIZE {vision_quantize!r}")
    return params


# -- the seeded weights ------------------------------------------------------------

def decoder_shapes(dims: dict) -> Dict:
    c = dims["decoder"]
    n, d, i = c["num_layers"], c["hidden_size"], c["intermediate_size"]
    q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    return {
        "embed": (c["vocab_size"], d),
        "blocks": {
            "input_norm": (n, d), "post_attn_norm": (n, d),
            "attn": {"wq": (n, d, q), "wk": (n, d, kv), "wv": (n, d, kv), "wo": (n, q, d),
                     "bq": (n, q), "bk": (n, kv), "bv": (n, kv)},
            "mlp": {"gate": (n, d, i), "up": (n, d, i), "down": (n, i, d)},
        },
        "final_norm": (d,),
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


# -- the plain reference -------------------------------------------------------------

def special_ids(dims: dict) -> Dict[str, int]:
    s = dims["special"]
    return {"<|endoftext|>": s["pad_token_id"], "<|im_start|>": s["im_start_id"],
            "<|im_end|>": s["im_end_id"], "<|img|>": s["img_id"],
            "<|imgpad|>": s["imgpad_id"], "<|endofimg|>": s["endofimg_id"]}


def prompt_ids(prompt: str, vision_tokens: int, dims: dict) -> List[int]:
    """The chat-formatted prompt of one page (the Qwen2.5 chat layout over
    the byte tokenizer with the config's special ids): the image
    placeholder first, its pad expanded to ``vision_tokens`` ids, then the
    generation prompt."""
    sp = special_ids(dims)
    text = f"<|im_start|>user\n{IMAGE_PLACEHOLDER}{prompt}<|im_end|>\n<|im_start|>assistant\n"
    before, after = text.split(IMAGE_PLACEHOLDER)
    return (byte_tokens(before, sp) + [sp["<|img|>"]] + [sp["<|imgpad|>"]] * vision_tokens
            + [sp["<|endofimg|>"]] + byte_tokens(after, sp))


class Decoder:
    """The decoder's float32 weights, one layer at a time, from the
    benchmark's weights as the configuration serves them (for an int8
    configuration symmetric per output channel, the tied embedding per
    vocabulary row)."""

    def __init__(self, decoder: dict, dims: dict, quantize: str):
        self.p, self.dims, self.int8 = decoder, dims, quantize == "int8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        return quantize_int8(w, axis=-2) if self.int8 else w.float()

    def embed_table(self) -> torch.Tensor:
        e = self.p["embed"]
        return quantize_int8(e, axis=1) if self.int8 else e.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Hidden states [T, D] -> final-normed hidden [T, D]."""
        c = self.dims["decoder"]
        hd, eps, t = c["head_dim"], c["rms_norm_eps"], x.shape[0]
        angles = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv_freq(
            hd, c["rope_theta"], x.device)
        b = self.p["blocks"]
        for i in range(c["num_layers"]):
            a = {k: w[i] for k, w in b["attn"].items()}
            h = rms_norm(x, b["input_norm"][i], eps)
            q = rope_halves(lin(h, self.weight(a["wq"]), a["bq"]).reshape(t, -1, hd), angles)
            k = rope_halves(lin(h, self.weight(a["wk"]), a["bk"]).reshape(t, -1, hd), angles)
            val = lin(h, self.weight(a["wv"]), a["bv"]).reshape(t, -1, hd)
            x = x + lin(attention(q, k, val, True).reshape(t, -1), self.weight(a["wo"]))
            m = {k: w[i] for k, w in b["mlp"].items()}
            h = rms_norm(x, b["post_attn_norm"][i], eps)
            gate, up = lin(h, self.weight(m["gate"])), lin(h, self.weight(m["up"]))
            x = x + lin(F.silu(gate) * up, self.weight(m["down"]))
        return rms_norm(x, self.p["final_norm"], eps)


def served_gaps(weights: dict, dims: dict, quantize: str, pixels: Optional[np.ndarray],
                prompt: str, served: Sequence[int]) -> torch.Tensor:
    """For each served token, the reference's best logit minus its logit for
    that token, at the position the program produced it (the first served
    token after the prompt, each later one after the tokens before it).
    Returns a float32 [len(served)] tensor on the weights' device."""
    device = weights["decoder"]["embed"].device
    with torch.no_grad(), exact_float32():
        merged = None
        vision_tokens = 0
        if pixels is not None:
            patches, pos = page_patches(pixels, dims, device)
            merged = encode_page(weights["vision"], dims, patches, pos)
            vision_tokens = merged.shape[0]
        ids = prompt_ids(prompt, vision_tokens, dims)
        dec = Decoder(weights["decoder"], dims, quantize)
        table = dec.embed_table()
        seq = torch.tensor(ids + list(served[:-1]), device=device)
        x = table[seq]
        if merged is not None:
            pad = dims["special"]["imgpad_id"]
            x[seq == pad] = merged
        del merged
        hidden = dec.forward(x)[len(ids) - 1:]
        served_t = torch.tensor(list(served), device=device)
        gaps = []
        for lo in range(0, hidden.shape[0], BLOCK):
            logits = hidden[lo:lo + BLOCK] @ table.t()
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


def decoder_linear_params(dims: dict) -> int:
    """Weights of the decoder's block linears over all layers."""
    c = dims["decoder"]
    d, i = c["hidden_size"], c["intermediate_size"]
    q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    return c["num_layers"] * (d * q + 2 * d * kv + q * d + 3 * d * i)


def decoder_linear_shapes(dims: dict) -> List[Tuple[int, int]]:
    """(in, out) of one decoder layer's linears."""
    c = dims["decoder"]
    d, i = c["hidden_size"], c["intermediate_size"]
    q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    return [(d, q), (d, kv), (d, kv), (q, d), (d, i), (d, i), (i, d)]


def kv_bytes_per_token(dims: dict, kv_dtype: str = "bf16") -> int:
    """Bytes of K and V a decode step reads for one token of context over all
    layers (bf16: 2 KV heads x 128 x 2 B x 2 x 28 = 28,672)."""
    c = dims["decoder"]
    per = c["num_kv_heads"] * (c["head_dim"] * (1 if kv_dtype == "int8" else 2)
                               + (4 if kv_dtype == "int8" else 0))
    return 2 * per * c["num_layers"]


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
    n = decoder_linear_params(dims)
    pairs = prompt_tokens * (prompt_tokens + 1) / 2.0
    attn = 4.0 * pairs * c["num_heads"] * c["head_dim"] * c["num_layers"]
    return 2.0 * n * prompt_tokens + attn + 2.0 * c["vocab_size"] * c["hidden_size"]


def generated_flops(tokens: float, context_sum: float, dims: dict) -> float:
    """``tokens`` generated tokens whose contexts add up to ``context_sum``."""
    c = dims["decoder"]
    per = 2.0 * decoder_linear_params(dims) + 2.0 * c["vocab_size"] * c["hidden_size"]
    attn = 4.0 * c["num_heads"] * c["head_dim"] * c["num_layers"]
    return per * tokens + attn * context_sum
