"""The yardstick's arithmetic: the card's peaks, the page-size rule, and the
operations and bytes of the model and of its kernels, all from shapes.

Nothing here reads the program. The peaks are NVIDIA's H100 SXM data sheet
(dense, 700 W); a share of a peak is only meaningful beside the card's
power limit, which every run prints.

``dims`` below is the ``model`` section of a configuration file
(``configs/<name>.json``): ``vision`` and ``decoder`` dicts of the
published sizes.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}

# smart_resize's grid (patch 14 x merge 2) and pixel bounds, as the
# reference parser sets them (dots_ocr/utils/consts.py).
IMAGE_FACTOR = 28
MIN_PIXELS = 3136
MAX_PIXELS = 11289600


def round_by_factor(number: float, factor: int) -> int:
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    return math.floor(number / factor) * factor


def smart_resize(height: int, width: int, factor: int = IMAGE_FACTOR,
                 min_pixels: int = MIN_PIXELS, max_pixels: int = MAX_PIXELS) -> Tuple[int, int]:
    """(h, w) on the ``factor`` grid with h * w inside [min_pixels,
    max_pixels], max_pixels winning (the reference parser's rule)."""
    if max(height, width) / min(height, width) > 200:
        raise ValueError("absolute aspect ratio must be smaller than 200")
    h_bar = max(factor, round_by_factor(height, factor))
    w_bar = max(factor, round_by_factor(width, factor))
    if h_bar * w_bar > max_pixels:
        beta = math.sqrt((height * width) / max_pixels)
        h_bar = max(factor, floor_by_factor(height / beta, factor))
        w_bar = max(factor, floor_by_factor(width / beta, factor))
    elif h_bar * w_bar < min_pixels:
        beta = math.sqrt(min_pixels / (height * width))
        h_bar = ceil_by_factor(height * beta, factor)
        w_bar = ceil_by_factor(width * beta, factor)
        if h_bar * w_bar > max_pixels:
            beta = math.sqrt((height * width) / max_pixels)
            h_bar = max(factor, floor_by_factor(height / beta, factor))
            w_bar = max(factor, floor_by_factor(width / beta, factor))
    return h_bar, w_bar


def page_patches(h: int, w: int, dims: dict) -> Tuple[int, int]:
    """(raw patches, merged vision tokens) of an image already on the grid."""
    v = dims["vision"]
    p, m = v["patch_size"], v["spatial_merge_size"]
    patches = (h // p) * (w // p)
    return patches, patches // (m * m)


def bound_s(flops: float, nbytes: float, kind: str = "bf16") -> float:
    """The least seconds the card could take for ``flops`` operations at the
    ``kind`` tensor-core peak that must move ``nbytes`` through HBM."""
    return max(flops / PEAK_OPS_PER_S[kind], nbytes / HBM_BYTES_PER_S)


# -- parameter counts --------------------------------------------------------

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


def decoder_linear_shapes(dims: dict) -> Iterable[Tuple[int, int]]:
    """(in, out) of one decoder layer's linears."""
    c = dims["decoder"]
    d, i = c["hidden_size"], c["intermediate_size"]
    q, kv = c["num_heads"] * c["head_dim"], c["num_kv_heads"] * c["head_dim"]
    return [(d, q), (d, kv), (d, kv), (q, d), (d, i), (d, i), (i, d)]


def int8_decoder_bytes(dims: dict) -> float:
    """Bytes one decode or verify iteration reads of an int8 decoder: every
    block linear and the tied lm_head once, with their float32 scales."""
    c = dims["decoder"]
    per_layer = sum(k * n + 4 * n for k, n in decoder_linear_shapes(dims))
    head = c["vocab_size"] * (c["hidden_size"] + 4)
    return float(c["num_layers"] * per_layer + head)


def kv_bytes_per_token(dims: dict, kv_dtype: str = "bf16") -> int:
    """Bytes of K and V a decode step reads for one token of context over all
    layers (bf16: 2 KV heads x 128 x 2 B x 2 x 28 = 28,672)."""
    c = dims["decoder"]
    per = c["num_kv_heads"] * (c["head_dim"] * (1 if kv_dtype == "int8" else 2)
                               + (4 if kv_dtype == "int8" else 0))
    return 2 * per * c["num_layers"]


# -- model FLOPs -------------------------------------------------------------

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


# -- kernel bounds -----------------------------------------------------------

def flash_image_bound(image_patches: Iterable[int], padded: int, dims: dict) -> Tuple[float, float]:
    """Kernel 1 over one packed encoder call (one layer): (operations,
    bytes). 4 H d operations per (query, key) pair of one image; q, k, v and
    out of the padded token axis once, and the segment ids."""
    v = dims["vision"]
    hd = v["num_heads"] * v["head_dim"]
    pairs = sum(t * t for t in image_patches)
    return 4.0 * pairs * hd, 4 * padded * hd * 2 + 2 * 4 * padded


def flash_causal_bound(rows: Iterable[Tuple[int, int]], q_offset: int, chunk: int,
                       kv_len: int, dims: dict) -> Tuple[float, float]:
    """Kernel 1 over one causal decoder call (one layer): ``rows`` is
    (valid query rows, prompt length) per batch row; queries at positions
    q_offset.. attend to keys up to their own. Bytes: q and out of the
    chunk, k and v of ``kv_len`` keys, once."""
    c = dims["decoder"]
    q_hd = c["num_heads"] * c["head_dim"]
    kv_hd = c["num_kv_heads"] * c["head_dim"]
    pairs, nbytes = 0.0, 0.0
    for valid, _ in rows:
        # positions q_offset .. q_offset + valid - 1, each sees pos + 1 keys
        pairs += valid * q_offset + valid * (valid + 1) / 2.0
        nbytes += 2 * chunk * q_hd * 2 + 2 * kv_len * kv_hd * 2
    return 4.0 * pairs * q_hd, nbytes


def w8a16_prefill_bound(rows: int, dims: dict) -> Tuple[float, float]:
    """The W8A16 linears of one decoder forward over ``rows`` tokens:
    operations, and each int8 weight with its scales read once, the
    activations in and out once."""
    c = dims["decoder"]
    layers = c["num_layers"]
    ops = 2.0 * rows * decoder_linear_params(dims)
    nbytes = layers * sum(k * n + 4 * n + 2 * rows * (k + n)
                          for k, n in decoder_linear_shapes(dims))
    return ops, float(nbytes)


def w8a16_decode_bound(rows: float, dims: dict) -> Tuple[float, float]:
    """One decode or verify iteration of ``rows`` query rows: the block
    linears and the tied lm_head."""
    c = dims["decoder"]
    ops = 2.0 * rows * (decoder_linear_params(dims) + c["vocab_size"] * c["hidden_size"])
    return ops, int8_decoder_bytes(dims)


def interval_tokens(first_at: float, finished_at: float, n_out: int, prompt: int,
                    a: float, b: float) -> Tuple[float, float]:
    """(tokens, their context sum) of a request's decode that fall in [a, b],
    its ``n_out`` tokens spread evenly over [first_at, finished_at]; token
    j (0-based) is read against prompt + j tokens of context."""
    if n_out <= 1 or finished_at <= first_at:
        return 0.0, 0.0
    lo, hi = max(a, first_at), min(b, finished_at)
    if hi <= lo:
        return 0.0, 0.0
    rate = (n_out - 1) / (finished_at - first_at)
    j0, j1 = (lo - first_at) * rate, (hi - first_at) * rate
    count = j1 - j0
    return count, count * (prompt + 1 + (j0 + j1) / 2.0)


def share(bound: float, measured: float) -> Optional[float]:
    """A share of a bound in percent; None where nothing was measured."""
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured
