"""The yardstick's arithmetic: the card's peaks, the page-size rule, and the
operations and bytes of the kernels, all from shapes. The model's own FLOPs,
parameter counts and KV bytes depend on its architecture and are the
configuration's ``arch`` module's (``arch/<arch>.py``).

Nothing here reads the program. The peaks are NVIDIA's H100 SXM data sheet
(dense, 700 W); a share of a peak is only meaningful beside the card's
power limit, which every run prints.

``dims`` below is the ``model`` section of a configuration file
(``configs/<name>.json``): ``vision`` and ``decoder`` dicts of the
published sizes.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Tuple

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


def int8_decoder_bytes(dims: dict, linears: List[Tuple[int, int]]) -> float:
    """Bytes one decode or verify iteration reads of an int8 decoder: every
    block linear (``linears``: (in, out) of one layer's, from the
    configuration's ``arch``) and the tied lm_head once, with their float32
    scales."""
    c = dims["decoder"]
    per_layer = sum(k * n + 4 * n for k, n in linears)
    head = c["vocab_size"] * (c["hidden_size"] + 4)
    return float(c["num_layers"] * per_layer + head)


def w8a16_prefill_bound(rows: int, dims: dict,
                        linears: List[Tuple[int, int]]) -> Tuple[float, float]:
    """The W8A16 linears of one decoder forward over ``rows`` tokens
    (``linears``: (in, out) of one layer's): operations, and each int8
    weight with its scales read once, the activations in and out once."""
    layers = dims["decoder"]["num_layers"]
    ops = 2.0 * rows * (layers * sum(k * n for k, n in linears))
    nbytes = layers * sum(k * n + 4 * n + 2 * rows * (k + n) for k, n in linears)
    return ops, float(nbytes)


def w8a16_decode_bound(rows: float, dims: dict,
                       linears: List[Tuple[int, int]]) -> Tuple[float, float]:
    """One decode or verify iteration of ``rows`` query rows: the block
    linears (``linears``: (in, out) of one layer's) and the tied lm_head."""
    c = dims["decoder"]
    params = c["num_layers"] * sum(k * n for k, n in linears)
    ops = 2.0 * rows * (params + c["vocab_size"] * c["hidden_size"])
    return ops, int8_decoder_bytes(dims, linears)


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
