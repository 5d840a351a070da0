"""smart_resize: the deterministic resolution policy.

Behavioral parity with the reference (``dots_ocr/utils/image_utils.py:14-63``):
every image is snapped onto a grid of multiples of ``factor`` (28) with total
pixels inside ``[min_pixels, max_pixels]``, preserving aspect ratio as closely
as possible. ``max_pixels`` has priority over ``min_pixels`` so that the
vision-token budget is always respected. Aspect ratios above 200 are rejected.

These few lines gate byte-parity of every bbox in the system: both the client
and the server re-run this function, and bbox rescaling divides by the ratio
between the original and the smart-resized dimensions.
"""

from __future__ import annotations

import math

from dots_ocr_tpu_torch.utils.consts import IMAGE_FACTOR, MAX_PIXELS, MIN_PIXELS

MAX_ASPECT_RATIO = 200


def round_by_factor(number: float, factor: int) -> int:
    """Closest multiple of ``factor`` (banker's rounding, as in CPython round)."""
    return round(number / factor) * factor


def ceil_by_factor(number: float, factor: int) -> int:
    """Smallest multiple of ``factor`` >= ``number``."""
    return math.ceil(number / factor) * factor


def floor_by_factor(number: float, factor: int) -> int:
    """Largest multiple of ``factor`` <= ``number``."""
    return math.floor(number / factor) * factor


def smart_resize(
    height: int,
    width: int,
    factor: int = IMAGE_FACTOR,
    min_pixels: int = MIN_PIXELS,
    max_pixels: int = MAX_PIXELS,
) -> tuple[int, int]:
    """Return ``(h_bar, w_bar)``: the model-input dimensions for an image.

    Invariants (all verified by tests):
      * ``h_bar % factor == 0 and w_bar % factor == 0``
      * ``h_bar * w_bar <= max_pixels`` always (max_pixels wins over min_pixels)
      * ``h_bar * w_bar >= min_pixels`` unless that would violate max_pixels
      * idempotent: re-running on its own output is the identity
    """
    if max(height, width) / min(height, width) > MAX_ASPECT_RATIO:
        raise ValueError(
            "absolute aspect ratio must be smaller than "
            f"{MAX_ASPECT_RATIO}, got {max(height, width) / min(height, width)}"
        )
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
            # max_pixels takes priority: it bounds the vision-token length.
            beta = math.sqrt((h_bar * w_bar) / max_pixels)
            h_bar = max(factor, floor_by_factor(h_bar / beta, factor))
            w_bar = max(factor, floor_by_factor(w_bar / beta, factor))
    return h_bar, w_bar


def num_patches(height: int, width: int, patch_size: int = 14) -> int:
    """Number of raw (pre-merge) vision patches for a smart-resized image."""
    return (height // patch_size) * (width // patch_size)


def num_vision_tokens(
    height: int, width: int, patch_size: int = 14, merge_size: int = 2
) -> int:
    """Number of post-merge vision tokens the decoder sees for an image."""
    grid = patch_size * merge_size
    return (height // grid) * (width // grid)
