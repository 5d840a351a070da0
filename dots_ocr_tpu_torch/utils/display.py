"""Demo display helpers (reference ``dots_ocr/utils/demo_utils/display.py``)."""

from __future__ import annotations

import os
from typing import Optional, Tuple

from PIL import Image

from dots_ocr_tpu_torch.utils.consts import image_extensions


def is_valid_image_path(path: str) -> bool:
    """Path exists, is a file, and carries a supported image extension."""
    if not isinstance(path, str) or not path:
        return False
    if not os.path.isfile(path):
        return False
    return os.path.splitext(path)[1].lower() in image_extensions


def read_image(
    source, max_size: int = 1024
) -> Tuple[Optional[Image.Image], Optional[str]]:
    """Load an image for display, aspect-preserving bound to ``max_size``.

    Returns (image, error): exactly one is None.
    """
    try:
        img = source if isinstance(source, Image.Image) else Image.open(source)
        img = img.convert("RGB")
        if max(img.size) > max_size:
            scale = max_size / max(img.size)
            img = img.resize(
                (max(1, round(img.width * scale)), max(1, round(img.height * scale)))
            )
        return img, None
    except Exception as e:  # noqa: BLE001
        return None, f"failed to read image: {e}"
