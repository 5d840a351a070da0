"""Request preparation: images -> smart-resize -> packed patches; prompt ->
chat-templated token ids with expanded image spans (a numpy copy of
``dots_ocr_tpu.engine.request``, whose module imports jax)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

from PIL import Image

from dots_ocr_tpu_torch.engine.chat_template import build_prompt_ids
from dots_ocr_tpu_torch.engine.tokenizer import TokenizerLike
from dots_ocr_tpu_torch.utils.consts import MAX_PIXELS, MIN_PIXELS
from dots_ocr_tpu_torch.utils.image_io import fetch_image
from dots_ocr_tpu_torch.models import preprocess
from dots_ocr_tpu_torch.models.config import DotsOCRConfig


@dataclass
class PreparedRequest:
    prompt_ids: List[int]
    packed: Optional[preprocess.PackedVisionInput]  # None for text-only


def prepare_request(
    tokenizer: TokenizerLike,
    config: DotsOCRConfig,
    prompt: str,
    images: Sequence[Union[Image.Image, str]] = (),
    system_prompt: Optional[str] = None,
    min_pixels: Optional[int] = None,
    max_pixels: Optional[int] = None,
    vision_bucket_step: int = 512,
) -> PreparedRequest:
    cfg = config.vision
    grid = cfg.patch_size * cfg.spatial_merge_size
    resized = [
        fetch_image(img, min_pixels=min_pixels or MIN_PIXELS,
                    max_pixels=max_pixels or MAX_PIXELS)
        for img in images
    ]
    counts = [(im.width // grid) * (im.height // grid) for im in resized]
    packed = (
        preprocess.pack_images(resized, cfg, bucket_step=vision_bucket_step)
        if resized else None
    )
    ids = build_prompt_ids(tokenizer, prompt, counts, system_prompt=system_prompt)
    return PreparedRequest(prompt_ids=ids, packed=packed)
