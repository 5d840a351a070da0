"""Image loading, color conversion, base64, and resize-to-model-grid.

Behavior-parity layer over PIL matching the reference loaders
(``dots_ocr/utils/image_utils.py:67-140``): accepts PIL images, local paths,
``file://`` URIs, http(s) URLs, and ``data:image/...;base64,`` URLs; RGBA is
composited onto white; and the optional resize snaps to the smart_resize grid.
"""

from __future__ import annotations

import base64
import copy
from io import BytesIO
from typing import Optional, Tuple, Union

from PIL import Image

from dots_ocr_tpu_torch.utils.consts import IMAGE_FACTOR, MAX_PIXELS, MIN_PIXELS
from dots_ocr_tpu_torch.utils.resize import smart_resize

ImageInput = Union[Image.Image, str]


def pil_to_base64(image: Image.Image, format: str = "PNG") -> str:
    """Encode a PIL image as a ``data:image/...;base64,`` URL."""
    buffered = BytesIO()
    image.save(buffered, format=format)
    b64 = base64.b64encode(buffered.getvalue()).decode("utf-8")
    return f"data:image/{format.lower()};base64,{b64}"


# Reference-compatible alias (dots_ocr/utils/image_utils.py:67).
PILimage_to_base64 = pil_to_base64


def base64_to_pil(data_url: str) -> Image.Image:
    """Decode a base64 data URL (or bare base64 payload) into a PIL image."""
    if "base64," in data_url:
        _, payload = data_url.split("base64,", 1)
    else:
        payload = data_url
    data = base64.b64decode(payload)
    with BytesIO(data) as bio:
        return copy.deepcopy(Image.open(bio))


def to_rgb(pil_image: Image.Image) -> Image.Image:
    """Convert to RGB; RGBA is composited onto a white background using the
    alpha channel as mask (reference dots_ocr/utils/image_utils.py:74-80)."""
    if pil_image.mode == "RGBA":
        white = Image.new("RGB", pil_image.size, (255, 255, 255))
        white.paste(pil_image, mask=pil_image.split()[3])
        return white
    return pil_image.convert("RGB")


def _load_image(image: ImageInput) -> Image.Image:
    if isinstance(image, Image.Image):
        return image
    if not isinstance(image, str):
        raise ValueError(
            "Unrecognized image input, support local path, http url, base64 "
            f"and PIL.Image, got {type(image)}"
        )
    if image.startswith("http://") or image.startswith("https://"):
        import requests

        with requests.get(image, stream=True) as response:
            response.raise_for_status()
            with BytesIO(response.content) as bio:
                return copy.deepcopy(Image.open(bio))
    if image.startswith("file://"):
        return Image.open(image[7:])
    if image.startswith("data:image"):
        return base64_to_pil(image)
    return Image.open(image)


def fetch_image(
    image: ImageInput,
    min_pixels: Optional[int] = None,
    max_pixels: Optional[int] = None,
    resized_height: Optional[int] = None,
    resized_width: Optional[int] = None,
) -> Image.Image:
    """Load an image from any supported source and optionally smart-resize it.

    Matches the reference semantics (dots_ocr/utils/image_utils.py:84-140):
    with no bounds given the image is only color-converted; with either bound
    given it is resized onto the factor-28 grid. Explicit target dimensions
    are themselves snapped through smart_resize first.
    """
    assert image is not None, f"image not found, maybe input format error: {image}"
    img = to_rgb(_load_image(image))

    if resized_height and resized_width:
        resized_height, resized_width = smart_resize(
            resized_height, resized_width, factor=IMAGE_FACTOR
        )
        img = img.resize((resized_width, resized_height))
    elif min_pixels or max_pixels:
        width, height = img.size
        min_pixels = min_pixels or MIN_PIXELS
        max_pixels = max_pixels or MAX_PIXELS
        resized_height, resized_width = smart_resize(
            height,
            width,
            factor=IMAGE_FACTOR,
            min_pixels=min_pixels,
            max_pixels=max_pixels,
        )
        img = img.resize((resized_width, resized_height))
    return img


def get_input_dimensions(
    image: Image.Image,
    min_pixels: int,
    max_pixels: int,
    factor: int = IMAGE_FACTOR,
) -> Tuple[int, int]:
    """Resized (width, height) the model will see for this image."""
    input_height, input_width = smart_resize(
        image.height,
        image.width,
        factor=factor,
        min_pixels=min_pixels,
        max_pixels=max_pixels,
    )
    return input_width, input_height
