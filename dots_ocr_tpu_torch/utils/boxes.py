"""Bounding-box coordinate round-trip between original-image and model-input space.

The model emits bboxes in smart-resized (model input) coordinates; the client
maps them back to the original image with per-axis scales and int truncation
(reference ``dots_ocr/utils/layout_utils.py:115-228``). Truncation (not
rounding) is parity-critical: OmniDocBench comparisons drift otherwise.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple, Union

from PIL import Image

from dots_ocr_tpu_torch.utils.consts import MAX_PIXELS, MIN_PIXELS
from dots_ocr_tpu_torch.utils.repair import OutputCleaner
from dots_ocr_tpu_torch.utils.resize import smart_resize

Cell = Dict[str, object]


def pre_process_bboxes(
    origin_image: Image.Image,
    bboxes: List[List[float]],
    input_width: int,
    input_height: int,
    factor: int = 28,
    min_pixels: Optional[int] = MIN_PIXELS,
    max_pixels: Optional[int] = MAX_PIXELS,
) -> List[List[int]]:
    """Map user bboxes (original-image coords) into model-input coords.

    Used by the grounding-OCR prompt: the bbox appended to the prompt must be
    in the coordinate system the model sees (layout_utils.py:115-144).
    """
    assert isinstance(bboxes, list) and len(bboxes) > 0 and isinstance(bboxes[0], list)
    min_pixels = min_pixels or MIN_PIXELS
    max_pixels = max_pixels or MAX_PIXELS
    original_width, original_height = origin_image.size

    input_height, input_width = smart_resize(
        input_height, input_width, min_pixels=min_pixels, max_pixels=max_pixels
    )
    scale_x = original_width / input_width
    scale_y = original_height / input_height

    return [
        [
            int(float(bbox[0]) / scale_x),
            int(float(bbox[1]) / scale_y),
            int(float(bbox[2]) / scale_x),
            int(float(bbox[3]) / scale_y),
        ]
        for bbox in bboxes
    ]


def post_process_cells(
    origin_image: Image.Image,
    cells: List[Cell],
    input_width: int,
    input_height: int,
    factor: int = 28,
    min_pixels: Optional[int] = MIN_PIXELS,
    max_pixels: Optional[int] = MAX_PIXELS,
) -> List[Cell]:
    """Map model-output cell bboxes back to original-image coords.

    Inverse of :func:`pre_process_bboxes` up to int truncation
    (layout_utils.py:146-193).
    """
    assert isinstance(cells, list) and len(cells) > 0 and isinstance(cells[0], dict)
    min_pixels = min_pixels or MIN_PIXELS
    max_pixels = max_pixels or MAX_PIXELS
    original_width, original_height = origin_image.size

    input_height, input_width = smart_resize(
        input_height, input_width, min_pixels=min_pixels, max_pixels=max_pixels
    )
    scale_x = input_width / original_width
    scale_y = input_height / original_height

    cells_out = []
    for cell in cells:
        bbox = cell["bbox"]
        cell_copy = dict(cell)
        cell_copy["bbox"] = [
            int(float(bbox[0]) / scale_x),
            int(float(bbox[1]) / scale_y),
            int(float(bbox[2]) / scale_x),
            int(float(bbox[3]) / scale_y),
        ]
        cells_out.append(cell_copy)
    return cells_out


def is_legal_bbox(cells: List[Cell]) -> bool:
    """All bboxes must have positive width and height (layout_utils.py:195-200)."""
    for cell in cells:
        bbox = cell["bbox"]
        if bbox[2] <= bbox[0] or bbox[3] <= bbox[1]:
            return False
    return True


# Prompt modes whose responses are plain text (returned unchanged).
_TEXT_ONLY_MODES = {
    "prompt_ocr",
    "prompt_table_html",
    "prompt_table_latex",
    "prompt_formula_latex",
}


def post_process_output(
    response: str,
    prompt_mode: str,
    origin_image: Image.Image,
    input_image: Image.Image,
    min_pixels: Optional[int] = None,
    max_pixels: Optional[int] = None,
) -> Union[str, Tuple[Union[List[Cell], str], bool]]:
    """JSON-parse + rescale the model response, or salvage it on failure.

    Returns the raw string for text-only modes. Otherwise returns
    ``(cells, filtered)``: ``filtered=False`` with rescaled layout cells on
    success; ``filtered=True`` with salvaged plain text when the output was
    not valid JSON (layout_utils.py:202-228).
    """
    if prompt_mode in _TEXT_ONLY_MODES:
        return response

    cells = response
    try:
        cells = json.loads(cells)
        cells = post_process_cells(
            origin_image,
            cells,
            input_image.width,
            input_image.height,
            min_pixels=min_pixels,
            max_pixels=max_pixels,
        )
        return cells, False
    except Exception as e:  # noqa: BLE001 - any parse/rescale failure → salvage
        print(f"cells post process error: {e}, when using {prompt_mode}")

    cleaner = OutputCleaner()
    response_clean = cleaner.clean_model_output(cells)
    if isinstance(response_clean, list):
        response_clean = "\n\n".join(
            [cell["text"] for cell in response_clean if "text" in cell]
        )
    return response_clean, True
