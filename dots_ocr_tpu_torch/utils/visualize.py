"""Layout visualization: draw translucent category boxes + order labels.

Functional equivalent of the reference renderer
(``dots_ocr/utils/layout_utils.py:14-112``), which round-trips through a
throwaway PyMuPDF page. Here we composite directly with PIL (no native PDF
dependency): same color map, 0.3 fill opacity, thin outline, and a
``{order}_{category}`` label at the box's top-right corner.
"""

from __future__ import annotations

from typing import List, Optional

from PIL import Image, ImageDraw

# Category -> RGBA color (reference layout_utils.py:14-28).
LAYOUT_TYPE_COLORS = {
    "Text": (0, 128, 0, 255),
    "Picture": (255, 0, 255, 255),
    "Caption": (255, 165, 0, 255),
    "Section-header": (0, 255, 255, 255),
    "Footnote": (0, 128, 0, 255),
    "Formula": (128, 128, 128, 255),
    "Table": (255, 192, 203, 255),
    "Title": (255, 0, 0, 255),
    "List-item": (0, 0, 255, 255),
    "Page-header": (0, 128, 0, 255),
    "Page-footer": (128, 0, 128, 255),
    "Other": (165, 42, 42, 255),
    "Unknown": (0, 0, 0, 0),
}

_FILL_OPACITY = 0.3
_DEFAULT_COLOR = (0, 128, 0, 255)


def draw_layout_on_image(
    image: Image.Image,
    cells: List[dict],
    resized_height: Optional[int] = None,
    resized_width: Optional[int] = None,
    fill_bbox: bool = True,
    draw_bbox: bool = True,
) -> Image.Image:
    """Return a copy of ``image`` with translucent layout boxes drawn on it.

    If ``resized_height``/``resized_width`` are given, bboxes are assumed to
    be in that resized coordinate space and are mapped back to the image's
    own space first (layout_utils.py:73-77).
    """
    base = image.convert("RGB")
    original_width, original_height = base.size
    overlay = Image.new("RGBA", base.size, (0, 0, 0, 0))
    draw = ImageDraw.Draw(overlay)

    for order, cell in enumerate(cells):
        bbox = cell["bbox"]
        layout_type = cell.get("category", "Unknown")

        x0, y0, x1, y1 = bbox[0], bbox[1], bbox[2], bbox[3]
        if resized_height and resized_width:
            scale_x = resized_width / original_width
            scale_y = resized_height / original_height
            x0, y0 = int(bbox[0] / scale_x), int(bbox[1] / scale_y)
            x1, y1 = int(bbox[2] / scale_x), int(bbox[3] / scale_y)

        color = LAYOUT_TYPE_COLORS.get(layout_type, _DEFAULT_COLOR)
        rgb = color[:3]
        # Degenerate/inverted boxes: clamp so PIL does not raise.
        x0, x1 = sorted((x0, x1))
        y0, y1 = sorted((y0, y1))

        if draw_bbox:
            if fill_bbox:
                fill = rgb + (int(255 * _FILL_OPACITY),)
                draw.rectangle([x0, y0, x1, y1], fill=fill, outline=rgb + (255,), width=1)
            else:
                draw.rectangle([x0, y0, x1, y1], outline=rgb + (255,), width=1)

        label = f"{order}_{layout_type}"
        # Label sits just right of the box's top-right corner, like the
        # reference's insert_text((x1, y0 + 20), ...).
        draw.text((x1, y0 + 8), label, fill=rgb + (255,))

    return Image.alpha_composite(base.convert("RGBA"), overlay).convert("RGB")
