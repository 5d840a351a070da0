"""PDF/page ingestion policy: rasterize pages at a target DPI.

Reproduces the reference ingestion contract (``dots_ocr/utils/doc_utils.py:20-59``
and ``dots_ocr/utils/image_utils.py:170-196``):

  * pages render at ``dpi/72`` scale (default 200 dpi),
  * if either rendered side exceeds 4500 px, fall back to 72 dpi,
  * plain images can be "dpi-upsampled" the same way (the reference routes
    them through an image->PDF->raster round trip; here that collapses to a
    direct scale by ``target_dpi/72`` with the same 4500 px fallback).

Rasterization backends are pluggable: PyMuPDF or pypdfium2 are used when
installed (production hosts); otherwise the built-in pure-Python
:mod:`dots_ocr_tpu_torch.ingest.minipdf` backend renders the page.
"""

from __future__ import annotations

import os
from io import BytesIO
from typing import List, Optional

from PIL import Image

MAX_RENDER_SIDE = 4500  # reference doc_utils.py:34-36
DEFAULT_DPI = 200


# ---------------------------------------------------------------------------
# Backends
# ---------------------------------------------------------------------------


class _FitzBackend:
    name = "pymupdf"

    def __init__(self):
        import fitz  # type: ignore

        self._fitz = fitz

    def open(self, source):
        fitz = self._fitz
        if isinstance(source, (bytes, bytearray)):
            return fitz.open(stream=bytes(source), filetype="pdf")
        return fitz.open(source)

    def page_count(self, doc) -> int:
        return doc.page_count

    def render(self, doc, index: int, dpi: float) -> Image.Image:
        fitz = self._fitz
        mat = fitz.Matrix(dpi / 72, dpi / 72)
        pm = doc[index].get_pixmap(matrix=mat, alpha=False)
        return Image.frombytes("RGB", (pm.width, pm.height), pm.samples)


class _PdfiumBackend:
    name = "pypdfium2"

    def __init__(self):
        import pypdfium2  # type: ignore

        self._pdfium = pypdfium2

    def open(self, source):
        return self._pdfium.PdfDocument(source)

    def page_count(self, doc) -> int:
        return len(doc)

    def render(self, doc, index: int, dpi: float) -> Image.Image:
        page = doc[index]
        bitmap = page.render(scale=dpi / 72)
        return bitmap.to_pil().convert("RGB")


class _BuiltinBackend:
    name = "builtin"

    def open(self, source):
        from dots_ocr_tpu_torch.ingest import minipdf

        return minipdf.open_pdf(source)

    def page_count(self, doc) -> int:
        return doc.page_count

    def render(self, doc, index: int, dpi: float) -> Image.Image:
        from dots_ocr_tpu_torch.ingest import minipdf

        return minipdf.render_page(doc, index, dpi=dpi)


_BACKEND = None


def get_backend():
    """Select the best available rasterization backend (cached)."""
    global _BACKEND
    if _BACKEND is not None:
        return _BACKEND
    forced = os.environ.get("DOTS_OCR_PDF_BACKEND", "").lower()
    candidates = {
        "pymupdf": _FitzBackend,
        "pypdfium2": _PdfiumBackend,
        "builtin": _BuiltinBackend,
    }
    if forced:
        _BACKEND = candidates[forced]()
        return _BACKEND
    for cls in (_FitzBackend, _PdfiumBackend, _BuiltinBackend):
        try:
            _BACKEND = cls()
            if cls is _BuiltinBackend:
                import logging

                logging.getLogger(__name__).warning(
                    "PDF backend: builtin minipdf (pymupdf/pypdfium2 not "
                    "installed). Embedded TrueType AND CFF/OpenType text "
                    "rasterizes by glyph id at >=0.6 ink-IoU vs FreeType "
                    "(tests/test_ingest.py bounds; measured ~0.84/~0.88); "
                    "Type 1 (FontFile) text renders by glyph name through "
                    "/Encoding Differences; vector paths fill/stroke with "
                    "flattened Beziers under W/W* clip masks — "
                    "install pymupdf for eval-grade rasterization."
                )
            return _BACKEND
        except ImportError:
            continue
    raise RuntimeError("no PDF backend available")  # unreachable: builtin always works


# ---------------------------------------------------------------------------
# Rendering policy (reference parity)
# ---------------------------------------------------------------------------


def render_page_image(doc, page_index: int, target_dpi: int = DEFAULT_DPI, backend=None) -> Image.Image:
    """Render one page at ``target_dpi``; fall back to 72 dpi when either
    rendered side exceeds 4500 px (doc_utils.py:31-39)."""
    backend = backend or get_backend()
    img = backend.render(doc, page_index, dpi=target_dpi)
    if img.width > MAX_RENDER_SIDE or img.height > MAX_RENDER_SIDE:
        img = backend.render(doc, page_index, dpi=72)
    return img


def load_images_from_pdf(
    pdf_file,
    dpi: int = DEFAULT_DPI,
    start_page_id: int = 0,
    end_page_id: Optional[int] = None,
) -> List[Image.Image]:
    """Rasterize a page range of a PDF into PIL images (doc_utils.py:42-59)."""
    backend = get_backend()
    doc = backend.open(pdf_file)
    page_count = backend.page_count(doc)
    end_page_id = (
        end_page_id if end_page_id is not None and end_page_id >= 0 else page_count - 1
    )
    if end_page_id > page_count - 1:
        end_page_id = page_count - 1

    images = []
    for index in range(page_count):
        if start_page_id <= index <= end_page_id:
            images.append(render_page_image(doc, index, target_dpi=dpi, backend=backend))
    return images


def upsample_image_to_dpi(image, target_dpi: int = DEFAULT_DPI) -> Image.Image:
    """DPI-normalize a plain image ("fitz preprocess").

    The reference converts the image to a 1-px-per-point PDF and re-rasters
    at ``target_dpi`` (image_utils.py:170-196), which is exactly a scale by
    ``target_dpi/72`` with the 4500 px fallback to identity. We do the scale
    directly — no PDF round trip — with a bicubic filter.
    """
    if not isinstance(image, Image.Image):
        assert isinstance(image, str)
        _, ext = os.path.splitext(image)
        assert ext in {".jpg", ".jpeg", ".png"}
        if image.startswith("http://") or image.startswith("https://"):
            import requests

            with requests.get(image, stream=True) as response:
                response.raise_for_status()
                image = Image.open(BytesIO(response.content))
        else:
            image = Image.open(image)

    scale = target_dpi / 72.0
    new_w = round(image.width * scale)
    new_h = round(image.height * scale)
    if new_w > MAX_RENDER_SIDE or new_h > MAX_RENDER_SIDE:
        return image.convert("RGB")
    return image.convert("RGB").resize((new_w, new_h), Image.BICUBIC)


# Reference-compatible alias (image_utils.py:170).
get_image_by_fitz_doc = upsample_image_to_dpi
