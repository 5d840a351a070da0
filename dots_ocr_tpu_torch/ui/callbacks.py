"""Gradio-free UI callback logic for the demo apps.

Every interactive callback in the demo UIs (single-document app, box
annotation app, batch console) is a pure function here — the demo files are
wiring only. That makes the callbacks headless-testable (the reference's
UIs, at 940-2786 LoC of inline logic, had no tests at all) and keeps gradio
an optional dependency: ``ui_update(...)`` returns the plain
``{"__type__": "update", ...}`` dict gradio accepts in place of
``gr.update(...)``.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, List, Optional, Tuple

from dots_ocr_tpu_torch.parser import DotsOCRParser
from dots_ocr_tpu_torch.utils.prompts import (
    PROMPT_FITZ_PREPROCESS,
    PROMPT_TEMPERATURE,
)


def ui_update(**kwargs) -> Dict[str, Any]:
    """gr.update(...) without importing gradio."""
    return {"__type__": "update", **kwargs}


# ---------------------------------------------------------------------------
# Server registry + parser cache (reference demo_gradio.py:42-53, 145-174)
# ---------------------------------------------------------------------------

DEFAULT_SERVER = {"ip": "localhost", "port": 8000}

# Per-prompt model routing: the SVG task runs a dedicated fine-tune
# (dots.mocr-svg class), often on a separate server (reference
# demo_gradio.py:80-82).
MODEL_SERVERS = {
    "default": {"ip": "localhost", "port": 8000, "model_name": "model"},
    "svg": {"ip": "localhost", "port": 8001, "model_name": "model-svg"},
}
PROMPT_TO_MODEL = {"prompt_image_to_svg": "svg"}

_parser_cache: Dict[tuple, DotsOCRParser] = {}


def server_for_prompt(prompt_mode: str) -> dict:
    key = PROMPT_TO_MODEL.get(prompt_mode, "default")
    return MODEL_SERVERS.get(key, MODEL_SERVERS["default"])


def get_parser(ip: str, port, min_pixels=None, max_pixels=None) -> DotsOCRParser:
    key = (ip, int(port), min_pixels, max_pixels)
    if key not in _parser_cache:
        _parser_cache[key] = DotsOCRParser(
            ip=ip,
            port=int(port),
            min_pixels=int(min_pixels) if min_pixels else None,
            max_pixels=int(max_pixels) if max_pixels else None,
        )
    return _parser_cache[key]


# ---------------------------------------------------------------------------
# Single-document app callbacks
# ---------------------------------------------------------------------------

EMPTY_PAGE = {"image": None, "md": "", "json": ""}


def parse_document(
    file_path: Optional[str],
    prompt_mode: str,
    custom_prompt: str,
    ip: str,
    port,
    min_pixels=None,
    max_pixels=None,
    parser: Optional[DotsOCRParser] = None,
) -> Tuple:
    """Parse a file; returns EXACTLY the 6 outputs the app declares:
    (layout_image, markdown, json_text, zip_path, page_slider_update,
    pages_state)."""
    if not file_path:
        # Must match the success arity — returning fewer values than
        # declared outputs crashes gradio (reference-skew bug fixed here).
        return None, "upload a file first", "", None, ui_update(), []
    parser = parser or get_parser(ip, port, min_pixels, max_pixels)
    temperature = PROMPT_TEMPERATURE.get(prompt_mode, 0.1)
    fitz = PROMPT_FITZ_PREPROCESS.get(prompt_mode, False)
    out_dir = tempfile.mkdtemp(prefix="dots_gradio_")
    results = parser.parse_file(
        file_path,
        output_dir=out_dir,
        prompt_mode=prompt_mode,
        fitz_preprocess=fitz,
        custom_prompt=custom_prompt or None,
        temperature=temperature,
    )
    pages = []
    for rec in results:
        md = ""
        if rec.get("md_content_path") and os.path.exists(rec["md_content_path"]):
            md = open(rec["md_content_path"], encoding="utf-8").read()
        cells = None
        if rec.get("layout_info_path") and os.path.exists(rec["layout_info_path"]):
            cells = json.load(open(rec["layout_info_path"], encoding="utf-8"))
        pages.append(
            {
                "image": rec.get("layout_image_path"),
                "md": md,
                "json": json.dumps(cells, ensure_ascii=False, indent=2)
                if cells
                else "",
            }
        )

    zip_path = os.path.join(out_dir, "artifacts.zip")
    with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for rec in results:
            for key in (
                "layout_info_path",
                "layout_image_path",
                "md_content_path",
                "md_content_nohf_path",
            ):
                p = rec.get(key)
                if p and os.path.exists(p):
                    zf.write(p, os.path.basename(p))

    first = pages[0] if pages else dict(EMPTY_PAGE)
    slider = ui_update(
        minimum=1, maximum=max(1, len(pages)), value=1, visible=len(pages) > 1
    )
    return first["image"], first["md"], first["json"], zip_path, slider, pages


def show_page(page_no, pages: List[dict]) -> Tuple:
    if not pages:
        return None, "", ""
    idx = min(max(int(page_no) - 1, 0), len(pages) - 1)
    page = pages[idx]
    return page["image"], page["md"], page["json"]


def pdf_preview(file_path: Optional[str]):
    if not file_path or not file_path.lower().endswith(".pdf"):
        return None
    from dots_ocr_tpu_torch.ingest.pdf import load_images_from_pdf

    images = load_images_from_pdf(file_path, dpi=72)
    return images[0] if images else None


# ---------------------------------------------------------------------------
# Annotation (draw-a-box grounded OCR) app callback
# ---------------------------------------------------------------------------


def annotation_to_bbox(annotation: Optional[dict]) -> Optional[List[int]]:
    """gradio_image_annotation payload -> [xmin, ymin, xmax, ymax] ints."""
    if not annotation:
        return None
    boxes = annotation.get("boxes") or []
    if not boxes:
        return None
    b = boxes[0]
    try:
        return [int(b["xmin"]), int(b["ymin"]), int(b["xmax"]), int(b["ymax"])]
    except (KeyError, TypeError, ValueError):
        return None


def parse_with_bbox(
    image_path: Optional[str],
    annotation: Optional[dict],
    ip: str,
    port,
    parser: Optional[DotsOCRParser] = None,
) -> Tuple[str, str]:
    """Grounded-OCR flow: a drawn box forces prompt_grounding_ocr
    (reference demo_gradio_annotion.py:246-251). Returns (text, status)."""
    if not image_path:
        return "", "upload an image first"
    bbox = annotation_to_bbox(annotation)
    if bbox is None:
        return "", "draw a box first"
    parser = parser or get_parser(ip, port)
    out_dir = tempfile.mkdtemp(prefix="dots_annot_")
    results = parser.parse_file(
        image_path,
        output_dir=out_dir,
        prompt_mode="prompt_grounding_ocr",
        bbox=bbox,
    )
    rec = results[0]
    md = ""
    if rec.get("md_content_path") and os.path.exists(rec["md_content_path"]):
        md = open(rec["md_content_path"], encoding="utf-8").read()
    return md, f"bbox={bbox}"


def validate_annotation(annotation: Optional[dict]) -> Tuple[Optional[List[int]], str]:
    """Reference semantics (demo_gradio_annotion.py:167-197): at most ONE
    box; zero boxes means a full-page parse. Returns (bbox | None, error)."""
    boxes = (annotation or {}).get("boxes") or []
    if len(boxes) > 1:
        return None, f"draw exactly one box ({len(boxes)} drawn)"
    bbox = annotation_to_bbox(annotation)
    if boxes and bbox is None:
        return None, "malformed box payload"
    if bbox is not None and (bbox[2] <= bbox[0] or bbox[3] <= bbox[1]):
        return None, f"invalid box {bbox}: xmax/ymax must exceed xmin/ymin"
    return bbox, ""


def parse_annotation_flow(
    image_path: Optional[str],
    annotation: Optional[dict],
    prompt_mode: str,
    ip: str,
    port,
    min_pixels=None,
    max_pixels=None,
    parser: Optional[DotsOCRParser] = None,
) -> Tuple:
    """The annotation app's single entry point, mirroring the reference's
    process_image_inference_with_annotation (:199-356): a drawn box forces
    prompt_grounding_ocr on that region; no box runs the selected prompt on
    the full page. Returns (layout_image_path|None, markdown, raw, status).
    """
    if not image_path:
        return None, "", "", "upload an image first"
    bbox, err = validate_annotation(annotation)
    if err:
        return None, "", "", err
    parser = parser or get_parser(ip, port, min_pixels, max_pixels)
    if bbox is not None:
        md, status = parse_with_bbox(
            image_path, annotation, ip, port, parser=parser
        )
        return None, md, md, f"grounded OCR, {status}"
    image, md, js, _zip, _slider, _pages = parse_document(
        image_path, prompt_mode, "", ip, port,
        min_pixels=min_pixels, max_pixels=max_pixels, parser=parser,
    )
    return image, md, js, f"full-page parse ({prompt_mode})"


# ---------------------------------------------------------------------------
# Batch console callbacks (over batch.jobs.BatchJobManager)
# ---------------------------------------------------------------------------


def result_rows(manager) -> List[List[str]]:
    """Results table for the console: [rid, file, status, attempts, error]."""
    rows = []
    for r in manager.results():
        rows.append(
            [
                r.rid,
                os.path.basename(r.input_path),
                r.status,
                str(r.retry_attempts),
                (r.error or "")[:120],
            ]
        )
    return rows


def progress_text(manager) -> str:
    p = manager.progress()
    return (
        f"done {p.get('done', 0)} | error {p.get('error', 0)} | "
        f"running {p.get('running', 0)} | queued {p.get('pending', 0)}"
    )


def load_result_content(manager, rid: str, page_no: int = 0) -> Tuple[str, str, str]:
    """(markdown, json_text, status) for the editor panes — edited version
    preferred when one exists (reference demo_gradio_batch.py:857-927)."""
    if not rid:
        return "", "", "pick a result"
    md, md_edited = manager.get_content(rid, page_no, "md")
    js, js_edited = manager.get_content(rid, page_no, "json")
    status = "edited" if (md_edited or js_edited) else "original"
    return md or "", js or "", status


def save_result_edits(
    manager, rid: str, page_no: int, md_text: str, json_text: str
) -> str:
    """Autosave handler: persist both panes to the edited/ dir."""
    if not rid:
        return "pick a result"
    saved = []
    if md_text is not None:
        manager.save_edit(rid, page_no, "md", md_text)
        saved.append("md")
    if json_text is not None:
        try:
            json.loads(json_text)
            manager.save_edit(rid, page_no, "json", json_text)
            saved.append("json")
        except (json.JSONDecodeError, ValueError):
            return "json not saved: invalid JSON (markdown saved)" if saved \
                else "invalid JSON"
    return f"saved: {', '.join(saved)}"


# ---------------------------------------------------------------------------
# Streamlit app callbacks (reference demo_streamlit.py:112-170)
# ---------------------------------------------------------------------------


def process_layout_response(
    origin_image,
    response: Optional[str],
    prompt_mode: str,
    model_width: int,
    model_height: int,
) -> Dict[str, Any]:
    """Turn a raw server response into render-ready parts.

    Returns a dict with ``kind`` one of:
      * ``error``   — request failed (response None),
      * ``layout``  — parsed cells: ``cells``, ``image`` (layout drawn on the
        original), ``markdown`` (None for layout-only mode), ``raw``,
      * ``invalid`` — layout prompt but unparseable JSON: ``raw`` to show,
      * ``text``    — non-layout prompt: ``markdown`` of the raw response.

    Pure: no streamlit/gradio imports (headless-testable); the reference
    kept this inline in the page script with zero coverage.
    """
    from dots_ocr_tpu_torch.utils.boxes import post_process_cells
    from dots_ocr_tpu_torch.utils.markdown import fix_streamlit_formulas, layoutjson2md

    if response is None:
        return {"kind": "error", "message": "request failed — is the server running?"}
    if prompt_mode not in ("prompt_layout_all_en", "prompt_layout_only_en"):
        return {"kind": "text", "markdown": fix_streamlit_formulas(response)}
    try:
        cells = json.loads(response)
        cells = post_process_cells(
            origin_image, cells, model_width, model_height
        )
    except Exception as e:  # noqa: BLE001 — any malformed output shows raw
        return {"kind": "invalid", "raw": response, "message": str(e)}
    from dots_ocr_tpu_torch.utils.visualize import draw_layout_on_image

    md = None
    if prompt_mode == "prompt_layout_all_en":
        md = fix_streamlit_formulas(layoutjson2md(origin_image, cells))
    return {
        "kind": "layout",
        "cells": cells,
        "image": draw_layout_on_image(origin_image, cells),
        "markdown": md,
        "raw": response,
    }


def resolve_image_input(
    uploaded=None, url_or_path: str = "", test_image: str = ""
):
    """Pick the active image source (upload > URL/path > test image) and
    load it; returns (PIL image | None, source description | error)."""
    from dots_ocr_tpu_torch.utils.image_io import fetch_image

    if uploaded is not None:
        from PIL import Image

        return Image.open(uploaded).convert("RGB"), "upload"
    target = (url_or_path or "").strip() or (test_image or "").strip()
    if not target:
        return None, "no image selected"
    try:
        return fetch_image(target), target
    except Exception as e:  # noqa: BLE001
        return None, f"failed to read image: {e}"
