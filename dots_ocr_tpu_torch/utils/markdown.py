"""Layout-JSON -> Markdown emission (benchmark-facing output format).

Behavioral parity with the reference emitter
(``dots_ocr/utils/format_transformer.py:10-206``): Picture cells become
inline base64 PNG crops of the original image, Formula cells are normalized
into ``$$`` blocks, everything else is lightly cleaned Markdown text; cells
join with blank lines. ``no_page_hf=True`` skips Page-header/Page-footer —
that variant (``*_nohf.md``) is what OmniDocBench / olmOCR-bench score.
"""

from __future__ import annotations

import re
from typing import List

from PIL import Image

from dots_ocr_tpu_torch.utils.image_io import pil_to_base64

_LATEX_PATTERNS = [
    r"\$\$.*?\$\$",                     # block math $$...$$
    r"\$[^$\n]+?\$",                    # inline math $...$
    r"\\begin\{.*?\}.*?\\end\{.*?\}",   # \begin{...}...\end{...}
    r"\\[a-zA-Z]+\{.*?\}",              # \command{...}
    r"\\[a-zA-Z]+",                     # \command
    r"\\\[.*?\\\]",                     # display math \[...\]
    r"\\\(.*?\\\)",                     # inline math \(...\)
]

_PREAMBLE_PATTERNS = [
    r"\\documentclass\{[^}]+\}",
    r"\\usepackage\{[^}]+\}",
    r"\\usepackage\[[^\]]*\]\{[^}]+\}",
    r"\\begin\{document\}",
    r"\\end\{document\}",
]


def has_latex_markdown(text: str) -> bool:
    """True if the string contains any LaTeX-looking construct."""
    if not isinstance(text, str):
        return False
    return any(re.search(p, text, re.DOTALL) for p in _LATEX_PATTERNS)


def clean_latex_preamble(latex_text: str) -> str:
    """Strip document-class / package preamble the model sometimes emits."""
    cleaned = latex_text
    for pattern in _PREAMBLE_PATTERNS:
        cleaned = re.sub(pattern, "", cleaned, flags=re.IGNORECASE)
    return cleaned


def get_formula_in_markdown(text: str) -> str:
    """Normalize a formula cell into a renderable Markdown math block.

    Rules (format_transformer.py:69-119, order matters):
      * already ``$$...$$``: re-wrap with newlines unless inner text still
        contains ``$``,
      * ``\\[...\\]`` delimiters: convert to a ``$$`` block,
      * embedded ``\\[...\\]`` or any inline ``$...$``: return unchanged,
      * no LaTeX at all: return unchanged,
      * otherwise: strip preamble/backticks and wrap in a ``$$`` block.
    """
    text = text.strip()

    if text.startswith("$$") and text.endswith("$$"):
        inner = text[2:-2].strip()
        if "$" not in inner:
            return f"$$\n{inner}\n$$"
        return text

    if text.startswith("\\[") and text.endswith("\\]"):
        inner = text[2:-2].strip()
        return f"$$\n{inner}\n$$"

    if re.findall(r".*\\\[.*\\\].*", text):
        return text

    if re.findall(r"\$([^$]+)\$", text):
        return text

    if not has_latex_markdown(text):
        return text

    if "usepackage" in text:
        text = clean_latex_preamble(text)

    if text and text[0] == "`" and text[-1] == "`":
        text = text[1:-1]

    return f"$$\n{text}\n$$"


def clean_text(text: str) -> str:
    """Trim whitespace and unwrap `` `$...$` `` backtick-wrapped math."""
    if not text:
        return ""
    text = text.strip()
    if text[:2] == "`$" and text[-2:] == "$`":
        text = text[1:-1]
    return text


def layoutjson2md(
    image: Image.Image,
    cells: List[dict],
    text_key: str = "text",
    no_page_hf: bool = False,
) -> str:
    """Render layout cells to Markdown (format_transformer.py:145-180).

    Picture cells are cropped from ``image`` at the cell bbox (original-image
    coordinates after post_process_cells) and inlined as base64 PNG.
    """
    text_items = []
    for cell in cells:
        x1, y1, x2, y2 = (int(coord) for coord in cell["bbox"])
        text = cell.get(text_key, "")

        if no_page_hf and cell["category"] in ("Page-header", "Page-footer"):
            continue

        if cell["category"] == "Picture":
            crop = image.crop((x1, y1, x2, y2))
            text_items.append(f"![]({pil_to_base64(crop)})")
        elif cell["category"] == "Formula":
            text_items.append(get_formula_in_markdown(text))
        else:
            text_items.append(f"{clean_text(text)}")

    return "\n\n".join(text_items)


def fix_streamlit_formulas(md: str) -> str:
    """Ensure every ``$$...$$`` block has inner newlines (Streamlit quirk)."""

    def _wrap(match: re.Match) -> str:
        content = match.group(1)
        if content.startswith("\n"):
            content = content[1:]
        if content.endswith("\n"):
            content = content[:-1]
        return f"$$\n{content}\n$$"

    return re.sub(r"\$\$(.*?)\$\$", _wrap, md, flags=re.DOTALL)
