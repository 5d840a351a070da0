"""OmniDocBench end2end protocol: element matching BEFORE scoring.

The reference's headline numbers (overall_EN 0.1237 / overall_CH 0.1620,
``reference/tools/eval_omnidocbench.md`` result block) come from the
official OmniDocBench ``end2end_eval`` pipeline with
``match_method: quick_match``: the predicted page MARKDOWN is segmented
into typed elements, those elements are PAIRED with ground-truth layout
elements by text similarity (with split/merge handling — models routinely
split one GT paragraph into two blocks or vice versa), and only then are
the per-category metrics computed over the matched pairs. Scoring raw
page text without that pairing (eval/metrics.score_pages — still available
for quick smoke evals) is NOT comparable to the published columns; this
module implements the pairing protocol.

Column set reproduced (exactly the published table):
  text_block_Edit_dist_{EN,CH}      display_formula_Edit_dist_{EN,CH}
  display_formula_CDM_{EN,CH}       table_TEDS_{EN,CH}
  table_Edit_dist_{EN,CH}           reading_order_Edit_dist_{EN,CH}
  overall_{EN,CH}                   (+ per-data_source / per-layout splits)

Fidelity notes / documented drift (no network: the OmniDocBench source is
not available in this environment, so the matching is re-derived from the
published protocol, not copied):
  * quick_match here = Hungarian assignment on normalized-edit-distance
    cost within each category family, followed by greedy ADJACENT-merge
    passes that re-attach unmatched fragments to their neighbour's match
    when doing so lowers the pair distance (the official quick_match's
    split/merge repair has the same role).
  * CDM (formula render-match metric) needs an external renderer the
    official log itself ran without ("display_formula CDM is not found",
    reported as "-"); we report "-" identically.
  * Unmatched GT elements score against the empty string (a total miss);
    unmatched pred elements likewise penalize as hallucinations, matching
    the official treatment of unpaired elements.
GT fixture shape follows the official OmniDocBench.json: a list of page
samples with ``layout_dets`` (category_type, text/latex/html, order,
ignore) and ``page_info`` (page_attribute.language, data_source, layout).
"""

from __future__ import annotations

import argparse
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from dots_ocr_tpu_torch.eval.metrics import (
    normalized_edit_distance,
    sequence_edit_distance,
    teds,
)

# Official category families. Figures are not text-scored; abandon-family
# categories are excluded from end2end scoring entirely (they are the
# _nohf "no page header/footer" convention's reason to exist —
# reference/dots_ocr/utils/format_transformer.py:166-167).
TEXT_CATEGORIES = {
    "text_block", "title", "figure_caption", "figure_footnote",
    "table_caption", "table_footnote", "code_txt", "code_txt_caption",
    "equation_caption", "reference", "text_mask",
}
FORMULA_CATEGORIES = {"equation_isolated"}
TABLE_CATEGORIES = {"table"}
ABANDON_CATEGORIES = {
    "abandon", "header", "footer", "page_footnote", "page_number",
    "figure", "equation_inline",
}

# A pair whose normalized distance exceeds this is considered NOT the same
# element: the assignment is broken and both sides score as unmatched.
MATCH_BREAK_THRESHOLD = 0.9


@dataclass
class Element:
    category: str          # "text" | "formula" | "table"
    content: str
    order: int             # reading-order position within its page
    ignore: bool = False
    raw_category: str = ""


@dataclass
class PageResult:
    language: str                       # "EN" | "CH"
    pairs: List[Tuple[Element, Optional[Element]]] = field(default_factory=list)
    pred_extra: List[Element] = field(default_factory=list)
    attributes: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Ground truth loading (official OmniDocBench.json shape)
# ---------------------------------------------------------------------------


def _gt_language(sample: dict) -> str:
    attr = (sample.get("page_info") or {}).get("page_attribute") or {}
    lang = str(attr.get("language", "")).lower()
    if "english" in lang or lang == "en":
        return "EN"
    if lang:
        return "CH"
    # No attribute: detect by CJK ratio over the page's GT text.
    text = " ".join(
        str(det.get("text", ""))
        for det in sample.get("layout_dets", [])
    )
    cjk = sum(1 for c in text if "一" <= c <= "鿿")
    return "CH" if text and cjk / max(1, len(text)) > 0.05 else "EN"


def _is_ignored(det: dict) -> bool:
    ig = det.get("ignore")
    if isinstance(ig, bool):
        return ig
    if isinstance(ig, str):
        return ig.lower() in ("yes", "true", "1")
    attr = det.get("attribute") or {}
    return str(attr.get("ignore", "")).lower() in ("yes", "true", "1")


def gt_elements(sample: dict) -> List[Element]:
    """Official layout_dets → scored Element list, reading order preserved."""
    out: List[Element] = []
    dets = sample.get("layout_dets", [])
    for i, det in enumerate(dets):
        cat = str(det.get("category_type", ""))
        order = det.get("order")
        order = int(order) if isinstance(order, (int, float)) else i
        if cat in ABANDON_CATEGORIES:
            continue
        if cat in TABLE_CATEGORIES:
            content = str(det.get("html") or det.get("latex")
                          or det.get("text") or "")
            fam = "table"
        elif cat in FORMULA_CATEGORIES:
            content = str(det.get("latex") or det.get("text") or "")
            fam = "formula"
        elif cat in TEXT_CATEGORIES:
            content = str(det.get("text") or "")
            fam = "text"
        else:
            continue
        out.append(Element(fam, content, order, _is_ignored(det), cat))
    out.sort(key=lambda e: e.order)
    return out


def gt_to_markdown(sample: dict) -> str:
    """Render a GT sample's scored elements as page markdown.

    The round-trip harness (tools/weights_day.py end2end_scorer stage):
    feeding this back through pred_elements + quick_match should score
    near-zero edit distance, which pins matching + normalization end to
    end without predictions.
    """
    parts = []
    for el in gt_elements(sample):
        if el.category == "table":
            parts.append(el.content if el.content.lstrip().startswith("<")
                         else f"<table><tr><td>{el.content}</td></tr></table>")
        elif el.category == "formula":
            parts.append(f"$${el.content}$$")
        elif el.raw_category == "title":
            parts.append(f"# {el.content}")
        else:
            parts.append(el.content)
    return "\n\n".join(p for p in parts if p.strip())


# ---------------------------------------------------------------------------
# Prediction parsing: page markdown → typed elements
# ---------------------------------------------------------------------------

_DISPLAY_MATH_RE = re.compile(r"\$\$(.+?)\$\$|\\\[(.+?)\\\]", re.DOTALL)
_HTML_TABLE_RE = re.compile(r"<table\b.*?</table\s*>", re.DOTALL | re.IGNORECASE)
_CODE_FENCE_RE = re.compile(r"```[^\n]*\n(.*?)```", re.DOTALL)
_MD_IMAGE_RE = re.compile(r"!\[[^\]]*\]\([^)]*\)")
_MD_TABLE_ROW = re.compile(r"^\s*\|.*\|\s*$")
_MD_TABLE_SEP = re.compile(r"^\s*\|?\s*:?-{2,}.*$")


def _md_table_to_html(rows: List[str]) -> str:
    """GitHub-style markdown table → minimal HTML for TEDS comparison."""
    cells_rows = []
    for row in rows:
        if _MD_TABLE_SEP.match(row):
            continue
        cells = [c.strip() for c in row.strip().strip("|").split("|")]
        cells_rows.append(cells)
    body = "".join(
        "<tr>" + "".join(f"<td>{c}</td>" for c in cells) + "</tr>"
        for cells in cells_rows
    )
    return f"<table>{body}</table>"


def pred_elements(md_text: str) -> List[Element]:
    """Segment predicted markdown into typed, ordered elements.

    The same decomposition the official md parser performs: HTML tables and
    display formulas are lifted out as their own elements; markdown pipe
    tables convert to HTML; code fences are text; heading markers strip;
    remaining prose splits on blank lines into text blocks.
    """
    text = md_text or ""
    placeholders: List[Element] = []

    def lift(regex, fam, transform=lambda s: s):
        def sub(m):
            content = transform(m.group(0))
            idx = len(placeholders)
            placeholders.append(Element(fam, content, -1))
            return f"\n\n\x00{idx}\x00\n\n"
        return regex.sub(sub, text)

    text = lift(_HTML_TABLE_RE, "table")
    text = _DISPLAY_MATH_RE.sub(
        lambda m: (placeholders.append(
            Element("formula", (m.group(1) or m.group(2) or "").strip(), -1))
            or f"\n\n\x00{len(placeholders) - 1}\x00\n\n"),
        text,
    )
    text = _CODE_FENCE_RE.sub(
        lambda m: (placeholders.append(Element("text", m.group(1).strip(), -1))
                   or f"\n\n\x00{len(placeholders) - 1}\x00\n\n"),
        text,
    )
    text = _MD_IMAGE_RE.sub("", text)

    out: List[Element] = []
    lines = text.split("\n")
    i = 0
    para: List[str] = []

    def flush_para():
        if para:
            blob = " ".join(para).strip()
            if blob:
                out.append(Element("text", blob, len(out)))
            para.clear()

    while i < len(lines):
        line = lines[i]
        stripped = line.strip()
        m = re.fullmatch(r"\x00(\d+)\x00", stripped)
        if m:
            flush_para()
            el = placeholders[int(m.group(1))]
            out.append(Element(el.category, el.content, len(out)))
            i += 1
            continue
        if _MD_TABLE_ROW.match(line):
            flush_para()
            rows = []
            while i < len(lines) and (_MD_TABLE_ROW.match(lines[i])
                                      or _MD_TABLE_SEP.match(lines[i])):
                rows.append(lines[i])
                i += 1
            out.append(Element("table", _md_table_to_html(rows), len(out)))
            continue
        if not stripped:
            flush_para()
            i += 1
            continue
        para.append(re.sub(r"^#{1,6}\s+", "", stripped))
        i += 1
    flush_para()
    for idx, el in enumerate(out):
        el.order = idx
    return out


# ---------------------------------------------------------------------------
# quick_match: pairing GT elements with pred elements
# ---------------------------------------------------------------------------

_NORM_RE = re.compile(r"\s+")


def _norm(s: str) -> str:
    return _NORM_RE.sub(" ", s or "").strip()


def _pair_distance(gt: Element, pred: Element) -> float:
    a, b = _norm(gt.content), _norm(pred.content)
    if gt.category == "table":
        # Tables match on flattened cell text (structure is scored later
        # by TEDS; matching only needs identity).
        a = _norm(re.sub(r"<[^>]+>", " ", a))
        b = _norm(re.sub(r"<[^>]+>", " ", b))
    return normalized_edit_distance(b, a)


def quick_match(
    gts: Sequence[Element], preds: Sequence[Element]
) -> Tuple[List[Tuple[Element, Optional[Element]]], List[Element]]:
    """Pair GT elements with pred elements (official quick_match role).

    Returns (pairs, unmatched_preds): each GT appears exactly once, paired
    with a pred Element or None; pred elements used by a merge are
    consumed. Stages: (1) Hungarian assignment on the normalized-edit-
    distance matrix within each category family, pairs broken above
    MATCH_BREAK_THRESHOLD; (2) adjacent-merge repair — an unmatched pred
    text fragment concatenates onto a neighbouring pred's match when that
    lowers the distance to the GT (model split one GT block); symmetric
    GT-merge is approximated by allowing one pred to win multiple adjacent
    GTs via the same test on the GT side.
    """
    import numpy as np
    from scipy.optimize import linear_sum_assignment

    pairs: List[Tuple[Element, Optional[Element]]] = []
    used_pred: set = set()
    matched: Dict[int, int] = {}  # gt idx -> pred idx

    for fam in ("text", "formula", "table"):
        gt_idx = [i for i, g in enumerate(gts) if g.category == fam]
        pr_idx = [j for j, p in enumerate(preds) if p.category == fam]
        if gt_idx and pr_idx:
            cost = np.ones((len(gt_idx), len(pr_idx)), np.float64)
            for a, gi in enumerate(gt_idx):
                for b, pj in enumerate(pr_idx):
                    cost[a, b] = _pair_distance(gts[gi], preds[pj])
            rows, cols = linear_sum_assignment(cost)
            for a, b in zip(rows, cols):
                if cost[a, b] <= MATCH_BREAK_THRESHOLD:
                    matched[gt_idx[a]] = pr_idx[b]
                    used_pred.add(pr_idx[b])

    # Merge repair: an unmatched pred fragment adjacent (by pred order) to a
    # matched pred may be a split-off piece of the same GT block.
    changed = True
    guard = 0
    while changed and guard < 4:
        changed = False
        guard += 1
        for j, p in enumerate(preds):
            if j in used_pred or p.category != "text":
                continue
            for nj in (j - 1, j + 1):
                if nj < 0 or nj >= len(preds):
                    continue
                if preds[nj].category != "text":
                    continue
                owner = next(
                    (gi for gi, pj in matched.items() if pj == nj), None
                )
                if owner is None:
                    continue
                gt_el = gts[owner]
                base = preds[nj]
                merged_text = (
                    f"{base.content} {p.content}" if nj < j
                    else f"{p.content} {base.content}"
                )
                merged = Element("text", merged_text, base.order)
                if _pair_distance(gt_el, merged) < _pair_distance(gt_el, base):
                    base.content = merged_text
                    used_pred.add(j)
                    changed = True
                    break

    for i, g in enumerate(gts):
        j = matched.get(i)
        pairs.append((g, preds[j] if j is not None else None))
    extra = [p for j, p in enumerate(preds) if j not in used_pred]
    return pairs, extra


# ---------------------------------------------------------------------------
# Scoring the matched pairs → the published column set
# ---------------------------------------------------------------------------


def match_page(sample: dict, pred_md: str) -> PageResult:
    gts = gt_elements(sample)
    preds = pred_elements(pred_md)
    pairs, extra = quick_match(gts, preds)
    info = (sample.get("page_info") or {})
    attrs = {
        k: str(v)
        for k, v in (info.get("page_attribute") or {}).items()
        if isinstance(v, (str, int, float))
    }
    for key in ("data_source", "layout"):
        if key in info:
            attrs[key] = str(info[key])
    return PageResult(
        language=_gt_language(sample),
        pairs=[(g, p) for g, p in pairs if not g.ignore],
        pred_extra=[p for p in extra if _norm(p.content)],
        attributes=attrs,
    )


def _reading_order_edit(page: PageResult) -> Optional[float]:
    """Normalized sequence edit distance between GT reading order and the
    pred order of the matched elements (official reading_order metric)."""
    both = [(g.order, p.order) for g, p in page.pairs if p is not None]
    if len(both) < 2:
        return None
    gt_seq = [g for g, _ in sorted(both)]
    pred_seq = [g for g, _ in sorted(both, key=lambda t: t[1])]
    return sequence_edit_distance(gt_seq, pred_seq) / len(both)


def score_pages_end2end(
    samples: Sequence[dict], preds_md: Dict[str, str]
) -> dict:
    """Full protocol over a GT sample list + {image_name: pred markdown}.

    Returns the published column dict plus per-attribute splits and the
    per-page detail under "pages".
    """
    import numpy as np

    cols: Dict[str, List[float]] = {}
    by_attr: Dict[str, List[float]] = {}
    page_detail = {}

    def add(col: str, v: float) -> None:
        cols.setdefault(col, []).append(v)

    for sample in samples:
        img = os.path.basename(
            (sample.get("page_info") or {}).get("image_path", "")
        )
        page_id = os.path.splitext(img)[0]
        md = preds_md.get(page_id)
        if md is None:
            continue
        page = match_page(sample, md)
        lang = page.language
        page_cols: Dict[str, List[float]] = {}

        for g, p in page.pairs:
            pc = _norm(p.content) if p is not None else ""
            gc = _norm(g.content)
            if g.category == "text":
                d = normalized_edit_distance(pc, gc)
                add(f"text_block_Edit_dist_{lang}", d)
                page_cols.setdefault("text", []).append(d)
            elif g.category == "formula":
                d = normalized_edit_distance(pc, gc)
                add(f"display_formula_Edit_dist_{lang}", d)
                page_cols.setdefault("formula", []).append(d)
            elif g.category == "table":
                d = normalized_edit_distance(pc, gc)
                add(f"table_Edit_dist_{lang}", d)
                t = teds(p.content if p is not None else "", g.content) * 100.0
                add(f"table_TEDS_{lang}", t)
                page_cols.setdefault("table", []).append(d)
        # Hallucinated pred elements: count as misses on the pred side
        # (distance 1 against an empty GT), same family bucketing.
        for p in page.pred_extra:
            fam = {"text": "text_block", "formula": "display_formula",
                   "table": "table"}[p.category]
            add(f"{fam}_Edit_dist_{lang}", 1.0)

        ro = _reading_order_edit(page)
        if ro is not None:
            add(f"reading_order_Edit_dist_{lang}", ro)

        page_edit = [v for vs in page_cols.values() for v in vs]
        page_mean = float(np.mean(page_edit)) if page_edit else None
        if page_mean is not None:
            for k, v in page.attributes.items():
                by_attr.setdefault(f"{k}: {v}", []).append(page_mean)
        page_detail[page_id] = {
            "language": lang,
            "matched": sum(1 for _, p in page.pairs if p is not None),
            "gt_elements": len(page.pairs),
            "pred_extra": len(page.pred_extra),
            "page_edit_mean": page_mean,
        }

    out: Dict[str, object] = {}
    for col, vals in sorted(cols.items()):
        out[col] = float(np.mean(vals))
    for lang in ("EN", "CH"):
        parts = [
            out.get(f"text_block_Edit_dist_{lang}"),
            out.get(f"display_formula_Edit_dist_{lang}"),
            out.get(f"table_Edit_dist_{lang}"),
            out.get(f"reading_order_Edit_dist_{lang}"),
        ]
        present = [p for p in parts if p is not None]
        if present:
            out[f"overall_{lang}"] = float(np.mean(present))
        out.setdefault(f"display_formula_CDM_{lang}", "-")  # no renderer
    out["attributes"] = {
        k: float(np.mean(v)) for k, v in sorted(by_attr.items())
    }
    out["pages"] = page_detail
    return out


def format_table(scores: dict) -> str:
    """Render the 【Overall】 block in the official log's layout."""
    order = [
        "text_block_Edit_dist_EN", "text_block_Edit_dist_CH",
        "display_formula_Edit_dist_EN", "display_formula_Edit_dist_CH",
        "display_formula_CDM_EN", "display_formula_CDM_CH",
        "table_TEDS_EN", "table_TEDS_CH",
        "table_Edit_dist_EN", "table_Edit_dist_CH",
        "reading_order_Edit_dist_EN", "reading_order_Edit_dist_CH",
        "overall_EN", "overall_CH",
    ]
    width = max(len(k) for k in order)
    lines = ["-" * (width + 2 + 20)]
    for k in order:
        v = scores.get(k, "-")
        sv = f"{v}" if isinstance(v, str) else f"{v:.6f}"
        lines.append(f"{k:<{width}}  {sv}")
    lines.append(lines[0])
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="OmniDocBench end2end protocol scorer (quick_match)"
    )
    ap.add_argument("--gt", required=True,
                    help="OmniDocBench.json (official GT shape)")
    ap.add_argument("--pred", required=True,
                    help="dir of per-page predicted .md (the *_nohf set)")
    ap.add_argument("--output", default=None, help="write scores JSON here")
    args = ap.parse_args(argv)

    with open(args.gt, encoding="utf-8") as f:
        samples = json.load(f)
    preds = {}
    for name in os.listdir(args.pred):
        if name.endswith(".md"):
            with open(os.path.join(args.pred, name), encoding="utf-8") as f:
                preds[os.path.splitext(name)[0]] = f.read()
    scores = score_pages_end2end(samples, preds)
    print("###### Process:  _quick_match")
    print("【Overall】")
    print(format_table(scores))
    if scores.get("attributes"):
        print("\n【Attributes】")
        for k, v in scores["attributes"].items():  # type: ignore[union-attr]
            print(f"{k:<40} {v:.6f}")
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(scores, f, indent=2, ensure_ascii=False, default=str)


if __name__ == "__main__":
    main()
