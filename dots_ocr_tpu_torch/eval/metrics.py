"""Document-parsing quality metrics: normalized edit distance & friends.

The reference scores itself with OmniDocBench's normalized edit distance
over the ``*_nohf.md`` outputs (``tools/eval_omnidocbench.md``; published
EN 0.125 / ZH 0.160, ``assets/blog.md:419-432``). This module provides the
metric primitives so sweeps can be scored in-repo when ground truth is
available.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np


def levenshtein(a: str, b: str) -> int:
    """Edit distance, O(len(a) * len(b)) vectorized over rows."""
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    # numpy DP: iterate rows of a, vectorize over b
    b_arr = np.frombuffer(b.encode("utf-32-le"), dtype=np.uint32)
    js = np.arange(1, len(b) + 1, dtype=np.int64)
    prev = np.arange(len(b) + 1, dtype=np.int64)
    for i, ch in enumerate(a, start=1):
        cur = np.empty_like(prev)
        cur[0] = i
        cost = (b_arr != ord(ch)).astype(np.int64)
        # substitution / insertion candidates are vectorizable;
        # deletion (cur[j] = cur[j-1] + 1) is a prefix-min scan:
        # cur[j] = min(j + min_{k<=j}(best[k] - k), cur[0] + j).
        best = np.minimum(prev[:-1] + cost, prev[1:] + 1)
        prefix = np.minimum.accumulate(best - js)
        cur[1:] = np.minimum(js + prefix, i + js)
        prev = cur
    return int(prev[-1])


def normalized_edit_distance(prediction: str, reference: str) -> float:
    """Levenshtein / max(len) in [0, 1]; 0 = perfect."""
    if not prediction and not reference:
        return 0.0
    denom = max(len(prediction), len(reference))
    return levenshtein(prediction, reference) / denom


_WS_RE = re.compile(r"\s+")


def normalize_markdown(text: str) -> str:
    """Light normalization before scoring: collapse whitespace, strip
    decoration that the benchmark treats as formatting noise."""
    text = re.sub(r"!\[\]\(data:image/[^)]*\)", "", text)  # inline base64 images
    text = _WS_RE.sub(" ", text)
    return text.strip()


def score_pages(
    predictions: Dict[str, str], references: Dict[str, str], normalize: bool = True
) -> Dict[str, float]:
    """Per-page + aggregate normalized edit distance.

    Returns {"overall": mean, "pages": {page_id: dist}} over the page ids
    present in both dicts.
    """
    shared = sorted(set(predictions) & set(references))
    per_page = {}
    for page in shared:
        p, r = predictions[page], references[page]
        if normalize:
            p, r = normalize_markdown(p), normalize_markdown(r)
        per_page[page] = normalized_edit_distance(p, r)
    overall = float(np.mean(list(per_page.values()))) if per_page else 0.0
    return {"overall": overall, "pages": per_page, "count": len(per_page)}


# ---------------------------------------------------------------------------
# Sequence edit distance (reading order operates on id sequences, not text)
# ---------------------------------------------------------------------------


def sequence_edit_distance(a, b) -> int:
    """Levenshtein over arbitrary hashable sequences."""
    a, b = list(a), list(b)
    if a == b:
        return 0
    if not a:
        return len(b)
    if not b:
        return len(a)
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, start=1):
        cur = [i] + [0] * len(b)
        for j, y in enumerate(b, start=1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (x != y))
        prev = cur
    return prev[-1]


# ---------------------------------------------------------------------------
# TEDS: Tree Edit Distance Similarity for HTML tables
# ---------------------------------------------------------------------------
#
# The reference reports table quality as TEDS (published EN 88.6 / ZH 89.0,
# reference/assets/blog.md:426-428): parse both HTML tables into
# trees, compute Zhang-Shasha tree edit distance with cell-text-aware
# substitution costs, and score 1 - TED / max(|T_pred|, |T_gt|).


class _HtmlNode:
    __slots__ = ("tag", "colspan", "rowspan", "text", "children")

    def __init__(self, tag, colspan=1, rowspan=1, text=""):
        self.tag = tag
        self.colspan = colspan
        self.rowspan = rowspan
        self.text = text
        self.children = []


_STRUCT_TAGS = {"table", "thead", "tbody", "tfoot", "tr", "td", "th"}


def parse_html_table(html: str) -> _HtmlNode:
    """Parse table HTML into a tree of structural nodes; non-table markup
    inside cells contributes to cell text only. th is normalized to td
    (OmniDocBench annotations mix them)."""
    from html.parser import HTMLParser

    root = _HtmlNode("root")

    class P(HTMLParser):
        def __init__(self):
            super().__init__(convert_charrefs=True)
            self.stack = [root]

        def handle_starttag(self, tag, attrs):
            if tag not in _STRUCT_TAGS:
                return
            if tag == "th":
                tag = "td"
            a = dict(attrs)

            def _int(v):
                try:
                    return max(1, int(v))
                except (TypeError, ValueError):
                    return 1

            node = _HtmlNode(tag, _int(a.get("colspan")), _int(a.get("rowspan")))
            self.stack[-1].children.append(node)
            self.stack.append(node)

        def handle_endtag(self, tag):
            if tag == "th":
                tag = "td"
            if tag in _STRUCT_TAGS and len(self.stack) > 1:
                # pop back to the matching open tag if present
                for i in range(len(self.stack) - 1, 0, -1):
                    if self.stack[i].tag == tag:
                        del self.stack[i:]
                        break

        def handle_data(self, data):
            node = self.stack[-1]
            if node.tag == "td":
                node.text += data

    P().feed(html or "")
    for node in _iter_tree(root):
        node.text = _WS_RE.sub(" ", node.text).strip()
    return root


def _iter_tree(node):
    yield node
    for c in node.children:
        yield from _iter_tree(c)


def tree_size(node) -> int:
    return sum(1 for _ in _iter_tree(node))


def _postorder(root):
    """(nodes postorder, leftmost-leaf-descendant index per node)."""
    nodes, lld = [], []

    def walk(n):
        first = None
        for c in n.children:
            f = walk(c)
            if first is None:
                first = f
        idx = len(nodes)
        nodes.append(n)
        lld.append(first if first is not None else idx)
        return lld[idx]

    walk(root)
    return nodes, lld


def _rename_cost(a: _HtmlNode, b: _HtmlNode, structure_only: bool) -> float:
    if a.tag != b.tag:
        return 1.0
    if a.tag == "td":
        if (a.colspan, a.rowspan) != (b.colspan, b.rowspan):
            return 1.0
        if structure_only:
            return 0.0
        return normalized_edit_distance(a.text, b.text)
    return 0.0


def tree_edit_distance(t1: _HtmlNode, t2: _HtmlNode, structure_only=False) -> float:
    """Zhang-Shasha ordered tree edit distance (insert/delete cost 1,
    rename cost per _rename_cost)."""
    n1, l1 = _postorder(t1)
    n2, l2 = _postorder(t2)
    kr1 = _keyroots(l1)
    kr2 = _keyroots(l2)
    td = np.zeros((len(n1), len(n2)), dtype=np.float64)

    for i in kr1:
        for j in kr2:
            _treedist(i, j, n1, l1, n2, l2, td, structure_only)
    return float(td[len(n1) - 1, len(n2) - 1])


def _keyroots(lld):
    seen = set()
    out = []
    for i in range(len(lld) - 1, -1, -1):
        if lld[i] not in seen:
            seen.add(lld[i])
            out.append(i)
    return sorted(out)


def _treedist(i, j, n1, l1, n2, l2, td, structure_only):
    li, lj = l1[i], l2[j]
    m, n = i - li + 2, j - lj + 2
    fd = np.zeros((m, n), dtype=np.float64)
    fd[0, 1:] = np.arange(1, n)
    fd[1:, 0] = np.arange(1, m)
    for di in range(1, m):
        gi = li + di - 1  # global index in n1
        for dj in range(1, n):
            gj = lj + dj - 1
            if l1[gi] == li and l2[gj] == lj:
                cost = _rename_cost(n1[gi], n2[gj], structure_only)
                fd[di, dj] = min(
                    fd[di - 1, dj] + 1,
                    fd[di, dj - 1] + 1,
                    fd[di - 1, dj - 1] + cost,
                )
                td[gi, gj] = fd[di, dj]
            else:
                fd[di, dj] = min(
                    fd[di - 1, dj] + 1,
                    fd[di, dj - 1] + 1,
                    fd[l1[gi] - li, l2[gj] - lj] + td[gi, gj],
                )


def teds(pred_html: str, gt_html: str, structure_only: bool = False) -> float:
    """Tree Edit Distance Similarity in [0, 1]; 1 = identical tables."""
    t1 = parse_html_table(pred_html)
    t2 = parse_html_table(gt_html)
    if tree_size(t1) <= 1 and tree_size(t2) <= 1:
        return 1.0
    dist = tree_edit_distance(t1, t2, structure_only=structure_only)
    # Edit distance is bounded by |T1| + |T2|, not max(|T1|, |T2|): a
    # structurally very different prediction can exceed max() and would
    # push the similarity negative — clamp to honor the [0, 1] contract.
    return max(0.0, 1.0 - dist / max(tree_size(t1), tree_size(t2)))


# ---------------------------------------------------------------------------
# Layout detection F1 @ IoU thresholds
# ---------------------------------------------------------------------------
#
# The reference reports layout-detection F1@.50:.95 = 0.845 for the
# detection-only prompt (reference/assets/blog.md:764-775).


def bbox_iou(a, b) -> float:
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax1, bx1), min(ay1, by1)
    iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
    inter = iw * ih
    if inter <= 0:
        return 0.0
    area_a = max(0.0, ax1 - ax0) * max(0.0, ay1 - ay0)
    area_b = max(0.0, bx1 - bx0) * max(0.0, by1 - by0)
    return inter / (area_a + area_b - inter)


def match_cells(pred_cells, gt_cells, iou_threshold=0.5, match_category=True):
    """Greedy one-to-one matching by IoU (descending). Returns list of
    (pred_idx, gt_idx, iou) pairs."""
    candidates = []
    for pi, p in enumerate(pred_cells):
        for gi, g in enumerate(gt_cells):
            if match_category and p.get("category") != g.get("category"):
                continue
            v = bbox_iou(p["bbox"], g["bbox"])
            if v >= iou_threshold:
                candidates.append((v, pi, gi))
    candidates.sort(reverse=True)
    used_p, used_g, pairs = set(), set(), []
    for v, pi, gi in candidates:
        if pi in used_p or gi in used_g:
            continue
        used_p.add(pi)
        used_g.add(gi)
        pairs.append((pi, gi, v))
    return pairs


def detection_f1(pred_cells, gt_cells, thresholds=None, match_category=True):
    """Precision/recall/F1 per IoU threshold + the .50:.95 average.

    Cells are dicts with "bbox" [x0,y0,x1,y1] and "category"."""
    if thresholds is None:
        thresholds = [0.5 + 0.05 * k for k in range(10)]
    per_thr = {}
    for thr in thresholds:
        tp = len(match_cells(pred_cells, gt_cells, thr, match_category))
        prec = tp / len(pred_cells) if pred_cells else (1.0 if not gt_cells else 0.0)
        rec = tp / len(gt_cells) if gt_cells else (1.0 if not pred_cells else 0.0)
        f1 = 2 * prec * rec / (prec + rec) if (prec + rec) else 0.0
        per_thr[round(thr, 2)] = {"precision": prec, "recall": rec, "f1": f1}
    avg = float(np.mean([v["f1"] for v in per_thr.values()]))
    return {
        "f1@.50": per_thr[0.5]["f1"],
        "f1@.75": per_thr[0.75]["f1"],
        "f1@.50:.95": avg,
        "per_threshold": per_thr,
    }


# ---------------------------------------------------------------------------
# Per-category content scores + reading order
# ---------------------------------------------------------------------------
#
# The published table breaks quality into text / formula / table /
# reading-order columns (reference/assets/blog.md:419-432). Cells are
# layout-JSON dicts: {"bbox": [...], "category": ..., "text": ...}.

CATEGORY_GROUPS = {
    "Text": "text",
    "Title": "text",
    "Section-header": "text",
    "List-item": "text",
    "Caption": "text",
    "Footnote": "text",
    "Page-header": "text",
    "Page-footer": "text",
    "Formula": "formula",
    "Table": "table",
    # Picture has no text content to score.
}


def per_category_scores(pred_cells, gt_cells, iou_threshold=0.5):
    """Mean content distance per category group over IoU-matched cells.

    text/formula -> normalized edit distance; table -> 1 - TEDS. Unmatched
    GT cells of a group count as distance 1 (content entirely missed);
    unmatched predictions likewise (hallucinated content).
    """
    pairs = match_cells(pred_cells, gt_cells, iou_threshold, match_category=False)
    matched_p = {pi for pi, _, _ in pairs}
    matched_g = {gi for _, gi, _ in pairs}
    dists = {"text": [], "formula": [], "table": []}

    def group_of(cell):
        return CATEGORY_GROUPS.get(cell.get("category"))

    for pi, gi, _ in pairs:
        g = gt_cells[gi]
        grp = group_of(g)
        if grp is None:
            continue
        p_text = pred_cells[pi].get("text") or ""
        g_text = g.get("text") or ""
        if grp == "table":
            dists[grp].append(1.0 - teds(p_text, g_text))
        else:
            dists[grp].append(normalized_edit_distance(p_text, g_text))
    for gi, g in enumerate(gt_cells):
        grp = group_of(g)
        if grp is not None and gi not in matched_g and (g.get("text") or grp == "table"):
            dists[grp].append(1.0)
    for pi, p in enumerate(pred_cells):
        grp = group_of(p)
        if grp is not None and pi not in matched_p and (p.get("text") or grp == "table"):
            dists[grp].append(1.0)

    out = {}
    for grp, vals in dists.items():
        out[f"{grp}_edit"] = float(np.mean(vals)) if vals else None
        out[f"{grp}_count"] = len(vals)
    return out


def reading_order_edit(pred_cells, gt_cells, iou_threshold=0.5) -> "float | None":
    """Normalized edit distance between the GT indices in PREDICTED order
    and the GT order itself (OmniDocBench-style read-order metric; both
    inputs are assumed emitted in reading order)."""
    pairs = match_cells(pred_cells, gt_cells, iou_threshold, match_category=False)
    if not pairs:
        return None
    by_pred = sorted(pairs)  # pred emission order
    pred_seq = [gi for _, gi, _ in by_pred]
    gt_seq = sorted(pred_seq)
    denom = max(len(pred_seq), len(gt_seq))
    return sequence_edit_distance(pred_seq, gt_seq) / denom if denom else 0.0


def evaluate_layout_page(pred_cells, gt_cells):
    """Full per-page scorecard: detection F1, per-category content edit
    distances, TEDS over tables, reading order."""
    out = {"detection": detection_f1(pred_cells, gt_cells)}
    out.update(per_category_scores(pred_cells, gt_cells))
    out["read_order_edit"] = reading_order_edit(pred_cells, gt_cells)
    tables_p = [c for c in pred_cells if c.get("category") == "Table"]
    tables_g = [c for c in gt_cells if c.get("category") == "Table"]
    pairs = match_cells(tables_p, tables_g, 0.5, match_category=True)
    # Unmatched GT tables (missed) AND unmatched predicted tables
    # (hallucinated) both score 0 — a model that fabricates tables must
    # not tie with one that doesn't.
    teds_vals = (
        [
            teds(tables_p[pi].get("text") or "", tables_g[gi].get("text") or "")
            for pi, gi, _ in pairs
        ]
        + [0.0] * (len(tables_g) - len(pairs))
        + [0.0] * (len(tables_p) - len(pairs))
    )
    out["table_teds"] = float(np.mean(teds_vals)) if teds_vals else None
    return out


def aggregate_layout_scores(per_page: "list[dict]") -> dict:
    """Mean the per-page scorecards into the published-table column set."""
    def mean_of(key):
        vals = [p[key] for p in per_page if p.get(key) is not None]
        return float(np.mean(vals)) if vals else None

    return {
        "text_edit": mean_of("text_edit"),
        "formula_edit": mean_of("formula_edit"),
        "table_edit": mean_of("table_edit"),
        "table_teds": mean_of("table_teds"),
        "read_order_edit": mean_of("read_order_edit"),
        "detection_f1@.50:.95": float(np.mean(
            [p["detection"]["f1@.50:.95"] for p in per_page]
        )) if per_page else None,
        "pages": len(per_page),
    }
