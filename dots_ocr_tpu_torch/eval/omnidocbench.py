"""OmniDocBench-style evaluation sweep.

Reproduces the reference recipe (``tools/eval_omnidocbench.md``): launch the
server, run every benchmark page through DotsOCRParser with many client
threads and ``fitz_preprocess=True``, collect the ``*_nohf.md`` outputs into
an eval directory, and (optionally, when ground-truth markdown is present)
score normalized edit distance in-repo.

CLI:
  python -m dots_ocr_tpu_torch.eval.omnidocbench IMAGES_DIR --output eval_out \
      --ip localhost --port 8000 --num-thread 64 [--references GT_DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from multiprocessing.pool import ThreadPool
from typing import Dict, List, Optional

from dots_ocr_tpu_torch.parser import DotsOCRParser
from dots_ocr_tpu_torch.utils.consts import image_extensions


def list_pages(images_dir: str) -> List[str]:
    return sorted(
        os.path.join(images_dir, f)
        for f in os.listdir(images_dir)
        if os.path.splitext(f)[1].lower() in image_extensions
    )


def run_sweep(
    images_dir: str,
    output_dir: str,
    parser: Optional[DotsOCRParser] = None,
    num_thread: int = 64,
    fitz_preprocess: bool = True,
    prompt_mode: str = "prompt_layout_all_en",
    **parser_kwargs,
) -> Dict[str, dict]:
    """Parse every page; returns {page_id: result_record}."""
    parser = parser or DotsOCRParser(num_thread=num_thread, **parser_kwargs)
    pages = list_pages(images_dir)
    results: Dict[str, dict] = {}
    errors: Dict[str, str] = {}

    def one(path: str):
        page_id = os.path.splitext(os.path.basename(path))[0]
        try:
            recs = parser.parse_file(
                path,
                output_dir=output_dir,
                prompt_mode=prompt_mode,
                fitz_preprocess=fitz_preprocess,
            )
            return page_id, recs[0], None
        except Exception as e:  # noqa: BLE001
            return page_id, None, str(e)

    t0 = time.time()
    with ThreadPool(min(num_thread, max(1, len(pages)))) as pool:
        for page_id, rec, err in pool.imap_unordered(one, pages):
            if err is None:
                results[page_id] = rec
            else:
                errors[page_id] = err
    elapsed = time.time() - t0

    summary = {
        "pages": len(pages),
        "succeeded": len(results),
        "failed": len(errors),
        "salvaged": sum(1 for r in results.values() if r.get("filtered")),
        "wall_seconds": round(elapsed, 2),
        "pages_per_second": round(len(results) / elapsed, 3) if elapsed else 0.0,
        "errors": errors,
    }
    with open(os.path.join(output_dir, "sweep_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return results


def collect_nohf_markdown(results: Dict[str, dict], dest_dir: str) -> Dict[str, str]:
    """Copy each page's *_nohf.md into one flat eval dir (the file set
    OmniDocBench's end2end scorer consumes). Returns {page_id: text}."""
    os.makedirs(dest_dir, exist_ok=True)
    out: Dict[str, str] = {}
    for page_id, rec in results.items():
        src = rec.get("md_content_nohf_path") or rec.get("md_content_path")
        if not src or not os.path.exists(src):
            continue
        dst = os.path.join(dest_dir, f"{page_id}.md")
        shutil.copy(src, dst)
        with open(src, encoding="utf-8") as f:
            out[page_id] = f.read()
    return out


def score_against_references(
    predictions: Dict[str, str], references_dir: str
) -> dict:
    from dots_ocr_tpu_torch.eval.metrics import score_pages

    refs: Dict[str, str] = {}
    for name in os.listdir(references_dir):
        if name.endswith(".md"):
            with open(os.path.join(references_dir, name), encoding="utf-8") as f:
                refs[os.path.splitext(name)[0]] = f.read()
    return score_pages(predictions, refs)


def score_layout_against_gt(
    results: Dict[str, dict], gt_json_dir: str
) -> dict:
    """Full benchmark column set (detection F1, per-category edit, TEDS,
    reading order) against a dir of per-page ground-truth layout JSON —
    the same columns the reference publishes
    (reference/assets/blog.md:419-432, 764-775)."""
    from dots_ocr_tpu_torch.eval.metrics import (
        aggregate_layout_scores,
        evaluate_layout_page,
    )

    per_page = {}
    for page_id, rec in results.items():
        gt_path = os.path.join(gt_json_dir, f"{page_id}.json")
        pred_path = rec.get("layout_info_path")
        if not os.path.exists(gt_path) or not pred_path or not os.path.exists(pred_path):
            continue
        with open(gt_path, encoding="utf-8") as f:
            gt_cells = json.load(f)
        with open(pred_path, encoding="utf-8") as f:
            pred_cells = json.load(f)
        if isinstance(gt_cells, dict):
            gt_cells = gt_cells.get("cells", [])
        if isinstance(pred_cells, dict):
            pred_cells = pred_cells.get("cells", [])

        def valid(cells):
            # Salvaged pages (filtered=True) may store a raw string or
            # bbox-less fragments; score only well-formed cells — the
            # missing ones show up as detection/recall misses.
            if not isinstance(cells, list):
                return []
            return [
                c for c in cells
                if isinstance(c, dict) and isinstance(c.get("bbox"), list)
                and len(c["bbox"]) == 4
            ]

        per_page[page_id] = evaluate_layout_page(valid(pred_cells), valid(gt_cells))
    agg = aggregate_layout_scores(list(per_page.values()))
    agg["per_page"] = per_page
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser(description="OmniDocBench-style sweep")
    ap.add_argument("images_dir")
    ap.add_argument("--output", default="./eval_output")
    ap.add_argument("--ip", default="localhost")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--num-thread", type=int, default=64)
    ap.add_argument("--no-fitz-preprocess", action="store_true")
    ap.add_argument("--references", default=None, help="dir of ground-truth .md")
    ap.add_argument(
        "--gt-json", default=None,
        help="dir of ground-truth layout JSON ({page_id}.json) for the full "
        "column set: detection F1@.50:.95, per-category edit, TEDS, order",
    )
    ap.add_argument(
        "--gt", default=None,
        help="official OmniDocBench.json: score through the end2end "
        "PROTOCOL (eval/end2end.py — element matching via quick_match "
        "before per-category metrics; the published-table method) instead "
        "of raw-page edit distance. Drift vs the official pipeline is "
        "documented in the end2end module docstring",
    )
    args = ap.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    parser = DotsOCRParser(ip=args.ip, port=args.port, num_thread=args.num_thread)
    results = run_sweep(
        args.images_dir,
        args.output,
        parser=parser,
        num_thread=args.num_thread,
        fitz_preprocess=not args.no_fitz_preprocess,
    )
    preds = collect_nohf_markdown(results, os.path.join(args.output, "markdown_nohf"))
    print(f"collected {len(preds)} markdown outputs")
    scores = {}
    if args.references:
        score = score_against_references(preds, args.references)
        scores["overall_edit_distance"] = score["overall"]
        scores["pages"] = score["count"]
        scores["md_pages"] = score["pages"]
    if args.gt_json:
        layout = score_layout_against_gt(results, args.gt_json)
        per_page = layout.pop("per_page")
        scores["layout"] = layout
        scores["layout_per_page"] = per_page
    if args.gt:
        from dots_ocr_tpu_torch.eval.end2end import (
            format_table,
            score_pages_end2end,
        )

        with open(args.gt, encoding="utf-8") as f:
            samples = json.load(f)
        e2e = score_pages_end2end(samples, preds)
        print("###### Process:  _quick_match")
        print(format_table(e2e))
        scores["end2end"] = {
            k: v for k, v in e2e.items() if k != "pages"
        }
    if scores:
        headline = {k: v for k, v in scores.items()
                    if k not in ("md_pages", "layout_per_page")}
        print(json.dumps(headline))
        with open(os.path.join(args.output, "scores.json"), "w") as f:
            json.dump(scores, f, indent=2, default=str)


if __name__ == "__main__":
    main()
