"""Salvage of malformed / truncated / degenerate model JSON output.

Long autoregressive decodes can end mid-object (token budget), loop (low
temperature repetition), or drop delimiters. This module recovers a usable
layout-cell list from such output. It is the system's robustness layer and
must behave exactly like the reference cleaner
(``dots_ocr/utils/output_cleaner.py:32-435``); every rule below is covered by
tests with hand-written fixtures.

Pipeline for string input (clean_string_data):
  1. fix missing ``}{`` delimiters (only when the ``{`` is not immediately
     followed by a quote — reference regex semantics preserved verbatim),
  2. drop the trailing incomplete element when the text is >50k chars or does
     not end with ``]`` (kept when there is at most one object),
  3. order-preserving dedup of complete ``{"bbox": ...}`` objects,
  4. bracket-close into a JSON array,
  5. parse; on failure fall back to per-object extraction, then to a
     regex-rebuild of a single incomplete object.

Finally (both list and string inputs): category+text pairs repeating >= 5
times and bboxes repeating >= 2 times are deduplicated, keeping the first
occurrence (decode-loop suppression).
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

# A "complete object": single-level dict containing a bbox array.
_DICT_RE = re.compile(r'\{[^{}]*?"bbox"\s*:\s*\[[^\]]*?\][^{}]*?\}', re.DOTALL)
_BBOX_RE = re.compile(r'"bbox"\s*:\s*\[([^\]]+)\]')
# '}' '{' with no comma, where the '{' is NOT followed by a quote.
_MISSING_DELIM_RE = re.compile(r"\}\s*\{(?!\")")
_CATEGORY_RE = re.compile(r'"category"\s*:\s*"([^"]+)"')
_TEXT_PREFIX_RE = re.compile(r'"text"\s*:\s*"([^"]{0,10000})')

_LONG_OUTPUT_CHARS = 50_000
_PAIR_DUP_THRESHOLD = 5
_BBOX_DUP_THRESHOLD = 2


@dataclass
class CleanResult:
    """Outcome of one salvage attempt."""

    original_type: str  # 'list' or 'str'
    original_length: int
    cleaned_data: List[Dict]
    operations: Dict[str, Any] = field(default_factory=dict)
    success: bool = True


def _fix_missing_delimiters(text: str) -> Tuple[str, int]:
    fixes = 0

    def _sub(_match: re.Match) -> str:
        nonlocal fixes
        fixes += 1
        return "},{"

    return _MISSING_DELIM_RE.sub(_sub, text), fixes


def _truncate_last_incomplete_element(text: str) -> Tuple[str, bool]:
    needs_truncation = len(text) > _LONG_OUTPUT_CHARS or not text.strip().endswith("]")
    if not needs_truncation:
        return text, False

    if text.count('{"bbox":') <= 1:
        # A lone object must survive — truncating would delete everything.
        return text, False

    last_pos = text.rfind('{"bbox":')
    if last_pos <= 0:
        return text, False

    truncated = text[:last_pos].rstrip()
    if truncated.endswith(","):
        truncated = truncated[:-1]
    logger.debug(
        "truncated incomplete tail: %d -> %d chars", len(text), len(truncated)
    )
    return truncated, True


def _dedup_complete_dicts(text: str) -> Tuple[str, int]:
    matches = [m.group() for m in _DICT_RE.finditer(text)]
    if not matches:
        return text, 0

    seen: set = set()
    unique: List[str] = []
    duplicates = 0
    for s in matches:
        if s in seen:
            duplicates += 1
        else:
            seen.add(s)
            unique.append(s)

    if duplicates == 0:
        return text, 0
    return "[" + ", ".join(unique) + "]", duplicates


def _close_json_array(text: str) -> str:
    text = text.strip()
    if not text.startswith("["):
        text = "[" + text
    if not text.endswith("]"):
        text = text.rstrip(",").rstrip() + "]"
    return text


def _rebuild_single_incomplete_dict(text: str) -> Optional[List[Dict]]:
    """Last-resort rebuild of ``[{"bbox": ... <cut off>``: recover bbox,
    category (default Text), and up to 10k chars of text."""
    if not text.strip().startswith('[{"bbox":'):
        return None
    try:
        bbox_match = _BBOX_RE.search(text)
        if not bbox_match:
            return None
        coords = [int(x.strip()) for x in bbox_match.group(1).split(",")]
        if len(coords) != 4:
            return None

        cat_match = _CATEGORY_RE.search(text)
        category = cat_match.group(1) if cat_match else "Text"

        text_match = _TEXT_PREFIX_RE.search(text)
        content = text_match.group(1) if text_match else ""

        rebuilt: Dict[str, Any] = {"bbox": coords, "category": category}
        if content:
            rebuilt["text"] = content
        logger.debug("rebuilt single incomplete dict: %s", rebuilt)
        return [rebuilt]
    except Exception:  # noqa: BLE001
        return None


def _parse_salvaged_json(text: str) -> Optional[List[Dict]]:
    try:
        data = json.loads(text)
        if isinstance(data, list):
            return data
    except json.JSONDecodeError:
        valid: List[Dict] = []
        for match in _DICT_RE.finditer(text):
            try:
                valid.append(json.loads(match.group()))
            except Exception:  # noqa: BLE001
                continue
        if valid:
            return valid
        return _rebuild_single_incomplete_dict(text)
    return None


def clean_list_data(data: List[Any]) -> CleanResult:
    """Repair an already-parsed list: fix 3-coordinate bboxes, drop malformed
    entries, preserve order."""
    cleaned: List[Dict] = []
    ops = {"type": "list", "bbox_fixes": 0, "removed_items": 0, "original_count": len(data)}

    for item in data:
        if not isinstance(item, dict):
            ops["removed_items"] += 1
            continue
        if "bbox" in item:
            bbox = item["bbox"]
            if isinstance(bbox, list) and len(bbox) == 3:
                # Unusable bbox: salvage the category/text payload only.
                salvaged = {}
                if "category" in item:
                    salvaged["category"] = item["category"]
                if "text" in item:
                    salvaged["text"] = item["text"]
                if salvaged:
                    cleaned.append(salvaged)
                    ops["bbox_fixes"] += 1
                else:
                    ops["removed_items"] += 1
            elif isinstance(bbox, list) and len(bbox) == 4:
                cleaned.append(dict(item))
            else:
                ops["removed_items"] += 1
        elif "category" in item:
            cleaned.append(dict(item))
        else:
            ops["removed_items"] += 1

    ops["final_count"] = len(cleaned)
    return CleanResult("list", len(data), cleaned, ops, success=True)


def clean_string_data(data_str: str) -> CleanResult:
    """Run the 5-step string salvage pipeline (see module docstring)."""
    ops: Dict[str, Any] = {
        "type": "str",
        "original_length": len(data_str),
        "delimiter_fixes": 0,
        "tail_truncated": False,
        "truncated_length": 0,
        "duplicate_dicts_removed": 0,
        "final_objects": 0,
    }
    try:
        data_str, ops["delimiter_fixes"] = _fix_missing_delimiters(data_str)
        data_str, ops["tail_truncated"] = _truncate_last_incomplete_element(data_str)
        ops["truncated_length"] = len(data_str)
        data_str, ops["duplicate_dicts_removed"] = _dedup_complete_dicts(data_str)
        data_str = _close_json_array(data_str)
        final = _parse_salvaged_json(data_str)
        if final is None:
            raise ValueError("could not parse the cleaned data")
        ops["final_objects"] = len(final)
        return CleanResult("str", ops["original_length"], final, ops, success=True)
    except Exception as e:  # noqa: BLE001
        logger.debug("string salvage failed: %s", e)
        return CleanResult("str", ops["original_length"], [], ops, success=False)


def dedup_repeats(data_list: List[Dict]) -> List[Dict]:
    """Suppress decode loops: drop category+text pairs repeating >= 5 times
    and bboxes repeating >= 2 times, keeping first occurrences, preserving
    order (reference output_cleaner.py:347-416)."""
    if not data_list or len(data_list) <= 1:
        return data_list

    pair_positions: Dict[Tuple[str, str], List[int]] = {}
    bbox_positions: Dict[tuple, List[int]] = {}
    for i, item in enumerate(data_list):
        if isinstance(item, dict) and "category" in item and "text" in item:
            key = (item.get("category", ""), item.get("text", ""))
            pair_positions.setdefault(key, []).append(i)
        if isinstance(item, dict) and "bbox" in item:
            bbox = item.get("bbox")
            if isinstance(bbox, list) and len(bbox) > 0:
                bbox_positions.setdefault(tuple(bbox), []).append(i)

    to_remove: set = set()
    for positions in pair_positions.values():
        if len(positions) >= _PAIR_DUP_THRESHOLD:
            to_remove.update(positions[1:])
    for positions in bbox_positions.values():
        if len(positions) >= _BBOX_DUP_THRESHOLD:
            to_remove.update(positions[1:])

    if not to_remove:
        return data_list
    return [item for i, item in enumerate(data_list) if i not in to_remove]


class OutputCleaner:
    """Reference-compatible facade over the salvage pipeline."""

    def __init__(self) -> None:
        self.cleaned_results: List[CleanResult] = []

    def clean_model_output(self, model_output):
        """Salvage one model response (list or string).

        Returns the cleaned cell list; on any internal failure returns the
        input unchanged (output_cleaner.py:418-435).
        """
        try:
            if isinstance(model_output, list):
                result = clean_list_data(model_output)
            else:
                result = clean_string_data(str(model_output))
            if result.success and result.cleaned_data:
                result.cleaned_data = dedup_repeats(result.cleaned_data)
            return result.cleaned_data
        except Exception as e:  # noqa: BLE001
            logger.warning("salvage failed entirely: %s", e)
            return model_output

    def clean_jsonl(self, jsonl_path: str, predict_key: str = "predict") -> List[Dict]:
        """Batch mode: clean the ``predict`` field of every record in a JSONL
        file, writing ``*_filtered.jsonl`` next to it with a
        ``predict_resized`` field added (output_cleaner.py:437-487)."""
        records: List[Dict] = []
        with open(jsonl_path, "r", encoding="utf-8") as f:
            for line in f:
                if not line.strip():
                    continue
                record = json.loads(line)
                predict = record.get(predict_key)
                if isinstance(predict, list):
                    result = clean_list_data(predict)
                else:
                    result = clean_string_data(str(predict))
                if result.success and result.cleaned_data:
                    result.cleaned_data = dedup_repeats(result.cleaned_data)
                record["predict_resized"] = result.cleaned_data
                records.append(record)
                self.cleaned_results.append(result)

        save_path = jsonl_path.replace(".jsonl", "_filtered.jsonl")
        with open(save_path, "w", encoding="utf-8") as w:
            for record in records:
                w.write(json.dumps(record, ensure_ascii=False) + "\n")
        return records

    def report(self) -> Dict[str, Any]:
        """Summary statistics over everything cleaned so far."""
        total = len(self.cleaned_results)
        ok = sum(1 for r in self.cleaned_results if r.success)
        return {
            "total_cases": total,
            "successful": ok,
            "success_rate": (ok / total) if total else 0.0,
            "total_objects": sum(len(r.cleaned_data) for r in self.cleaned_results),
        }
