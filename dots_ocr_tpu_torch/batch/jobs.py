"""Batch job system: queue, worker pool, retry/backoff, failure taxonomy.

Library-grade rebuild of the reference batch console's client-side job
system (``demo/demo_gradio_batch.py:47-1163``): a task queue + worker pool
feeding a DotsOCRParser, with

  * transient-error classification and exponential-backoff auto-retry
    (base 1.7, <= 5 attempts, 10 s cap — ``:1046-1081``),
  * human-readable failure classification (pixel bounds / unreadable input
    / connection diagnostics — ``:141-175``),
  * per-result lifecycle pending -> running -> done | error, re-parse and
    delete (queue purge) operations,
  * zip export of artifacts,

plus what the reference lacks (SURVEY.md §5.4): an optional on-disk job
manifest so a restarted process can list prior results.

Unlike the reference's lock-free dict mutation from many threads, all
shared state here is guarded by one lock.
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
import time
import uuid
import zipfile
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, List, Optional

from dots_ocr_tpu_torch.utils.consts import MAX_PIXELS, MIN_PIXELS

logger = logging.getLogger(__name__)

MAX_AUTO_RETRIES = 5
RETRY_BACKOFF_BASE = 1.7
RETRY_DELAY_CAP_S = 10.0

_TRANSIENT_KEYWORDS = [
    "connection refused",
    "connectionerror",
    "timeout",
    "timed out",
    "gateway",
    "service unavailable",
    "failed to establish a new connection",
    "max retries exceeded",
    "read timeout",
    "connect timeout",
]


def is_transient_backend_error(exc: Exception) -> bool:
    """Connection/timeout/gateway failures: worth retrying automatically."""
    lower = str(exc).lower()
    return any(k in lower for k in _TRANSIENT_KEYWORDS)


def classify_parse_failure(
    exc: Exception, min_pixels: Optional[int], max_pixels: Optional[int]
) -> str:
    """Human-readable diagnosis of a permanent parse failure."""
    msg = str(exc)
    min_p = min_pixels if min_pixels is not None else MIN_PIXELS
    max_p = max_pixels if max_pixels is not None else MAX_PIXELS
    reasons = []
    if min_p < MIN_PIXELS:
        reasons.append(
            f"min_pixels too small: {min_p}, must be >= {MIN_PIXELS}; raise min_pixels."
        )
    if max_p > MAX_PIXELS:
        reasons.append(
            f"max_pixels too large: {max_p}, must be <= {MAX_PIXELS}; lower max_pixels."
        )
    if min_p >= max_p:
        reasons.append(
            f"invalid pixel bounds: min_pixels({min_p}) >= max_pixels({max_p})."
        )
    lower = msg.lower()
    if "no results returned" in lower:
        reasons.append(
            "Parser returned no results — image may be too small or the "
            "pixel bounds too restrictive."
        )
    if "failed to read input" in lower or "cannot identify image file" in lower:
        reasons.append("Input file unreadable — confirm it is a valid image or PDF.")
    if ("connection" in lower and "refused" in lower) or "connectionerror" in lower:
        reasons.append(
            "Cannot reach the inference server — check server IP/port and health."
        )
    if not reasons:
        reasons.append(f"Unknown error: {msg}")
    detail = "\n".join(f"- {r}" for r in reasons)
    return (
        f"Parse failed:\n{detail}\n"
        f"(current parameters: min_pixels={min_p}, max_pixels={max_p})"
    )


@dataclass
class BatchTask:
    rid: str
    input_path: str
    prompt_mode: str = "prompt_layout_all_en"
    fitz_preprocess: bool = False
    min_pixels: Optional[int] = None
    max_pixels: Optional[int] = None
    custom_prompt: Optional[str] = None
    temperature: Optional[float] = None


@dataclass
class BatchResult:
    rid: str
    input_path: str
    status: str = "pending"  # pending | running | done | error
    prompt_mode: str = "prompt_layout_all_en"
    retry_attempts: int = 0
    error: Optional[str] = None
    artifacts: Dict[str, Any] = field(default_factory=dict)
    export_path: Optional[str] = None
    submitted_at: float = field(default_factory=time.time)
    finished_at: Optional[float] = None
    # In-browser edits: {"page{N}.{md|json}": path under edited/}. Exports
    # prefer these over the original artifacts (reference batch console's
    # autosave-to-edited/ feature, demo_gradio_batch.py:857-927,1921-2031).
    edits: Dict[str, str] = field(default_factory=dict)


class BatchJobManager:
    """Task queue + worker pool over a parser factory."""

    def __init__(
        self,
        parser_factory: Callable[[], Any],
        output_dir: str = "./batch_output",
        max_concurrency: int = 6,
        manifest_path: Optional[str] = None,
        max_auto_retries: int = MAX_AUTO_RETRIES,
    ):
        self._parser_factory = parser_factory
        self.output_dir = output_dir
        self.manifest_path = manifest_path
        self.max_auto_retries = max_auto_retries

        self._lock = threading.Lock()
        self._results: Dict[str, BatchResult] = {}
        self._deleted: set = set()
        self._queue: "queue.Queue[BatchTask]" = queue.Queue()
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        self._max_concurrency = max_concurrency
        os.makedirs(output_dir, exist_ok=True)
        if manifest_path and os.path.exists(manifest_path):
            self._load_manifest()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._stop.clear()
        with self._lock:
            while len(self._workers) < self._max_concurrency:
                t = threading.Thread(target=self._worker_loop, daemon=True)
                t.start()
                self._workers.append(t)

    def stop(self, wait: bool = False) -> None:
        self._stop.set()
        if wait:
            for t in self._workers:
                t.join(timeout=5)
        self._workers = []

    def set_max_concurrency(self, n: int) -> None:
        """Resize the worker pool (restart pattern, demo_gradio_batch:1118-1163)."""
        self.stop()
        self._max_concurrency = max(1, int(n))
        self.start()

    # -- submission / control ------------------------------------------------

    def submit(self, input_path: str, **task_kwargs) -> str:
        rid = uuid.uuid4().hex[:8]
        task = BatchTask(rid=rid, input_path=input_path, **task_kwargs)
        result = BatchResult(
            rid=rid, input_path=input_path, prompt_mode=task.prompt_mode
        )
        with self._lock:
            self._results[rid] = result
            self._deleted.discard(rid)
        self._queue.put(task)
        self._persist()
        return rid

    def reparse(self, rid: str, **overrides) -> Optional[str]:
        """Re-run a finished/errored task (same rid), optionally with new
        options (demo_gradio_batch:1254-1341)."""
        with self._lock:
            result = self._results.get(rid)
            if result is None:
                return None
            result.status = "pending"
            result.error = None
            result.retry_attempts = 0
            task = BatchTask(
                rid=rid,
                input_path=result.input_path,
                prompt_mode=overrides.get("prompt_mode", result.prompt_mode),
                **{k: v for k, v in overrides.items() if k != "prompt_mode"},
            )
        self._queue.put(task)
        return rid

    def delete(self, rid: str) -> None:
        """Remove a result; pending queue entries are purged lazily
        (demo_gradio_batch:300-313)."""
        with self._lock:
            self._results.pop(rid, None)
            self._deleted.add(rid)
        self._persist()

    def result(self, rid: str) -> Optional[BatchResult]:
        with self._lock:
            return self._results.get(rid)

    def results(self) -> List[BatchResult]:
        with self._lock:
            return list(self._results.values())

    def progress(self) -> Dict[str, int]:
        """Live counts for the 1 Hz UI poll (demo_gradio_batch:2637-2700)."""
        counts = {"pending": 0, "running": 0, "done": 0, "error": 0}
        with self._lock:
            for r in self._results.values():
                counts[r.status] = counts.get(r.status, 0) + 1
        counts["total"] = sum(counts.values())
        return counts

    def wait_all(self, timeout: float = 600.0, poll: float = 0.05) -> bool:
        """Block until nothing is pending/running. Returns False on timeout."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            p = self.progress()
            if p["pending"] == 0 and p["running"] == 0:
                return True
            time.sleep(poll)
        return False

    # -- worker -----------------------------------------------------------

    def _worker_loop(self) -> None:
        parser = None
        while not self._stop.is_set():
            try:
                task = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            with self._lock:
                if task.rid in self._deleted or task.rid not in self._results:
                    continue
                result = self._results[task.rid]
                result.status = "running"
            try:
                if parser is None:
                    parser = self._parser_factory()
                page_results = parser.parse_file(
                    task.input_path,
                    output_dir=self.output_dir,
                    prompt_mode=task.prompt_mode,
                    fitz_preprocess=task.fitz_preprocess,
                    custom_prompt=task.custom_prompt,
                    temperature=task.temperature,
                )
                if not page_results:
                    raise RuntimeError("no results returned from parser")
                export = self._build_export_zip(task.rid, page_results)
                with self._lock:
                    if task.rid in self._deleted:
                        continue
                    result.status = "done"
                    result.artifacts = {"pages": page_results}
                    result.export_path = export
                    result.finished_at = time.time()
                self._persist()
            except Exception as e:  # noqa: BLE001
                self._handle_failure(task, e)

    def _handle_failure(self, task: BatchTask, exc: Exception) -> None:
        with self._lock:
            result = self._results.get(task.rid)
            if result is None:
                return
            if (
                is_transient_backend_error(exc)
                and result.retry_attempts < self.max_auto_retries
            ):
                result.retry_attempts += 1
                result.status = "pending"
                delay = min(
                    RETRY_DELAY_CAP_S, RETRY_BACKOFF_BASE ** (result.retry_attempts - 1)
                )
                threading.Timer(delay, lambda: self._queue.put(task)).start()
                logger.info(
                    "transient failure on %s (attempt %d), retrying in %.1fs: %s",
                    task.rid, result.retry_attempts, delay, exc,
                )
                return
            result.status = "error"
            result.error = classify_parse_failure(exc, task.min_pixels, task.max_pixels)
            result.finished_at = time.time()
        self._persist()

    # -- exports / persistence ------------------------------------------------

    # -- per-result editing (autosave to edited/, edited-aware exports) ----

    _EDIT_ARTIFACT_KEY = {"md": "md_content_path", "json": "layout_info_path"}

    def save_edit(self, rid: str, page_no: int, kind: str, content: str) -> str:
        """Persist an edited markdown/JSON pane for one page of a result.

        Writes ``output_dir/edited/{rid}_page{page_no}.{kind}``, records it
        on the result, and persists the manifest so edits survive restarts.
        Returns the saved path.
        """
        if kind not in self._EDIT_ARTIFACT_KEY:
            raise ValueError(f"kind must be md|json, got {kind!r}")
        with self._lock:
            result = self._results.get(rid)
        if result is None:
            raise KeyError(rid)
        edited_dir = os.path.join(self.output_dir, "edited")
        os.makedirs(edited_dir, exist_ok=True)
        path = os.path.join(edited_dir, f"{rid}_page{page_no}.{kind}")
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(content)
        os.replace(tmp, path)
        with self._lock:
            result.edits[f"page{page_no}.{kind}"] = path
            done_pages = (
                result.artifacts.get("pages")
                if result.status == "done" else None
            )
        if done_pages:
            # Keep the pre-built export fresh: downloads after an edit must
            # carry the edited content.
            result.export_path = self._build_export_zip(rid, done_pages)
        self._persist()
        return path

    def edited_path(self, rid: str, page_no: int, kind: str) -> Optional[str]:
        with self._lock:
            result = self._results.get(rid)
            if result is None:
                return None
            return result.edits.get(f"page{page_no}.{kind}")

    def get_content(self, rid: str, page_no: int, kind: str):
        """(content, was_edited) for a page's md/json — the edited version
        when one exists, else the original artifact."""
        path = self.edited_path(rid, page_no, kind)
        edited = path is not None and os.path.exists(path)
        if not edited:
            with self._lock:
                result = self._results.get(rid)
            if result is None:
                return None, False
            pages = result.artifacts.get("pages", [])
            if page_no >= len(pages):
                return None, False
            path = pages[page_no].get(self._EDIT_ARTIFACT_KEY[kind])
        if not path or not os.path.exists(path):
            return None, edited
        with open(path, encoding="utf-8") as f:
            return f.read(), edited

    def _export_path_for(
        self, result: "BatchResult | None", page_no: int, key: str, path: str
    ) -> str:
        """Edited-aware source path: exports carry the edited content under
        the ORIGINAL artifact's name."""
        if result is None:
            return path
        kind = {"md_content_path": "md", "layout_info_path": "json"}.get(key)
        if kind is None:
            return path
        edited = result.edits.get(f"page{page_no}.{kind}")
        if edited and os.path.exists(edited):
            return edited
        return path

    def _build_export_zip(self, rid: str, page_results: List[dict]) -> str:
        with self._lock:
            result = self._results.get(rid)
        zip_path = os.path.join(self.output_dir, f"{rid}_export.zip")
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            for page_no, page in enumerate(page_results):
                for key in (
                    "layout_info_path",
                    "layout_image_path",
                    "md_content_path",
                    "md_content_nohf_path",
                ):
                    path = page.get(key)
                    if path and os.path.exists(path):
                        src = self._export_path_for(result, page_no, key, path)
                        zf.write(src, arcname=os.path.basename(path))
        return zip_path

    def export_all_zip(self, dest: Optional[str] = None) -> str:
        """One zip of every finished result's artifacts (edited-aware)."""
        dest = dest or os.path.join(self.output_dir, "all_results.zip")
        with zipfile.ZipFile(dest, "w", zipfile.ZIP_DEFLATED) as zf:
            for r in self.results():
                if r.status != "done":
                    continue
                for page_no, page in enumerate(r.artifacts.get("pages", [])):
                    for key in ("layout_info_path", "md_content_path",
                                "md_content_nohf_path", "layout_image_path"):
                        path = page.get(key)
                        if path and os.path.exists(path):
                            src = self._export_path_for(r, page_no, key, path)
                            zf.write(src, arcname=f"{r.rid}/{os.path.basename(path)}")
        return dest

    def _persist(self) -> None:
        if not self.manifest_path:
            return
        try:
            # Snapshot AND write under the lock: two persists racing must
            # not let a stale snapshot land last. Write-temp + rename keeps
            # the manifest atomic against crashes.
            with self._lock:
                rows = [asdict(r) for r in self._results.values()]
                tmp = self.manifest_path + ".tmp"
                with open(tmp, "w", encoding="utf-8") as f:
                    for row in rows:
                        f.write(json.dumps(row, ensure_ascii=False) + "\n")
                os.replace(tmp, self.manifest_path)
        except Exception:  # noqa: BLE001
            logger.exception("manifest persist failed")

    def _load_manifest(self) -> None:
        try:
            with open(self.manifest_path, encoding="utf-8") as f:
                for line in f:
                    if not line.strip():
                        continue
                    row = json.loads(line)
                    result = BatchResult(**row)
                    if result.status == "running":
                        result.status = "error"
                        result.error = "interrupted by restart"
                    self._results[result.rid] = result
        except Exception:  # noqa: BLE001
            logger.exception("manifest load failed")
