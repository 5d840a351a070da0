"""Sandboxed user-script engine for batch post-processing/exports.

Rebuild of the batch console's script system
(``demo/demo_gradio_batch.py:351-755``): users run a restricted Python
snippet against the finished batch results to build custom export bundles.
The sandbox exposes:

  * ``api`` — a :class:`ScriptAPI` over a snapshot of batch results
    (ids, status, markdown/JSON artifact contents),
  * ``export`` — an :class:`ExportBuilder` rooted in a private temp dir
    (relative paths only; traversal outside is stripped),
  * a whitelisted set of builtins (no imports, no IO primitives, no
    attribute escapes via ``__import__``/``open``/``eval``).

``run_user_script`` captures stdout and returns (zip_path_or_None, logs).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import tempfile
import zipfile
from contextlib import redirect_stderr, redirect_stdout
from typing import Dict, List, Optional, Tuple

_ALLOWED_BUILTINS = [
    "abs", "min", "max", "sum", "len", "range", "enumerate", "map",
    "filter", "zip", "list", "dict", "set", "tuple", "str", "int",
    "float", "bool", "print", "any", "all", "sorted", "repr", "round",
    "reversed", "isinstance",
]


def _safe_builtins() -> Dict[str, object]:
    import builtins

    return {k: getattr(builtins, k) for k in _ALLOWED_BUILTINS if hasattr(builtins, k)}


class ExportBuilder:
    """Builds a file tree under a private temp dir, finalized to one zip."""

    def __init__(self, name: Optional[str] = None):
        self.root_dir = tempfile.mkdtemp(prefix=f"{name or 'script_export'}_")
        self._final_zip: Optional[str] = None

    def _abspath(self, rel_path: str) -> str:
        rel_path = rel_path.lstrip("/\\")
        path = os.path.normpath(os.path.join(self.root_dir, rel_path))
        if not path.startswith(os.path.abspath(self.root_dir)):
            raise ValueError(f"path escapes export root: {rel_path}")
        return path

    def mkdir(self, rel_dir: str) -> str:
        p = self._abspath(rel_dir)
        os.makedirs(p, exist_ok=True)
        return p

    def add_text(self, rel_path: str, content, encoding: str = "utf-8") -> str:
        p = self._abspath(rel_path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "w", encoding=encoding) as f:
            f.write("" if content is None else str(content))
        return p

    def add_bytes(self, rel_path: str, data: bytes) -> str:
        p = self._abspath(rel_path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data or b"")
        return p

    def add_file(self, src_path: str, dest_rel_path: Optional[str] = None):
        if not src_path or not os.path.exists(src_path):
            return None
        dest_rel_path = dest_rel_path or os.path.basename(src_path)
        p = self._abspath(dest_rel_path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        shutil.copy2(src_path, p)
        return p

    def finalize(self, zip_name: Optional[str] = None) -> str:
        if self._final_zip and os.path.exists(self._final_zip):
            return self._final_zip
        zip_name = zip_name or "script_export.zip"
        zip_path = os.path.join(tempfile.mkdtemp(prefix="script_zip_"), zip_name)
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _, files in os.walk(self.root_dir):
                for name in files:
                    src = os.path.join(root, name)
                    zf.write(src, os.path.relpath(src, self.root_dir))
        self._final_zip = zip_path
        return zip_path


class ScriptAPI:
    """Read-only view over a snapshot of batch results."""

    def __init__(self, manager, ids_snapshot: Optional[List[str]] = None):
        self._manager = manager
        self._ids = list(
            ids_snapshot
            if ids_snapshot is not None
            else [r.rid for r in manager.results()]
        )

    def get_ids(self) -> List[str]:
        return list(self._ids)

    def get_status(self, rid: str) -> Dict:
        r = self._manager.result(rid)
        if r is None:
            return {"status": "missing"}
        return {
            "status": r.status,
            "input_path": r.input_path,
            "prompt_mode": r.prompt_mode,
            "error": r.error,
            "retry_attempts": r.retry_attempts,
        }

    def _page_paths(self, rid: str) -> List[Dict]:
        r = self._manager.result(rid)
        if r is None or r.status != "done":
            return []
        return r.artifacts.get("pages", [])

    def get_markdown(self, rid: str, nohf: bool = False) -> str:
        key = "md_content_nohf_path" if nohf else "md_content_path"
        parts = []
        for page in self._page_paths(rid):
            path = page.get(key)
            if path and os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    parts.append(f.read())
        return "\n\n".join(parts)

    def get_layout_json(self, rid: str) -> List:
        out = []
        for page in self._page_paths(rid):
            path = page.get("layout_info_path")
            if path and os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    out.append(json.load(f))
        return out

    def get_artifact_paths(self, rid: str) -> List[Dict]:
        return [dict(p) for p in self._page_paths(rid)]


def run_user_script(
    script_code: str, manager, ids_snapshot: Optional[List[str]] = None
) -> Tuple[Optional[str], str]:
    """Execute a user script in the sandbox. Returns (zip_path, logs).

    The script may call ``export.finalize()`` itself; otherwise, if it wrote
    any files through ``export``, finalize() runs automatically.
    """
    api = ScriptAPI(manager, ids_snapshot)
    export = ExportBuilder()
    sandbox_globals = {
        "__builtins__": _safe_builtins(),
        "api": api,
        "export": export,
        "json": json,  # data-only module, no IO surface
    }
    stdout = io.StringIO()
    try:
        with redirect_stdout(stdout), redirect_stderr(stdout):
            exec(compile(script_code, "<user_script>", "exec"), sandbox_globals)  # noqa: S102
    except Exception as e:  # noqa: BLE001
        return None, stdout.getvalue() + f"\nSCRIPT ERROR: {type(e).__name__}: {e}"

    zip_path = export._final_zip
    if zip_path is None:
        has_files = any(files for _, _, files in os.walk(export.root_dir))
        if has_files:
            zip_path = export.finalize()
    return zip_path, stdout.getvalue()
