"""Observability: structured logging, per-request phase timing, profiling.

The reference has print()-based logging only and no tracing (SURVEY.md
§5.1/§5.5). Here:

  * ``setup_logging`` — structured (logfmt-ish) root logging config,
  * ``PhaseTimer`` — context-managed phase timing (rasterize / preprocess /
    prefill / decode / postprocess) that the parser and engines attach to
    results and metrics endpoints,
  * ``profile_trace`` — a torch.profiler trace (host and CUDA activity)
    around a block, written as a Chrome trace into a directory.

A copy of ``dots_ocr_tpu.utils.observability`` with ``profile_trace`` on
``torch.profiler`` in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional

logger = logging.getLogger("dots_ocr_tpu_torch")


def setup_logging(level: int = logging.INFO) -> None:
    """Configure structured-ish stdlib logging once."""
    root = logging.getLogger()
    if any(getattr(h, "_dots_ocr", False) for h in root.handlers):
        return
    handler = logging.StreamHandler()
    handler._dots_ocr = True  # type: ignore[attr-defined]
    handler.setFormatter(
        logging.Formatter(
            "ts=%(asctime)s level=%(levelname)s logger=%(name)s msg=%(message)s",
            datefmt="%Y-%m-%dT%H:%M:%S",
        )
    )
    root.addHandler(handler)
    root.setLevel(level)


@dataclass
class PhaseTimer:
    """Accumulates named phase durations for one request."""

    phases: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def as_dict(self) -> Dict[str, float]:
        return {k: round(v, 4) for k, v in self.phases.items()}

    def log(self, request_id: str = "-") -> None:
        parts = " ".join(f"{k}={v:.3f}s" for k, v in self.phases.items())
        logger.info("request=%s %s", request_id, parts)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace around a block, written to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format; CUDA activity
    when a card is present). A no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
