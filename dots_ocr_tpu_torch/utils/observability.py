"""Observability: structured logging, the program's spans, profiling.

  * ``setup_logging`` — structured (logfmt-ish) root logging config,
  * ``SPANS`` — the process's :class:`SpanRecorder`: the engine thread and
    the preprocessing threads open a span at each layer boundary (the tree
    is in README.md, "Tracing and request timing"), recorded only while a
    ``torch.profiler`` runs. With no profiler running a site reads one flag
    and records nothing (the engine loop's ``tick`` and the eager launches
    ``encode``, ``prefill`` and ``prefill_chunk`` open whole:
    :meth:`SpanRecorder.whole`),
  * ``profile_trace`` — a torch.profiler trace (host and CUDA activity)
    around a block, written as a Chrome trace into a directory, the
    program's spans merged in on the kernels' time axis.

Span stamps are ``time.time_ns()``, the clock kineto stamps its host and
device records with (checked on an H100 under torch 2.11+cu128: a kernel
launched and synchronised inside a span lies inside it), so a span and
the device trace of the same run share one axis.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from torch.autograd import profiler as _profiler

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


class _NoSpan:
    """What a span site gets while no profiler runs: a context manager that
    records nothing, false as a condition, whose :meth:`note` does nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def note(self, reqs=None, **work) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """One recorded interval of a host thread: ``name``, ``start_ns`` and
    ``end_ns`` on the trace clock, the thread (``thread`` its name, ``tid``
    its native id), ``parent`` (the id of the span that caused it: the one
    open on its thread, or one named at the site), the request ids it
    concerns (``reqs``), its work as host integers (``work``), and for a
    span that launches device work a CUDA event pair (``events``) recorded
    at its start and end on the current stream. ``whole``: opened by
    :meth:`SpanRecorder.whole`."""

    __slots__ = ("recorder", "id", "name", "start_ns", "end_ns", "thread", "tid", "parent",
                 "reqs", "work", "events", "whole")

    def __init__(self, recorder: "SpanRecorder", name: str, device, cause: Optional[int],
                 whole: bool = False):
        self.recorder, self.name, self.parent, self.whole = recorder, name, cause, whole
        self.id = next(recorder._ids)
        self.reqs: Tuple[int, ...] = ()
        self.work: Dict[str, object] = {}
        self.end_ns = 0
        self.events = None
        if device is not None and device.type == "cuda":
            self.events = recorder._spare.pop(name, None) if whole else None
            if self.events is None:
                import torch

                self.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))

    def note(self, reqs=None, **work) -> None:
        if reqs is not None:
            self.reqs = tuple(int(r) for r in reqs)
        self.work.update(work)

    def __enter__(self) -> "Span":
        local = self.recorder._thread()
        stack = local.stack
        if self.parent is None and stack:
            self.parent = stack[-1].id
        stack.append(self)
        self.thread, self.tid = local.name, local.tid
        if self.events is not None:
            self.events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        stack = self.recorder._thread().stack
        if stack and stack[-1] is self:
            stack.pop()
        if not self.whole or _profiler._is_profiler_enabled:
            self.recorder._buffer.append(self)
        elif self.events is not None:
            self.recorder._spare[self.name] = self.events  # the next such span records them
        return False

    def __bool__(self) -> bool:
        """Whether the span is being recorded: a site notes its work only
        then (a whole span opened with no profiler running is not)."""
        return not self.whole or _profiler._is_profiler_enabled


class SpanRecorder:
    """Spans of the program's host threads, recorded while a torch profiler
    runs (``torch.autograd.profiler._is_profiler_enabled``, which the
    profiler sets at its start and clears at its stop) and kept in memory,
    the newest ``capacity``, until read.

    ``recorder(name, device=None, cause=None)`` is a span site: a context
    manager yielding the :class:`Span` (``NO_SPAN`` with no profiler
    running). ``device``: the device a launching span records its event
    pair on; ``cause``: the id of the span that caused this one, where that
    is not the span open on this thread."""

    def __init__(self, capacity: int = 1 << 16):
        self._buffer: "collections.deque[Span]" = collections.deque(maxlen=capacity)
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._spare: Dict[str, Tuple] = {}  # event pairs of whole spans not kept, by name

    def __call__(self, name: str, device=None, cause: Optional[int] = None):
        if not _profiler._is_profiler_enabled:
            return NO_SPAN
        return Span(self, name, device, cause)

    def whole(self, name: str, device=None) -> Span:
        """A span site that opens whether or not a profiler runs, the span
        kept if one runs when it closes: the span in progress when a
        profiler starts is recorded whole. The engine thread's ``tick``
        opens so (the traced part then has no head outside every span), and
        so do the eager launches of kernel 1 (``encode``, ``prefill``,
        ``prefill_chunk``), whose device work lags their host span: one in
        progress at the trace's start runs on the device inside it. With no
        profiler running such a site costs a clock read, a few attribute
        writes and, on the card, an event pair recorded (the pair is reused
        until a span is kept)."""
        return Span(self, name, device, None, whole=True)

    def _thread(self) -> threading.local:
        """This thread's open spans (``stack``), ``name`` and ``tid``."""
        local = self._local
        if not hasattr(local, "stack"):
            local.stack = []
            local.name, local.tid = threading.current_thread().name, threading.get_native_id()
        return local

    def spans(self, since_ns: int = 0) -> List[Span]:
        """The closed spans that ended at or after ``since_ns``, in the
        order they ended."""
        return [s for s in list(self._buffer) if s.end_ns >= since_ns]

    @staticmethod
    def trace_ns(monotonic_s: float) -> int:
        """A ``time.monotonic()`` stamp on the trace clock, by the two
        clocks' offset at this call (read within seconds of the stamp; a
        step of the wall clock in between would misplace it)."""
        return int(round(monotonic_s * 1e9)) + time.time_ns() - time.monotonic_ns()

    def clear(self) -> None:
        self._buffer.clear()


SPANS = SpanRecorder()


def chrome_events(spans: List[Span], base_ns: int, pid: int) -> List[dict]:
    """The spans as Chrome trace complete events ("X"), their ``ts`` in
    microseconds after ``base_ns`` (the trace's ``baseTimeNanoseconds``)."""
    out = []
    for s in spans:
        out.append({
            "ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": s.tid,
            "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"id": s.id, "parent": s.parent, "thread": s.thread, "reqs": list(s.reqs),
                     **s.work},
        })
    return out


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace around a block, written to
    ``log_dir/trace_<pid>_<ns>.json`` (Chrome trace format; CUDA activity
    when a card is present), with the program's spans of the block (host
    threads, category ``program_span``) on the same axis as the kernels.
    A no-op when log_dir is None."""
    if not log_dir:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    begin = time.time_ns()
    with torch.profiler.profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path, encoding="utf-8") as f:
        trace = json.load(f)
    base = int(trace.get("baseTimeNanoseconds", 0))
    trace["traceEvents"] += chrome_events(SPANS.spans(since_ns=begin), base, os.getpid())
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
