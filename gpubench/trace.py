"""Device traces and spans of a traced run (``--trace 1``).

* :class:`DeviceTrace` runs ``torch.profiler`` (CUDA activity only) over
  part of the window and reduces its device records: time and launches by
  kernel name, the union of busy intervals, the idle gaps.
* :class:`Spans` records spans from the benchmark's side around the
  program's eager prefill entries (the functions its scheduler calls by
  module name), with CUDA events at both ends and the arguments' shapes,
  so that a kernel's work inside the traced part is counted from shapes.
  A name the program no longer has is skipped, and the metrics that read
  it fall silent.

Events recorded on the default stream at the profiler's start and stop
bracket exactly the work launched while it ran, which is what the trace
holds: a span counts by the share of its device time between them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# The program's eager entries that launch kernel 1 and the prefill linears.
SPANNED = ("encode_program", "prefill_extend_program", "prefill_program")


@dataclasses.dataclass
class Span:
    name: str
    args: Dict[str, Any]
    events: Optional[Tuple[Any, Any]] = None


class Spans:
    def __init__(self, module, device: torch.device):
        self.module, self.device = module, device
        self.records: List[Span] = []
        self._saved: Dict[str, Callable] = {}

    def __enter__(self):
        for name in SPANNED:
            fn = getattr(self.module, name, None)
            if fn is not None:
                self._saved[name] = fn
                setattr(self.module, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.module, name, fn)
        self._saved.clear()

    def _wrap(self, name: str, fn: Callable) -> Callable:
        cuda = self.device.type == "cuda"

        def spanned(*args, **kwargs):
            ev = None
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            out = fn(*args, **kwargs)
            if cuda:
                ev[1].record()
            self.records.append(Span(name, _shapes(name, args, kwargs), ev))
            return out

        return spanned


def _shapes(name: str, args, kwargs) -> Dict[str, Any]:
    """The arguments a span's work is counted from (device tensors are kept
    and read after the window)."""
    if name == "encode_program":
        return {"segment_ids": args[4] if len(args) > 4 else kwargs["segment_ids"]}
    if name == "prefill_extend_program":
        embeds = args[3]
        return {"rows": tuple(embeds.shape[:2]), "prompt_len": args[4],
                "kv_hi": kwargs["kv_hi"], "q_offset": kwargs["q_offset"]}
    return {"rows": tuple(args[3].shape), "seq_lens": args[4],
            "segment_ids": kwargs.get("segment_ids")}


def image_sizes(segment_ids: torch.Tensor) -> List[int]:
    """Patches of each image in a packed encoder call (-1 is padding)."""
    seg = segment_ids.detach().to("cpu").long()
    seg = seg[seg >= 0]
    return torch.bincount(seg).tolist() if seg.numel() else []


class DeviceTrace:
    """torch.profiler over [start(), stop()] on ``device``."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.marks: Optional[Tuple[Any, Any]] = None
        self.window_s = 0.0
        self.stopped_at = 0.0
        self.kernels: List[Tuple[str, float, float]] = []  # (name, start us, end us)

    def warm(self):
        """Start and stop the profiler once, so that its first start (CUPTI's
        set-up, seconds) falls in set-up and not in the window."""
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.marks = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        self.marks[0].record()
        self._t0 = time.perf_counter()

    def stop(self):
        """End the trace without waiting for the device as a whole (the
        engine thread keeps launching): wait for the end mark alone, then
        read the profiler's raw device records."""
        self.marks[1].record()
        self.window_s = time.perf_counter() - self._t0
        self.stopped_at = time.monotonic()
        self.marks[1].synchronize()
        inner = self.prof.profiler
        inner.use_device = None  # no device-wide synchronize while the engine runs
        inner.__exit__(None, None, None)
        for e in inner.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CPU:
                continue
            start = e.start_ns() * 1e-3
            end = start + e.duration_ns() * 1e-3
            if end > start:
                self.kernels.append((e.name(), start, end))
        self.kernels.sort(key=lambda k: k[1])
        self.prof = None

    def overlap(self, span: Span) -> float:
        """The share of a span's device time inside the traced part."""
        if span.events is None or self.marks is None:
            return 0.0
        s = self.marks[0].elapsed_time(span.events[0])
        e = self.marks[0].elapsed_time(span.events[1])
        end = self.marks[0].elapsed_time(self.marks[1])
        if e <= s:
            return 1.0 if 0.0 <= s <= end else 0.0
        return max(0.0, min(e, end) - max(s, 0.0)) / (e - s)

    # -- reductions --------------------------------------------------------------

    def by_name(self, *needles: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds any of
        ``needles``."""
        n, us = 0, 0.0
        for name, s, e in self.kernels:
            if any(k in name for k in needles):
                n += 1
                us += e - s
        return n, us * 1e-6

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        busy, hi = 0.0, None
        for _, s, e in self.kernels:
            if hi is None or s > hi:
                busy += e - s
                hi = e
            elif e > hi:
                busy += e - hi
                hi = e
        return busy * 1e-6

    def top_ops(self, n: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for name, s, e in self.kernels:
            by_name[name] = by_name.get(name, 0.0) + (e - s)
        total: Dict[str, float] = {}
        for name, us in by_name.items():
            total[short(name)] = total.get(short(name), 0.0) + us * 1e-6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest stretches with nothing on the device, each named by
        the operation the device ran next (what the host was launching)."""
        gaps, hi = [], None
        for name, s, e in self.kernels:
            if hi is not None and s > hi:
                gaps.append([f"before {short(name)}", (s - hi) * 1e-6])
            hi = e if hi is None else max(hi, e)
        return sorted(gaps, key=lambda g: -g[1])[:n]


def short(name: str) -> str:
    """A kernel's name without its return type, namespace marks, template
    arguments and signature."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[len("void "):]
    base = base.split("(")[0].split("<")[0].strip()
    return base[:96] or name[:96]
