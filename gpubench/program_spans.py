"""Readers of what the program records about itself: each request's
``timing()`` (the worker's reply, ``Request.result["timing"]``) and the
spans of ``dots_ocr_tpu_torch.utils.observability.SPANS``, which the engine
thread and the preprocessing threads record while a torch profiler runs
(in a traced run, the benchmark's own ``DeviceTrace``), on the clock of
the trace's device records.

A program that records none of these (an older one) leaves every reader
here None: the metric drops out of the line.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from gpubench import work
from gpubench.record import FLASH, PAGED, median

Interval = Tuple[float, float]

# The engine thread's spans the idle metrics put the device's idle time down to
# (an admission's launches too: one in progress at the trace's start is recorded
# where its admit is not).
ADMIT = ("admit", "encode", "prefill", "prefill_chunk")
DECODE = ("decode",)


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from dots_ocr_tpu_torch.utils import observability
    except ImportError:
        return None
    return getattr(observability, "SPANS", None)


# -- per-request stamps -----------------------------------------------------------

def _timings(run) -> List[dict]:
    """``timing()`` of the requests due in the window's host part that
    carry the preprocessing split."""
    a, b = run.host_part()
    out = []
    for r in run.requests:
        t = (r.result or {}).get("timing") or {}
        if a <= r.due < b and "prep_ms" in t:
            out.append(t)
    return out


def prep_ms(run) -> Optional[float]:
    """Median receipt to preprocessed: the prep pool's queue and its work."""
    return median([t["prep_wait_ms"] + t["prep_ms"] for t in _timings(run)])


def engine_wait_ms(run) -> Optional[float]:
    """Median preprocessed to the engine's submit: the worker's queue while
    the engine thread is inside a step."""
    return median([t["engine_wait_ms"] for t in _timings(run)])


# -- spans over the traced part ------------------------------------------------------

def traced_part(run) -> Optional[Interval]:
    """(start, end) ns of the traced part on the trace clock, its monotonic
    start placed by the recorder."""
    rec = recorder()
    if run.trace is None or run.trace_edges is None or rec is None:
        return None
    start = rec.trace_ns(run.trace_edges[0])
    return float(start), start + run.trace.window_s * 1e9


def spans_in(run) -> Optional[list]:
    """The program's spans that overlap the traced part (None where the
    program recorded none there)."""
    part = traced_part(run)
    if part is None:
        return None
    a, b = part
    spans = [s for s in recorder().spans() if s.end_ns > a and s.start_ns < b]
    return spans or None


def union(intervals: Iterable[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def overlap(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The intersection of two sorted unions."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """xs without ys (both sorted unions), in one sweep."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b and a < b:
            c, d = ys[k]
            if c > a:
                out.append((a, c))
            a = max(a, d)
            k += 1
        if b > a:
            out.append((a, b))
    return out


def length(xs: List[Interval]) -> float:
    return sum(b - a for a, b in xs)


def idle(run, part: Interval) -> List[Interval]:
    """Stretches of the traced part with no device record running."""
    a, b = part
    busy = union((max(a, s * 1e3), min(b, e * 1e3)) for _, s, e in run.trace.kernels)
    return minus([(a, b)], busy)


def idle_split(run) -> Optional[Dict[str, float]]:
    """The device's idle time of the traced part, in ns, put down to what
    the engine thread was inside, innermost first: ``admit`` (admission or
    a prefill chunk), ``decode``, ``step`` (the rest of a step), ``tick``
    (the rest of the loop: gather, submit), then ``prepare`` (only a
    preprocessing thread inside a span) and ``none``."""
    spans = spans_in(run)
    if spans is None:
        return None
    part = traced_part(run)
    left = idle(run, part)
    out = {}
    for key, names in (("admit", ADMIT), ("decode", DECODE), ("step", ("step",)),
                       ("tick", ("tick",)), ("prepare", ("prepare",))):
        inside = overlap(left, union((s.start_ns, s.end_ns) for s in spans if s.name in names))
        out[key] = length(inside)
        left = minus(left, inside)
    out["none"] = length(left)
    return out


def _idle_share(run, key: str) -> Optional[float]:
    split = idle_split(run)
    if split is None or run.trace.window_s <= 0:
        return None
    return 100.0 * split[key] / (run.trace.window_s * 1e9)


def idle_admit_share(run) -> Optional[float]:
    """Share of the traced part with nothing on the device while the engine
    thread admits (or runs a prefill chunk)."""
    return _idle_share(run, "admit")


def idle_decode_share(run) -> Optional[float]:
    """The same, while the engine thread is inside a decode chunk's
    bookkeeping (inputs, dispatch, fetch wait, apply)."""
    return _idle_share(run, "decode")


# -- kernels -------------------------------------------------------------------------

def paged_attn_roofline(run) -> Optional[float]:
    """Kernel 2's bytes over its device seconds: the context tokens a launch
    reads (the program's count on the ``apply`` spans of chunks dispatched
    inside the traced part, over their iterations), times the trace's
    launches, times one layer's K and V bytes a token."""
    spans = spans_in(run)
    if spans is None:
        return None
    launches, _ = run.trace.by_name(PAGED[0])
    _, device_s = run.trace.by_name(*PAGED)
    a, b = traced_part(run)
    by_id = {s.id: s for s in recorder().spans()}
    tokens = iterations = 0
    for s in spans:
        cause = by_id.get(s.parent)
        if (s.name == "apply" and "kv_tokens" in s.work and cause is not None
                and cause.name == "dispatch" and a <= cause.start_ns < b):
            tokens += s.work["kv_tokens"]
            iterations += s.work["iterations"]
    if launches == 0 or iterations == 0:
        return None
    per_layer = work.kv_bytes_per_token(run.dims, run.serving["KV_DTYPE"]) / (
        run.dims["decoder"]["num_layers"])
    nbytes = tokens / iterations * launches * per_layer
    return work.share(nbytes / work.HBM_BYTES_PER_S, device_s)


def flash_bound(span, dims: dict) -> float:
    """Seconds of bound kernel 1's launches in a span carry: the encoder's
    image-wide calls, the prefill's causal ones (``RunRecord.span_work``'s
    sums, from the span's host integers)."""
    w = span.work
    bound = 0.0
    if "t" not in w and "patches" not in w:  # closed before its work was noted
        return bound
    if "patches" in w:
        ops, nbytes = work.flash_image_bound(w["patches"], w["t_vis"], dims)
        bound += dims["vision"]["num_layers"] * work.bound_s(ops, nbytes)
    if span.name == "prefill":
        t = w["t"]
        ops, nbytes = work.flash_causal_bound([(p, p) for p in w["prompt_lens"]], 0, t, t, dims)
        bound += dims["decoder"]["num_layers"] * work.bound_s(ops, nbytes)
    elif span.name == "prefill_chunk":
        off, chunk = w["q_offset"], w["t"]
        rows = [(max(0, min(chunk, p - off)), p) for p in w["prompt_lens"]]
        ops, nbytes = work.flash_causal_bound(rows, off, chunk, w["kv_hi"], dims)
        bound += dims["decoder"]["num_layers"] * work.bound_s(ops, nbytes)
    return bound


def flash_roofline_program(run) -> Optional[float]:
    """``flash_roofline``'s share, from the program's ``encode``,
    ``prefill`` and ``prefill_chunk`` spans and their event pairs."""
    rec = recorder()
    if run.trace is None or rec is None:
        return None
    n, device_s = run.trace.by_name(*FLASH)
    launching = [s for s in rec.spans() if s.name in ("encode", "prefill", "prefill_chunk")
                 and s.events is not None]
    if n == 0 or not launching:
        return None
    return work.share(sum(run.trace.overlap(s) * flash_bound(s, run.dims) for s in launching),
                      device_s)
