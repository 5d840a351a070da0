"""The readers of ``program_spans.py`` on the CPU: the per-request split
from a tiny run's replies, the idle split and kernel 2's share from
hand-made spans and device records, kernel 1's bound from the program's
host integers equal to the benchmark's wrapper, and silence on a program
that records none of it. One card test: a span that launches a kernel and
synchronises holds that kernel on the device trace's axis.

    python -m pytest gpubench/tests/test_program_spans.py -q
"""

import json
import os

import numpy as np
import pytest
import torch

from gpubench import program_spans, run, work
from gpubench.record import Request, RunRecord
from gpubench.trace import DeviceTrace
from gpubench.trace import Span as WrapperSpan
from gpubench.tests.helpers import DATA, tiny_cell

from dots_ocr_tpu_torch.utils import observability

TINY = json.load(open(os.path.join(DATA, "configs", "tiny.json")))
DIMS, SERVING = TINY["model"], TINY["serving"]
ARCH = run.load_arch(TINY["arch"])


def _record(requests=(), trace=None, edges=None):
    return RunRecord(dims=DIMS, serving=SERVING, mix={}, t0=0.0, t1=10.0, counters0={},
                     counters1={}, requests=list(requests), arch=ARCH, trace=trace,
                     trace_edges=edges)


def _span(rec, name, a, b, parent=None, thread="engine", **work_):
    s = observability.Span(rec, name, None, parent)
    s.start_ns, s.end_ns, s.thread, s.tid = a, b, thread, 0
    s.work.update(work_)
    rec._buffer.append(s)
    return s


@pytest.fixture
def recorder(monkeypatch):
    """A recorder of hand-made spans whose trace clock is monotonic ns."""
    rec = observability.SpanRecorder()
    monkeypatch.setattr(rec, "trace_ns", lambda monotonic_s: int(round(monotonic_s * 1e9)))
    monkeypatch.setattr(program_spans, "recorder", lambda: rec)
    return rec


def _trace(kernels_ns, window_s):
    trace = DeviceTrace(torch.device("cpu"))
    trace.kernels = [(name, s / 1e3, e / 1e3) for name, s, e in kernels_ns]
    trace.window_s = window_s
    return trace


def test_the_split_before_admission_adds_up():
    out = run.run_cell(tiny_cell("tiny.snap-ocr"), 2**31 + 23, 1.0, False, "cpu")
    record = out["record"]
    assert out["correct"]
    a, b = record.host_part()
    due = [r for r in record.requests if a <= r.due < b and r.admitted_at is not None]
    assert due
    for r in due:
        t = r.result["timing"]
        parts = t["prep_wait_ms"] + t["prep_ms"] + t["engine_wait_ms"] + t["queue_ms"]
        assert abs(parts - (r.admitted_at - r.sent) * 1e3) < 1.0
    assert program_spans.prep_ms(record) > 0
    assert program_spans.engine_wait_ms(record) >= 0


def test_readers_are_silent_on_a_program_without_them(monkeypatch):
    # an older program's reply has no split, and its package no recorder
    old = Request(spec=None, due=1.0, result={"timing": {"queue_ms": 1.0, "ttft_ms": 2.0}})
    trace = _trace([("flash_fwd_kernel", 0, 10), ("paged_decode_split_kernel", 20, 30)], 1.0)
    record = _record([old], trace=trace, edges=(0.0, 1.0))
    monkeypatch.setattr(observability, "SPANS", None)
    for name in ("prep_ms", "engine_wait_ms", "idle_admit_share", "idle_decode_share",
                 "paged_attn_roofline", "flash_roofline_program"):
        assert getattr(program_spans, name)(record) is None, name


def test_interval_sweeps_match_a_grid():
    rng = np.random.default_rng(5)

    def draw(n):
        starts = rng.integers(0, 1000, n)
        return [(float(a), float(a + w)) for a, w in zip(starts, rng.integers(1, 60, n))]

    def grid(intervals):
        g = np.zeros(1100, bool)
        for a, b in intervals:
            g[int(a):int(b)] = True
        return g

    for _ in range(20):
        xs, ys = program_spans.union(draw(40)), program_spans.union(draw(40))
        gx, gy = grid(xs), grid(ys)
        assert (grid(program_spans.minus(xs, ys)) == (gx & ~gy)).all()
        assert (grid(program_spans.overlap(xs, ys)) == (gx & gy)).all()
        assert program_spans.length(program_spans.minus(xs, ys)) == (gx & ~gy).sum()


def test_idle_time_is_put_down_to_the_engine_threads_spans(recorder):
    ms = 1_000_000
    # the traced part: 0-100 ms; device busy 0-10, 30-40, 70-100
    trace = _trace([("k", 0, 10 * ms), ("k", 30 * ms, 40 * ms), ("k", 70 * ms, 100 * ms)], 0.1)
    tick = _span(recorder, "tick", 0, 100 * ms)
    step = _span(recorder, "step", 5 * ms, 90 * ms, parent=tick.id)
    _span(recorder, "admit", 5 * ms, 25 * ms, parent=step.id)        # idle 10-25
    _span(recorder, "decode", 35 * ms, 60 * ms, parent=step.id)      # idle 40-60
    _span(recorder, "prepare", 0, 100 * ms, thread="prep_0")
    record = _record(trace=trace, edges=(0.0, 0.1))
    split = program_spans.idle_split(record)
    assert split == {"admit": 15 * ms, "decode": 20 * ms, "step": 15 * ms, "tick": 0,
                     "prepare": 0, "none": 0}
    assert program_spans.idle_admit_share(record) == pytest.approx(15.0)
    assert program_spans.idle_decode_share(record) == pytest.approx(20.0)
    # what neither takes is the rest of idle_share: step (25-30, 60-70)
    assert 100.0 * (1 - trace.busy_s() / trace.window_s) == pytest.approx(15 + 20 + 15)


def test_kernel_2_share_from_the_programs_count(recorder):
    ms = 1_000_000
    layers = DIMS["decoder"]["num_layers"]
    # two chunks of 4 iterations dispatched inside the traced part, one before it
    kernels = [("paged_decode_split_kernel", i * ms, i * ms + 10_000) for i in range(8 * layers)]
    trace = _trace(kernels, 1.0)
    for start, tokens in ((-5 * ms, 10**9), (1 * ms, 400), (3 * ms, 800)):
        d = _span(recorder, "dispatch", start, start + ms)
        _span(recorder, "apply", start + 2 * ms, start + 3 * ms, parent=d.id,
              kv_tokens=tokens, iterations=4)
    record = _record(trace=trace, edges=(0.0, 1.0))
    per_token = ARCH.kv_bytes_per_token(DIMS, SERVING["KV_DTYPE"]) / layers
    want = 100.0 * (1200 / 8) * (8 * layers) * per_token / work.HBM_BYTES_PER_S / (
        8 * layers * 10e-6)
    assert program_spans.paged_attn_roofline(record) == pytest.approx(want)


def test_kernel_1_bound_equals_the_wrappers():
    """The program's host integers give RunRecord.span_work's sums."""
    record = _record()
    rec = observability.SpanRecorder()
    seg = np.array([0] * 40 + [1] * 24 + [-1] * 8, np.int32)
    work_ = {"patches": [40, 24], "t_vis": 72}
    cases = [
        (WrapperSpan("encode_program", {"segment_ids": torch.from_numpy(seg)}),
         _span(rec, "encode", 0, 1, **work_)),
        (WrapperSpan("prefill_program", {"rows": (2, 64), "seq_lens": torch.tensor([50, 33]),
                                         "segment_ids": torch.from_numpy(seg)}),
         _span(rec, "prefill", 0, 1, rows=2, t=64, prompt_lens=[50, 33], **work_)),
        (WrapperSpan("prefill_extend_program", {"rows": (2, 32), "prompt_len": torch.tensor(
            [70, 40]), "kv_hi": 64, "q_offset": 32}),
         _span(rec, "prefill_chunk", 0, 1, rows=2, t=32, q_offset=32, kv_hi=64,
               prompt_lens=[70, 40])),
    ]
    for wrapper, span in cases:
        want = record.span_work(wrapper)["flash"]
        assert want > 0 and program_spans.flash_bound(span, DIMS) == pytest.approx(want)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the span's kernel is read from the device trace")


@pytest.mark.cuda
def test_a_launching_span_holds_its_kernel_on_the_trace_axis(card):
    dev = torch.device("cuda")
    a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    trace = DeviceTrace(dev)
    trace.warm()
    rec = observability.SpanRecorder()
    trace.start()
    with rec("launch", device=dev) as span:
        a @ a
        torch.cuda.synchronize()
    trace.stop()
    long = [(s, e) for name, s, e in trace.kernels if e - s > 20.0]  # us
    assert len(long) == 1
    start_us, end_us = long[0]
    assert span.start_ns / 1e3 <= start_us < end_us <= span.end_ns / 1e3
    assert trace.overlap(span) == 1.0

    # a whole span: its event pair is reused while no profiler runs, and the
    # one in progress when the trace starts is kept with its events
    with rec.whole("prefill", device=dev) as dropped:
        a @ a
    with rec.whole("prefill", device=dev) as head:
        assert head.events is dropped.events
        for _ in range(8):
            a @ a
        trace.start()
        a @ a
        torch.cuda.synchronize()
    trace.stop()
    assert rec.spans()[-1] is head and dropped not in rec.spans()
    assert 0.0 < trace.overlap(head) < 1.0
