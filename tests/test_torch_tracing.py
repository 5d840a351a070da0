"""The port's own tracing, on the CPU (tiny config): the span recorder of
``utils/observability.py`` as the engine thread and the preprocessing
threads feed it, the per-request stamps behind ``timing()``, kernel 2's
context-token counter, ``/metrics`` and ``profile_trace``.

Spans are recorded only while a torch profiler runs; a CPU profiler
stands in here for the benchmark's CUDA one (the same flag gates both)."""

import asyncio
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from dots_ocr_tpu_torch.engine import scheduler
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import init_params
from dots_ocr_tpu_torch.serve import async_engine
from dots_ocr_tpu_torch.serve.async_engine import EngineWorker, Submission
from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer
from dots_ocr_tpu_torch.utils import observability
from dots_ocr_tpu_torch.utils.observability import SPANS

CPU = torch.device("cpu")
SCHED = dict(num_pages=64, page_size=8, max_slots=4, max_pages_per_seq=16,
             prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=4,
             max_steps_per_sync=4, repetition_min_repeats=0)
IMAGE = Image.fromarray(np.random.RandomState(0).randint(0, 255, (56, 84, 3), np.uint8))


@pytest.fixture(scope="module")
def params():
    torch.set_num_threads(2)
    cfg = DotsOCRConfig.tiny()
    return init_params(cfg, CPU, torch.Generator().manual_seed(0))


@pytest.fixture(autouse=True)
def empty_recorder():
    SPANS.clear()
    yield
    SPANS.clear()


def _engine(params, **sched):
    return ContinuousBatchingEngine(params, DotsOCRConfig.tiny(), CPU,
                                    sched=SchedulerConfig(**{**SCHED, **sched}),
                                    default_max_new_tokens=6)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_span_is_recorded_without_a_profiler(params):
    eng = _engine(params)
    eng.submit("hello", images=[IMAGE], max_new_tokens=6, temperature=0.0)
    eng.run()
    assert SPANS.spans() == []
    assert SPANS("step") is observability.NO_SPAN
    with SPANS("step") as span:
        span.note(reqs=[1], rows=2)
        assert not span


def test_one_step_records_the_span_tree(params):
    eng = _engine(params, speculate_k=2, spec_min_tokens_per_iter=0.0, pipeline_decode=False)
    rids = [eng.submit("read this", images=[IMAGE], max_new_tokens=12, temperature=0.0),
            eng.submit("and this", max_new_tokens=12, temperature=0.0)]
    with _cpu_profile():
        eng.step()
    spans = SPANS.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == {"step", "admit", "prepare_batch", "prefill", "first_fetch",
                            "decode", "inputs", "dispatch", "fetch_wait", "apply"}
    by_id = {s.id: s for s in spans}

    def parent(s):
        return by_id[s.parent].name

    (step,) = by_name["step"]
    assert step.parent is None and step.thread == "MainThread"
    for name in ("admit", "decode"):
        assert [parent(s) for s in by_name[name]] == ["step"]
    for name in ("prepare_batch", "prefill", "first_fetch"):
        assert [parent(s) for s in by_name[name]] == ["admit"]
    for name in ("inputs", "dispatch", "fetch_wait"):
        assert [parent(s) for s in by_name[name]] == ["decode"]
    (dispatch,), (apply,) = by_name["dispatch"], by_name["apply"]
    assert apply.parent == dispatch.id  # the chunk's apply names its dispatch
    (admit,), (prefill,) = by_name["admit"], by_name["prefill"]
    assert admit.reqs == prefill.reqs == tuple(rids) and apply.reqs == tuple(rids)
    # work as host integers
    assert prefill.work["rows"] == 2 and len(prefill.work["prompt_lens"]) == 2
    assert prefill.work["patches"] and prefill.work["t_vis"] >= sum(prefill.work["patches"])
    assert dispatch.work == {"rows": 2, "iterations": 4, "spec_k": 2}
    assert apply.work["kv_tokens"] == eng.metrics["kv_tokens_read"] > 0
    # nesting holds on the clock
    for s in spans:
        if s.parent is not None and s.name != "apply":
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert all(s.events is None for s in spans)  # event pairs only on the card


def test_a_span_contains_the_kineto_record_of_its_op():
    """Span stamps and the profiler's records share one clock."""
    a = torch.ones(256, 256)
    with _cpu_profile() as prof:
        with SPANS("matmul") as span:
            a @ a
    (mm,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert span.start_ns <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= span.end_ns
    # the clocks' offset places monotonic stamps
    now = time.monotonic()
    assert abs(SPANS.trace_ns(now) - time.time_ns()) < 5e6


def _hand_count(eng, step):
    """kv_tokens_read over one step against the paged kernel's seq_lens
    from the host's positions: a row at position L live for n iterations
    reads L + 1, L + 2, ... L + n tokens."""
    rows = {i: (int(eng._lengths[i]), len(r.output_ids)) for i, r in enumerate(eng._slot_req)
            if r is not None and r.state == "running"}
    reqs = {i: r for i, r in enumerate(eng._slot_req) if r is not None}
    before = eng.metrics["kv_tokens_read"]
    step()
    got = eng.metrics["kv_tokens_read"] - before
    want = 0
    for i, (length, n_out) in rows.items():
        n = len(reqs[i].output_ids) - n_out
        if eng.sched.speculate_k:
            want += length + 1 if n else 0  # one verify iteration from L
        else:
            want += n * (length + 1) + n * (n - 1) // 2
    return got, want


@pytest.mark.parametrize("spec", [False, True], ids=["plain", "verify"])
def test_kv_tokens_read_equals_a_hand_count(params, spec):
    # a verify chunk of one iteration: its tokens emitted do not tell the
    # positions of a second one
    sched = (dict(speculate_k=2, spec_min_tokens_per_iter=0.0, steps_per_sync=1,
                  max_steps_per_sync=1) if spec else {})
    eng = _engine(params, pipeline_decode=False, **sched)
    eng.submit("a longer prompt to read", max_new_tokens=13, temperature=0.0)
    eng.submit("short", images=[IMAGE], max_new_tokens=7, temperature=0.0)
    eng.step()  # admission and the first chunk
    checked = 0
    while eng.has_work():
        got, want = _hand_count(eng, eng.step)
        assert got == want and got > 0
        checked += 1
    assert checked >= 2


def test_timing_parts_add_up_to_first_token_time_from_receipt(params):
    eng = _engine(params)
    worker = EngineWorker(eng)
    subs = [Submission(prompt=f"page {i}", images=[IMAGE] if i % 2 == 0 else [],
                       max_new_tokens=5, temperature=0.0, top_p=1.0, system_prompt=None)
            for i in range(4)]
    try:
        sent = []
        for sub in subs:
            sent.append(time.monotonic())
            worker.submit(sub)
        replies = [sub.future.result(timeout=120) for sub in subs]
    finally:
        worker.shutdown()
    for sub, t0, reply in zip(subs, sent, replies):
        t = reply["timing"]
        parts = (t["prep_wait_ms"] + t["prep_ms"] + t["engine_wait_ms"] + t["queue_ms"]
                 + t["prefill_ms"])
        assert abs(parts - t["ttft_ms"]) < 1.0
        assert t["prep_ms"] > 0 and t["ttft_ms"] > 0
        assert 0 <= (sub.received_at - t0) * 1e3 < 1.0
        assert sub.received_at <= sub.prep_started_at <= sub.prep_ended_at <= sub.taken_at
        # the worker's queue: preprocessed to the engine thread's take, a part of the wait
        assert t["worker_queue_ms"] == pytest.approx(
            (sub.taken_at - sub.prep_ended_at) * 1e3, abs=1e-6)
        assert t["worker_queue_ms"] <= t["engine_wait_ms"]
        assert t["total_ms"] >= t["ttft_ms"] + t["decode_ms"] - 1.0


def test_stamps_travel_to_the_followers():
    """A tensor-parallel tick carries the stamps on the wire."""
    sub = Submission(prompt="p", images=[IMAGE], max_new_tokens=3, temperature=0.0, top_p=1.0,
                     system_prompt=None, received_at=1.0, prep_started_at=2.0,
                     prep_ended_at=3.0, taken_at=4.0)
    back = async_engine._unwire(async_engine._wire(sub))
    assert (back.received_at, back.prep_started_at, back.prep_ended_at, back.taken_at) == (
        1.0, 2.0, 3.0, 4.0)
    assert back.images == ()


def test_metrics_page_shows_the_split_and_the_counter(params):
    eng = _engine(params)
    assert not [k for k in eng.metrics if k.startswith("t_")]
    assert not hasattr(observability, "PhaseTimer")

    async def run():
        client = TestClient(TestServer(OpenAIServer(eng, model_name="torch").build_app()))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "hi"}], "max_tokens": 5,
                "temperature": 0})
            assert resp.status == 200
            return await (await client.get("/metrics")).text()
        finally:
            await client.close()

    text = asyncio.run(run())
    names = {line.split()[0] for line in text.splitlines() if line}
    for key in ("prep_wait_ms", "prep_ms", "engine_wait_ms", "worker_queue_ms", "queue_ms",
                "ttft_ms"):
        assert f"dots_ocr_request_{key}_p95" in names
    counter = [int(line.split()[1]) for line in text.splitlines()
               if line.startswith("dots_ocr_engine_kv_tokens_read ")]
    assert counter and counter[0] == eng.metrics["kv_tokens_read"] > 0
    assert "dots_ocr_engine_admits_beside_chunk" in names
    assert not [n for n in names if n.startswith("dots_ocr_engine_t_")]


def test_profile_trace_writes_the_program_spans(params, tmp_path):
    eng = _engine(params)
    eng.submit("hello", images=[IMAGE], max_new_tokens=6, temperature=0.0)
    with observability.profile_trace(str(tmp_path)):
        eng.run()
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        trace = json.load(f)
    events = trace["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert {"step", "admit", "prefill", "decode", "dispatch", "apply"} <= {e["name"] for e in spans}
    # on the kernels' axis: the step spans hold the ops the engine ran
    mm = [e for e in events if e.get("cat") == "cpu_op" and e["name"] == "aten::mm"]
    steps = [e for e in spans if e["name"] == "step"]
    assert mm and all(any(s["ts"] <= e["ts"] <= s["ts"] + s["dur"] for s in steps) for e in mm)
    assert all(e["args"]["thread"] == "MainThread" for e in spans)


def test_the_tick_in_progress_when_a_profiler_starts_is_recorded():
    rec = observability.SpanRecorder()
    prof = _cpu_profile()
    with rec.whole("tick") as head:
        assert not head  # nothing is noted on a span that may not be kept
        prof.__enter__()
        assert head
        with rec("step") as step:
            pass
    with rec.whole("tick"):
        pass
    prof.__exit__(None, None, None)
    with rec.whole("tick"):
        pass
    assert [s.name for s in rec.spans()] == ["step", "tick", "tick"]
    assert rec.spans()[1] is head and step.parent == head.id
    assert head.start_ns < step.start_ns <= step.end_ns <= head.end_ns


def test_the_buffer_keeps_the_newest_spans():
    rec = observability.SpanRecorder(capacity=3)
    with _cpu_profile():
        for i in range(5):
            with rec(f"s{i}"):
                pass
    assert [s.name for s in rec.spans()] == ["s2", "s3", "s4"]
    assert [s.name for s in rec.spans(since_ns=rec.spans()[-1].end_ns)] == ["s4"]


def _gated_fetch(gate: threading.Event):
    """A fetch class whose decode chunks (packed results wider than a first
    token's two columns) land only once ``gate`` is set."""

    class GatedFetch(scheduler.HostFetch):
        def __init__(self, tensor):
            super().__init__(tensor)
            self.gated = tensor.shape[-1] > 2

        def landed(self):
            return not self.gated or gate.is_set()

        def wait(self):
            if self.gated:
                gate.wait(60)

    return GatedFetch


def _until(cond, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def test_an_admission_beside_a_chunk_notes_its_dispatch(params, monkeypatch):
    gate = threading.Event()
    monkeypatch.setattr(scheduler, "HostFetch", _gated_fetch(gate))
    eng = _engine(params, pipeline_decode=False)
    drain = eng._drain_inflight

    def land():
        gate.set()  # the chunk lands once the step waits on it, after b's launch
        drain()

    eng._drain_inflight = land
    a = eng.submit("first page", images=[IMAGE], max_new_tokens=9, temperature=0.0)
    with _cpu_profile():
        eng.step()  # admits a, dispatches its chunk and holds it
        assert eng.held_fetch() is not None
        b = eng.submit("second page", max_new_tokens=5, temperature=0.0)
        eng.step()
    eng.run()
    spans = SPANS.spans()
    (dispatch, *_) = [s for s in spans if s.name == "dispatch"]
    admits = {s.reqs: s for s in spans if s.name == "admit"}
    assert "beside" not in admits[(a,)].work
    assert admits[(b,)].work["beside"] == dispatch.id
    assert eng.metrics["admits_beside_chunk"] == 1
    # b's first tokens are read after the chunk lands, outside its admit span
    by_id = {s.id: s for s in spans}
    fetches = [by_id[s.parent].name for s in spans if s.name == "first_fetch"]
    assert fetches == ["admit", "step"]
    assert [len(eng.finished_request(r).output_ids) for r in (a, b)] == [9, 5]


def test_the_engine_thread_wakes_on_a_submission_and_on_a_landing(params, monkeypatch):
    """With a decode chunk held on the device and the worker's queue empty,
    the engine thread waits in its gather: a submission wakes it before the
    chunk lands (and goes beside the chunk), and the landing alone wakes it
    to resolve the request that finished there, with no 50 ms timeout."""
    gate = threading.Event()
    monkeypatch.setattr(scheduler, "HostFetch", _gated_fetch(gate))
    eng = _engine(params, pipeline_decode=False)
    steps, step = [], eng.step

    def counted():
        steps.append(time.monotonic())
        return step()

    eng.step = counted
    worker = EngineWorker(eng, prep_workers=0)
    woken, first = [], worker._first

    def spy(block, held):
        item = first(block, held)
        if held is not None:
            woken.append("landing" if item is held else type(item).__name__)
        return item

    worker._first = spy

    def sub(prompt, n):
        return Submission(prompt=prompt, images=[IMAGE], max_new_tokens=n, temperature=0.0,
                          top_p=1.0, system_prompt=None)

    a, b, c = sub("first page", 9), sub("second page", 5), sub("third page", 3)
    try:
        worker.submit(a)
        _until(lambda: eng.held_fetch() is not None)
        n = len(steps)
        time.sleep(0.3)
        assert len(steps) == n  # waiting, not polling: no step while the chunk runs
        worker.submit(b)
        _until(lambda: eng.metrics["admits_beside_chunk"] == 1)
        assert not gate.is_set() and b.taken_at is not None and not a.future.done()
        assert woken == ["Submission"]
        gate.set()
        replies = [a.future.result(timeout=60), b.future.result(timeout=60)]
        # c finishes in the chunk after its prefill: only that chunk's landing wakes the thread
        gate.clear()
        worker.submit(c)
        _until(lambda: eng.held_fetch() is not None)
        n = len(steps)
        time.sleep(0.3)
        assert len(steps) == n and not c.future.done()
        gate.set()
        replies.append(c.future.result(timeout=60))
    finally:
        gate.set()
        worker.shutdown()
    assert woken[-1] == "landing" and len(steps) == n + 1
    for reply, budget in zip(replies, (9, 5, 3)):
        t = reply["timing"]
        assert reply["completion_tokens"] == budget
        parts = (t["prep_wait_ms"] + t["prep_ms"] + t["engine_wait_ms"] + t["queue_ms"]
                 + t["prefill_ms"])
        assert abs(parts - t["ttft_ms"]) < 1.0
