"""Recompute preemption in the port's engine against the JAX engine, on
the CPU (tiny config, float32, bridged weights; the JAX engine runs in a
subprocess as in ``test_torch_engine_parity.py``).

A KV pool too small for every request to grow to its ``max_new_tokens``
runs dry mid-decode. Both engines preempt the youngest request (its
generated tokens join its prompt and it re-queues), so every request still
finishes, with the greedy tokens an unpressured engine gives: plain decode,
chunked prefill, a PREFILLING victim, k = 2 speculation, and a stop string
that spans the preemption point (its text is emitted once). The port's
``EngineWorker`` serves a further request after the dry pool, and after a
``step()`` that raised it takes the failed requests out of the engine
instead of spinning.
"""

import inspect
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine import scheduler as torch_scheduler
from dots_ocr_tpu_torch.engine.kv_cache import OutOfPages
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.serve.async_engine import EngineWorker, Submission
from test_torch_engine import RECEIPT, SCHED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# The youngest request (the victim) carries the image: it re-encodes it on
# re-admission. Prompts are 30, 47 and 70 tokens; with 40 new tokens each
# they need 35 pages of 8, and the pools below hold 29 or 25.
REQUESTS = [("hello world", False), ("a second, longer text prompt", False),
            ("Extract the text content from this image.", True)]
MAX_NEW = 40
POOL_CASES = {
    "plain": dict(num_pages=30),
    "chunked": dict(num_pages=26, prefill_chunk_tokens=16),
    "k2": dict(num_pages=30, speculate_k=2, spec_min_tokens_per_iter=0.0),
}
ROOMY = dict(num_pages=128)
# A PREFILLING victim: a short request decodes while a long one (6 chunks
# of 16) prefills; the pool (16 pages) holds the long one alone with one page over.
PREFILLING = dict(sched=dict(num_pages=17, prefill_chunk_tokens=16), first="hello world",
                  steps_before=2, second="y" * 60)
# The stop-string case preempts by hand once this many tokens exist, and
# the stop string is the text around that point.
STOP_PROMPT, STOP_AFTER = "a second, longer text prompt", 10


# The scenarios are shared by both sides: their source also runs in the JAX
# subprocess, against the JAX engine.
def run_pool(make_engine, receipt, requests, max_new, sched_kw):
    eng = make_engine(sched_kw)
    ids = [eng.submit(text, images=[receipt] if img else [], max_new_tokens=max_new,
                      temperature=0.0, max_pixels=28 * 28 * 12) for text, img in requests]
    eng.run()
    reqs = [eng.finished_request(i) for i in ids]
    return dict(tokens=[r.prior_output + r.output_ids for r in reqs],
                reasons=[r.finished_reason for r in reqs],
                text=[eng.request_text(i) for i in ids],
                preempted=[r.preempted for r in reqs],
                preemptions=eng.metrics["preemptions"],
                free_pages=eng.allocator.free_pages), eng


def run_prefilling(make_engine, spec, max_new):
    eng = make_engine(spec["sched"])
    states = []
    preempt = eng._preempt_youngest

    def spy():
        victim = max((r for r in eng._slot_req if r is not None), key=lambda r: r.submitted_at)
        states.append(victim.state)
        preempt()

    eng._preempt_youngest = spy
    a = eng.submit(spec["first"], max_new_tokens=max_new, temperature=0.0)
    for _ in range(spec["steps_before"]):
        eng.step()
    b = eng.submit(spec["second"], max_new_tokens=max_new, temperature=0.0)
    eng.run()
    reqs = [eng.finished_request(i) for i in (a, b)]
    return dict(tokens=[r.prior_output + r.output_ids for r in reqs],
                reasons=[r.finished_reason for r in reqs], victim_states=states,
                preemptions=eng.metrics["preemptions"])


def run_stop(make_engine, prompt, max_new, after, stop, sched_kw):
    """Serve ``prompt`` with a stream; preempt by hand after the first step
    that leaves >= ``after`` tokens. With ``stop`` None nothing is
    preempted and the text at that point is reported instead."""
    eng = make_engine(sched_kw)
    deltas = []
    rid = eng.submit(prompt, max_new_tokens=max_new, temperature=0.0,
                     stop=[stop] if stop else None,
                     stream_cb=lambda d, f: deltas.append((d, f)))
    req = None
    while eng.has_work():
        eng.step()
        req = req or next((r for r in eng._slot_req if r is not None), None)
        if req is not None and len(req.output_ids) >= after:
            break
    text_at = req.text
    if stop and eng.has_work():
        eng._preempt_youngest()
    eng.run()
    done = eng.finished_request(rid)
    return dict(text=eng.request_text(rid), text_at=text_at, deltas=deltas,
                tokens=done.prior_output + done.output_ids, reason=done.finished_reason,
                preempted=done.preempted)


JAX_SIDE = "\n".join(inspect.getsource(f) for f in (run_pool, run_prefilling, run_stop)) + '''
import json, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
from PIL import Image
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu.models.config import DotsOCRConfig
from dots_ocr_tpu.models.init import init_params
spec = json.loads(sys.argv[1])
params = init_params(jax.random.PRNGKey(0), DotsOCRConfig.tiny(), scale=0.3)
receipt = Image.open(spec["receipt"])


def make_engine(kw):
    return ContinuousBatchingEngine(params, DotsOCRConfig.tiny(),
                                    sched=SchedulerConfig(**{**spec["sched"], **kw}))


out = {"pool": {}}
out["roomy"] = run_pool(make_engine, receipt, spec["requests"], spec["max_new"], spec["roomy"])[0]
for name, kw in spec["pool_cases"].items():
    out["pool"][name] = run_pool(make_engine, receipt, spec["requests"], spec["max_new"], kw)[0]
out["prefilling"] = run_prefilling(make_engine, spec["prefilling"], spec["max_new"])
free = run_stop(make_engine, spec["stop_prompt"], spec["max_new"], spec["stop_after"], None,
                spec["roomy"])
cut = len(free["text_at"])
out["stop_string"] = free["text"][cut - 2:cut + 2]
out["stop_free"] = free
out["stop"] = run_stop(make_engine, spec["stop_prompt"], spec["max_new"], spec["stop_after"],
                       out["stop_string"], spec["roomy"])
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_side():
    spec = dict(sched=SCHED, requests=REQUESTS, max_new=MAX_NEW, roomy=ROOMY,
                pool_cases=POOL_CASES, prefilling=PREFILLING, receipt=RECEIPT,
                stop_prompt=STOP_PROMPT, stop_after=STOP_AFTER)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(spec)], env=env,
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def params():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=0.3)
    return from_numpy_params(jax.tree.map(np.asarray, jparams), DotsOCRConfig.tiny(), CPU)


@pytest.fixture
def make_engine(params):
    def make(kw):
        return ContinuousBatchingEngine(params, DotsOCRConfig.tiny(), CPU,
                                        sched=SchedulerConfig(**{**SCHED, **kw}))
    return make


@pytest.mark.parametrize("name", sorted(POOL_CASES))
def test_dry_pool_finishes_every_request_with_jax_tokens(jax_side, make_engine, name):
    kw = POOL_CASES[name]
    ours, eng = run_pool(make_engine, Image.open(RECEIPT), REQUESTS, MAX_NEW, kw)
    theirs = jax_side["pool"][name]
    assert ours["tokens"] == theirs["tokens"] and ours["reasons"] == theirs["reasons"]
    assert ours["text"] == theirs["text"]
    # ... which are the tokens of a pool that never runs dry
    assert ours["tokens"] == jax_side["roomy"]["tokens"]
    assert jax_side["roomy"]["preemptions"] == 0
    assert all(len(t) == MAX_NEW for t in ours["tokens"])
    assert ours["preemptions"] >= 1 and theirs["preemptions"] >= 1
    assert sum(ours["preempted"]) == ours["preemptions"]
    assert ours["free_pages"] == kw["num_pages"] - 1 and not eng.has_work()
    if "prefill_chunk_tokens" in kw:
        assert eng.metrics["prefill_chunks"] >= 2
    if "speculate_k" in kw:
        assert eng.metrics["spec_chunks"] >= 1 and eng.metrics["spec_emitted"] > 0


def test_unpressured_pool_never_preempts(jax_side, make_engine):
    ours, _ = run_pool(make_engine, Image.open(RECEIPT), REQUESTS, MAX_NEW, ROOMY)
    assert ours["preemptions"] == 0 and ours["preempted"] == [0, 0, 0]
    assert ours["tokens"] == jax_side["roomy"]["tokens"]


def test_prefilling_victim_restarts_its_prefill(jax_side, make_engine):
    ours = run_prefilling(make_engine, PREFILLING, MAX_NEW)
    theirs = jax_side["prefilling"]
    assert ours["tokens"] == theirs["tokens"] and ours["reasons"] == theirs["reasons"]
    assert torch_scheduler.PREFILLING in ours["victim_states"]
    assert "prefilling" in theirs["victim_states"]
    assert ours["preemptions"] >= 1 and theirs["preemptions"] >= 1


def test_stop_string_spanning_the_preemption_is_emitted_once(jax_side, make_engine):
    stop = jax_side["stop_string"]
    free, theirs = jax_side["stop_free"], jax_side["stop"]
    assert len(stop) == 4 and free["text"].find(stop) == len(free["text_at"]) - 2
    ours = run_stop(make_engine, STOP_PROMPT, MAX_NEW, STOP_AFTER, stop, ROOMY)
    expected = free["text"][:free["text"].find(stop)]
    for side in (ours, theirs):
        assert side["preempted"] == 1 and side["reason"] == "stop"
        assert side["text"] == expected
        assert "".join(d for d, _ in side["deltas"]) == expected  # nothing twice, nothing lost
        assert [f for _, f in side["deltas"] if f is not None] == ["stop"]
    # the preemption fell inside the stop string's span on the port's side too
    assert ours["text_at"] == free["text_at"]
    assert ours["tokens"] == theirs["tokens"]
    assert ours["tokens"] == free["tokens"][:len(ours["tokens"])]


def test_nothing_to_preempt_raises_out_of_pages(make_engine):
    with pytest.raises(OutOfPages, match="nothing to preempt"):
        make_engine({})._preempt_youngest()


def _submission(text, max_new=MAX_NEW):
    return Submission(prompt=text, images=[], max_new_tokens=max_new, temperature=0.0,
                      top_p=1.0, system_prompt=None)


def test_worker_serves_on_after_a_dry_pool(make_engine):
    eng = make_engine(dict(num_pages=22))
    worker = EngineWorker(eng)
    try:
        futures = [worker.submit(_submission(text)) for text, _ in REQUESTS]
        results = [f.result(timeout=120) for f in futures]
        assert all(r["completion_tokens"] == MAX_NEW for r in results)
        # the generated tokens that joined a victim's prompt are not billed as prompt
        assert [r["prompt_tokens"] for r in results] == [30, 47, 60]
        assert eng.metrics["preemptions"] >= 1
        after = worker.submit(_submission("one more", max_new=6)).result(timeout=60)
        assert after["completion_tokens"] == 6 and after["finish_reason"] == "length"
    finally:
        worker.shutdown()
    assert not eng.has_work() and eng.allocator.free_pages == 22 - 1


def test_worker_does_not_spin_after_a_failed_step(make_engine, monkeypatch):
    eng = make_engine({})
    real_step, calls = eng.step, []

    def step():
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("injected step failure")
        return real_step()

    monkeypatch.setattr(eng, "step", step)
    worker = EngineWorker(eng)
    try:
        failed = worker.submit(_submission("doomed"))
        with pytest.raises(RuntimeError, match="injected"):
            failed.result(timeout=60)
        # The worker's recovery frees the slot (has_work() turns false) and
        # then takes the finished entry: wait for both.
        deadline = time.monotonic() + 10
        while (eng.has_work() or eng._finished) and time.monotonic() < deadline:
            time.sleep(0.01)
        assert not eng.has_work() and not eng._finished
        assert eng.allocator.free_pages == SCHED["num_pages"] - 1
        n = len(calls)
        time.sleep(0.3)
        assert len(calls) == n  # idle, not raising in a loop
        after = worker.submit(_submission("one more", max_new=6)).result(timeout=60)
        assert after["completion_tokens"] == 6
    finally:
        worker.shutdown()
