"""Pipelined (lookahead-1) decode, deep chunks and device-resident chunk
inputs in the port's engine against the JAX engine, on the CPU (tiny
config, float32, bridged weights; the JAX engine runs in a subprocess as
in ``test_torch_engine_parity.py``).

The cases of ``test_pipeline_decode.py`` and the pipelined cases of
``test_paged.py``, ``test_chunked_scheduler.py`` and
``test_speculative.py``: with the pipeline on (the default, as in the JAX
engine) greedy tokens equal the JAX engine's and the port's own
synchronous run; the pipeline engages (``pipelined_chunks``) and the chunk
inputs are uploaded on the same chunks as in the JAX engine
(``chunk_input_rebuilds``); rows that finish mid-pipeline, an admission
mid-decode, k = 2, chunked prefill and a pool that runs dry while a chunk
is in flight (the drain-and-retry branch before preemption) all end
leak-free. A ``cancel()`` with a chunk in flight lands it; a sibling that
finishes there is returned by the next ``step()`` (the JAX engine's
``before`` snapshot loses it) and its ``EngineWorker`` future resolves.
"""

import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.serve.async_engine import EngineWorker, Submission

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# test_pipeline_decode.py's engine: shallow chunks of 2, deep chunks of 8.
BASE = dict(num_pages=96, page_size=8, max_slots=4, max_pages_per_seq=16,
            prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=2,
            max_steps_per_sync=8, prefill_chunk_tokens=64, repetition_min_repeats=0)
PROMPTS = ["alpha beta", "gamma delta epsilon", "zeta", "eta theta"]  # 29, 38, 23, 28 tokens
# name: (scheduler overrides, max_new_tokens per prompt)
CASES = {
    "equal_budgets": ({}, [48, 48, 48, 48]),
    "mixed_budgets": ({}, [6, 40, 40, 40]),
    "k2": (dict(speculate_k=2, spec_min_tokens_per_iter=0.0), [48, 48, 48, 48]),
    # chunked prefill: the 38-token prompt prefills in chunks of 16
    "chunked": (dict(prefill_chunk_tokens=16), [24, 40, 40, 40]),
    # 36 pages: the prompts take 16 and growing to 48 tokens each wants 40,
    # so a reservation fails with a chunk in flight: drain, trim, retry,
    # then preempt
    "dry_pool": (dict(num_pages=36), [48, 48, 48, 48]),
}
LATE = dict(first=PROMPTS[:3], first_max=32, steps_before=6, late="late arrival", late_max=16)


# The scenarios run on both sides: their source also runs in the JAX
# subprocess, against the JAX engine.
def spy_failed_reservations(eng):
    """Record, for each reservation that ran out of pages, whether a
    pipelined chunk was in flight then."""
    hits, extend = [], eng.allocator.extend

    def spy(seq_id, new_length):
        try:
            return extend(seq_id, new_length)
        except Exception:
            hits.append(eng._inflight is not None)
            raise

    eng.allocator.extend = spy
    return hits


def run_wave(make_engine, prompts, budgets, kw):
    eng = make_engine(kw)
    hits = spy_failed_reservations(eng)
    ids = [eng.submit(p, temperature=0.0, max_new_tokens=n) for p, n in zip(prompts, budgets)]
    returned = []
    while eng.has_work():
        returned += [r.req_id for r in eng.step()]
    reqs = [eng.finished_request(i) for i in ids]
    return dict(tokens=[r.prior_output + r.output_ids for r in reqs],
                reasons=[r.finished_reason for r in reqs], returned=sorted(returned),
                pipelined=eng.metrics.get("pipelined_chunks", 0),
                rebuilds=eng.metrics["chunk_input_rebuilds"], steps=eng.metrics["steps"],
                spec_chunks=eng.metrics.get("spec_chunks", 0),
                prefill_chunks=eng.metrics["prefill_chunks"],
                preemptions=eng.metrics["preemptions"], failed_reservations=hits,
                drained=eng._inflight is None and not eng._deferred_free,
                free_pages=eng.allocator.free_pages)


def run_late_admission(make_engine, spec, kw):
    eng = make_engine(kw)
    ids = [eng.submit(p, temperature=0.0, max_new_tokens=spec["first_max"])
           for p in spec["first"]]
    returned, in_flight_at_admission = [], None
    for _ in range(spec["steps_before"]):
        returned += [r.req_id for r in eng.step()]
    in_flight_at_admission = eng._inflight is not None
    ids.append(eng.submit(spec["late"], temperature=0.0, max_new_tokens=spec["late_max"]))
    while eng.has_work():
        returned += [r.req_id for r in eng.step()]
    reqs = [eng.finished_request(i) for i in ids]
    return dict(tokens=[r.output_ids for r in reqs], reasons=[r.finished_reason for r in reqs],
                returned=sorted(returned), in_flight_at_admission=in_flight_at_admission,
                pipelined=eng.metrics.get("pipelined_chunks", 0),
                rebuilds=eng.metrics["chunk_input_rebuilds"],
                drained=eng._inflight is None and not eng._deferred_free,
                free_pages=eng.allocator.free_pages)


JAX_SIDE = "\n".join(inspect.getsource(f) for f in (
    spy_failed_reservations, run_wave, run_late_admission)) + '''
import json, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu.models.config import DotsOCRConfig
from dots_ocr_tpu.models.init import init_params
spec = json.loads(sys.argv[1])
params = init_params(jax.random.PRNGKey(0), DotsOCRConfig.tiny(), scale=0.3)


def make_engine(kw):
    return ContinuousBatchingEngine(params, DotsOCRConfig.tiny(),
                                    sched=SchedulerConfig(**{**spec["base"], **kw}))


out = {name: run_wave(make_engine, spec["prompts"], budgets, kw)
       for name, (kw, budgets) in spec["cases"].items()}
out["late"] = run_late_admission(make_engine, spec["late"], {})
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_side():
    spec = dict(base=BASE, prompts=PROMPTS, cases=CASES, late=LATE)
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
                                        sched=SchedulerConfig(**{**BASE, **kw}))
    return make


def test_defaults_are_the_jax_engines():
    sched = SchedulerConfig()
    assert sched.pipeline_decode and sched.max_steps_per_sync == 64
    assert sched.logit_bias_slots == 32


@pytest.mark.parametrize("name", sorted(CASES))
def test_pipelined_tokens_and_counters_match_jax_engine(jax_side, make_engine, name):
    kw, budgets = CASES[name]
    ours = run_wave(make_engine, PROMPTS, budgets, kw)
    theirs = jax_side[name]
    assert ours["tokens"] == theirs["tokens"] and ours["reasons"] == theirs["reasons"]
    assert [len(t) for t in ours["tokens"]] == budgets
    assert len({t for toks in ours["tokens"] for t in toks}) > 12  # not one repeated token
    # the same schedule: chunks pipelined and input uploads on the same chunks
    assert ours["pipelined"] == theirs["pipelined"] > 0
    assert ours["rebuilds"] == theirs["rebuilds"]
    assert ours["rebuilds"] < ours["steps"]
    assert ours["preemptions"] == theirs["preemptions"]
    assert ours["failed_reservations"] == theirs["failed_reservations"]
    # leak-free: the in-flight chunk landed, deferred frees flushed
    assert ours["drained"] and ours["free_pages"] == kw.get("num_pages", BASE["num_pages"]) - 1
    # every finish returned by step() exactly once
    assert ours["returned"] == list(range(len(PROMPTS)))
    # ... and equal to the port's own synchronous run
    sync = run_wave(make_engine, PROMPTS, budgets, {**kw, "pipeline_decode": False})
    assert sync["tokens"] == ours["tokens"] and sync["pipelined"] == 0
    if name == "k2":
        assert ours["spec_chunks"] >= 2
    if name == "chunked":
        assert ours["prefill_chunks"] >= 3
    if name == "dry_pool":
        # a reservation ran dry with a chunk in flight (the drain-and-retry
        # branch), and the pool still forced a preemption after
        assert True in ours["failed_reservations"] and ours["preemptions"] >= 1
        assert ours["tokens"] == run_wave(make_engine, PROMPTS, budgets, {})["tokens"]


def test_deep_chunks_take_fewer_steps_with_the_same_tokens(make_engine):
    deep = run_wave(make_engine, PROMPTS, [48] * 4, {"pipeline_decode": False})
    shallow = run_wave(make_engine, PROMPTS, [48] * 4,
                       {"pipeline_decode": False, "max_steps_per_sync": 2})
    assert deep["tokens"] == shallow["tokens"]
    assert deep["steps"] < shallow["steps"]


def test_admission_mid_decode_drains_the_pipeline(jax_side, make_engine):
    ours = run_late_admission(make_engine, LATE, {})
    theirs = jax_side["late"]
    assert ours["in_flight_at_admission"] and theirs["in_flight_at_admission"]
    assert ours["tokens"] == theirs["tokens"] and ours["reasons"] == theirs["reasons"]
    assert ours["pipelined"] == theirs["pipelined"] and ours["rebuilds"] == theirs["rebuilds"]
    assert ours["drained"] and ours["free_pages"] == BASE["num_pages"] - 1
    assert ours["returned"] == [0, 1, 2, 3]
    assert ours["tokens"] == run_late_admission(
        make_engine, LATE, {"pipeline_decode": False})["tokens"]


# The cancel cases: A decodes long; B's budget (21: 20 after its first
# token) ends exactly at a chunk boundary, so the pipelined chunk in flight
# at the step where B's remaining budget equals its tokens finishes B when
# it lands.
CANCEL_BUDGETS = {"A": 64, "B": 21}


def _b_ends_in_flight(eng, b_id) -> bool:
    b = next((r for r in eng._slot_req if r is not None and r.req_id == b_id), None)
    return (eng._inflight is not None and b is not None
            and b.max_new_tokens - len(b.output_ids) == eng._inflight["tokens"])


def test_cancel_lands_the_chunk_and_the_next_step_returns_the_sibling(make_engine):
    eng = make_engine({})
    a = eng.submit(PROMPTS[0], temperature=0.0, max_new_tokens=CANCEL_BUDGETS["A"])
    b = eng.submit(PROMPTS[1], temperature=0.0, max_new_tokens=CANCEL_BUDGETS["B"])
    while not _b_ends_in_flight(eng, b):
        assert not eng.step()
    assert eng.cancel(a)
    # the drain finished B outside step(); pages all back at once
    assert eng.finished_request(b).finished_reason == "length"
    assert eng._inflight is None and not eng._deferred_free
    assert eng.allocator.free_pages == BASE["num_pages"] - 1 and not eng.has_work()
    assert sorted(r.req_id for r in eng.step()) == [a, b]
    assert eng.step() == []  # reported once
    alone = run_wave(make_engine, PROMPTS[1:2], [CANCEL_BUDGETS["B"]], {})
    assert eng.finished_request(b).output_ids == alone["tokens"][0]


def test_worker_resolves_a_sibling_that_cancel_finished(make_engine):
    eng = make_engine({})
    worker = EngineWorker(eng, prep_workers=0)
    real_step, state = eng.step, {}

    def step():
        out = real_step()
        if "cancelled" not in state and _b_ends_in_flight(eng, 1):
            state["cancelled"] = True
            worker.cancel(subs[0])  # lands on the engine thread's next loop
        return out

    eng.step = step
    subs = [Submission(prompt=p, images=[], max_new_tokens=CANCEL_BUDGETS[k], temperature=0.0,
                       top_p=1.0, system_prompt=None)
            for p, k in ((PROMPTS[0], "A"), (PROMPTS[1], "B"))]
    try:
        futures = [worker.submit(sub) for sub in subs]
        b = futures[1].result(timeout=120)
        a = futures[0].result(timeout=60)
    finally:
        worker.shutdown()
    assert state["cancelled"]
    assert b["finish_reason"] == "length" and b["completion_tokens"] == CANCEL_BUDGETS["B"]
    assert a["finish_reason"] == "cancelled"
    assert not eng.has_work() and eng.allocator.free_pages == BASE["num_pages"] - 1
