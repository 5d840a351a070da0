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

Admission beside a chunk on the device: on the CPU every chunk has landed
at dispatch, so a stand-in fetch that reports "not landed" until it is
read (``HeldFetch``) makes every step hold its chunk. A late request is
then admitted beside it with the JAX engine's tokens, into a slot outside
the chunk's rows, and the pool ends whole; a chunked late request and a
tensor-parallel engine land first, on today's schedule.
"""

import dataclasses
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
from dots_ocr_tpu_torch.engine import scheduler
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



class HeldFetch(scheduler.HostFetch):
    """A fetch that has not landed until it is read: every chunk a step
    dispatches is held, and a request that waits goes beside it."""

    def __init__(self, tensor):
        super().__init__(tensor)
        self.read = False

    def landed(self):
        return self.read

    def numpy(self):
        self.read = True
        return super().numpy()


class LaggingFetch(HeldFetch):
    """... that lands once the next fetch is made: a chunk finishes on the
    device while the host dispatches the one after it, so a pipelined
    chunk's predecessor is applied at once (rows that end there leave their
    slots free while the pipelined chunk still decodes them)."""

    newest = None

    def __init__(self, tensor):
        super().__init__(tensor)
        LaggingFetch.newest = self

    def landed(self):
        return self.read or self is not LaggingFetch.newest


def freed_in_flight(eng) -> bool:
    """A slot of the chunk on the device is free: its row ended meanwhile."""
    return eng._inflight is not None and any(
        eng._slot_req[i] is None for i in eng._inflight["active"])


LONG = "a late arrival whose prompt is long enough to prefill in chunks"
FIRST3 = [PROMPTS[0], PROMPTS[2], PROMPTS[3]]  # monolithic under 32-token chunks
# name: the scenario; a request arrives after `steps` steps (or once
# `arrive` holds) while `fetch` holds the chunks. `beside`: admitted beside
# a chunk; `tp`: a tensor-parallel engine; `eos`: the config's end id (65
# ends the first prompt's greedy stream after 16 tokens, inside a pipelined
# chunk).
BESIDE = {
    "late": dict(first=LATE["first"], budgets=[LATE["first_max"]] * 3),
    "late_sync": dict(kw={"pipeline_decode": False}, budgets=[32] * 3),
    "finished_in_flight": dict(budgets=[48] * 3, eos=65, fetch=LaggingFetch,
                               arrive=freed_in_flight),
    "k2": dict(kw=dict(speculate_k=2, spec_min_tokens_per_iter=0.0), budgets=[32] * 3),
    "chunked_late": dict(kw={"prefill_chunk_tokens": 32}, first=FIRST3, budgets=[32] * 3,
                         late=LONG, beside=False),
    "tp": dict(budgets=[32] * 3, tp=True, beside=False),
}
COUNTERS = ("steps", "pipelined_chunks", "chunk_input_rebuilds", "prefills", "prefill_chunks",
            "spec_chunks", "preemptions", "admits_beside_chunk")


@pytest.fixture
def make_tp_engine(params, tmp_path):
    """Engines on a one-rank gloo TP group (this process)."""
    import torch.distributed as dist

    from dots_ocr_tpu_torch.parallel.distributed import TPGroup
    from dots_ocr_tpu_torch.parallel.sharding import shard_params

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0, world_size=1)
    try:
        tp = TPGroup(rank=0, world=1, backend="gloo", device=CPU, group=dist.group.WORLD,
                     control=dist.group.WORLD)
        shard, tp.plan = shard_params(params, DotsOCRConfig.tiny(), 0, 1)
        yield lambda kw, cfg: ContinuousBatchingEngine(shard, cfg, CPU, tp=tp,
                                                       sched=SchedulerConfig(**{**BASE, **kw}))
    finally:
        dist.destroy_process_group()


def run_beside(make, case):
    cfg = DotsOCRConfig.tiny()
    if "eos" in case:
        cfg = cfg.replace(special=dataclasses.replace(cfg.special, eos_token_id=case["eos"]))
    eng = make(case.get("kw", {}), cfg)
    reused, admit = [], eng._admit_batch

    def spy(reqs, slots):
        # slots taken while a chunk that decodes them is still on the device
        for flight in (eng._held, eng._inflight):
            if flight is not None and not flight["fetch"].landed():
                reused.extend(set(slots) & set(flight["active"]))
        return admit(reqs, slots)

    eng._admit_batch = spy
    budgets = case["budgets"]
    ids = [eng.submit(p, temperature=0.0, max_new_tokens=n)
           for p, n in zip(case.get("first", PROMPTS[:3]), budgets)]
    returned, arrive = [], case.get("arrive")
    for n in range(40):
        if (arrive(eng) if arrive else n == LATE["steps_before"]):
            break
        returned += [r.req_id for r in eng.step()]
    freed = freed_in_flight(eng)
    held = eng.held_fetch() is not None
    ids.append(eng.submit(case.get("late", LATE["late"]), temperature=0.0,
                          max_new_tokens=LATE["late_max"]))
    while eng.has_work():
        returned += [r.req_id for r in eng.step()]
    reqs = [eng.finished_request(i) for i in ids]
    free = eng.allocator._free
    return dict(tokens=[r.output_ids for r in reqs], reasons=[r.finished_reason for r in reqs],
                returned=sorted(returned), reused=reused, held_at_arrival=held,
                freed_at_arrival=freed, counters={k: eng.metrics[k] for k in COUNTERS},
                drained=not eng._on_device() and not eng._deferred_free,
                pool_whole=(len(free) == len(set(free)) == BASE["num_pages"] - 1
                            and eng.allocator.free_pages == BASE["num_pages"] - 1))


@pytest.mark.parametrize("name", sorted(BESIDE))
def test_admission_beside_a_chunk_on_the_device(jax_side, params, make_tp_engine,
                                                monkeypatch, name):
    case = BESIDE[name]
    beside = case.get("beside", True)
    if case.get("tp"):
        make = make_tp_engine
    else:
        def make(kw, cfg):
            return ContinuousBatchingEngine(params, cfg, CPU,
                                            sched=SchedulerConfig(**{**BASE, **kw}))
    today = run_beside(make, case)
    monkeypatch.setattr(scheduler, "HostFetch", case.get("fetch", HeldFetch))
    ours = run_beside(make, case)
    assert not today["held_at_arrival"] and today["counters"]["admits_beside_chunk"] == 0
    # a TP engine treats every chunk as landed: it never holds one
    assert ours["held_at_arrival"] == (not case.get("tp") and case.get("fetch") is None)
    assert ours["counters"]["admits_beside_chunk"] == int(beside)
    assert ours["tokens"] == today["tokens"] and ours["reasons"] == today["reasons"]
    if "eos" not in case:
        assert [len(t) for t in ours["tokens"]] == case["budgets"] + [LATE["late_max"]]
    # no slot of a chunk's rows is reused before it lands, the pool ends whole
    assert ours["reused"] == []
    assert ours["freed_at_arrival"] == today["freed_at_arrival"] == ("arrive" in case)
    assert ours["drained"] and ours["pool_whole"]
    assert ours["returned"] == list(range(4))
    # the same chunks, uploads and prefills as landing first
    assert {k: v for k, v in ours["counters"].items() if k != "admits_beside_chunk"} == {
        k: v for k, v in today["counters"].items() if k != "admits_beside_chunk"}
    if name == "late":
        theirs = jax_side["late"]
        assert ours["tokens"] == theirs["tokens"] and ours["reasons"] == theirs["reasons"]
        sync = run_beside(make, {**case, "kw": {"pipeline_decode": False}})
        assert ours["tokens"] == sync["tokens"]


@pytest.mark.parametrize("tp", [False, True])
def test_the_decode_chunk_waits_a_step_for_requests_that_arrived(params, make_tp_engine, tp):
    """With an ``arrivals`` probe set, decode chunks are not deepened; where
    it reads true after a step, the next step leaves its decode chunk to the
    step after it (which admits the arrivals first; never two steps in a
    row). The tokens are unchanged. A TP engine never reads the probe."""
    cfg = DotsOCRConfig.tiny()

    def make():
        if tp:
            return make_tp_engine({}, cfg)
        return ContinuousBatchingEngine(params, cfg, CPU, sched=SchedulerConfig(**BASE))

    def serve(eng, probe):
        depths, run_chunk = [], eng._run_chunk

        def counted(dev, key):
            depths.append(key.num_steps)
            return run_chunk(dev, key)

        eng._run_chunk = counted
        ids = [eng.submit(p, temperature=0.0, max_new_tokens=24) for p in PROMPTS[:2]]
        eng.step()
        eng.arrivals = probe
        seen = []
        for _ in range(3):
            eng.step()
            seen.append(list(depths))
        eng.arrivals = None
        eng.run()
        return [eng.finished_request(i).output_ids for i in ids], seen

    base, _ = serve(make(), None)
    tokens, seen = serve(make(), lambda: True)
    quiet, quiet_seen = serve(make(), lambda: False)
    assert tokens == base == quiet
    deep, shallow = BASE["max_steps_per_sync"], BASE["steps_per_sync"]
    if tp:
        assert [len(d) for d in seen] == [2, 3, 4] and seen == quiet_seen
    else:
        # deferred, then a shallow chunk (requests wait), deferred again
        assert [len(d) for d in seen] == [1, 2, 2]
        assert seen[0] == [deep]  # the first chunk, before the probe was set
        assert seen[1][1] == shallow
        # with nothing pending the chunks go on, but no longer deepen
        assert quiet_seen[-1] == [deep, shallow, shallow, shallow]
