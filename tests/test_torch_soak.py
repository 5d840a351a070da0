"""``test_scheduler_soak.py``'s randomized schedule through the port's
engine, against the JAX engine on the same schedule (CPU, tiny config,
float32, bridged weights; the JAX engine runs in a subprocess as in
``test_torch_engine_parity.py``).

The schedule is the soak's: 14 random requests trickled in 0-2 a step,
with images, stop strings, streams, cancels at random steps, logprobs,
penalties and logit_bias, k = 2 speculation, chunked prefill, deep chunks
and the pipelined decode, on a pool tight enough to preempt. ``seed`` is
dropped (the port refuses it). Two variants:

- greedy: every request at temperature 0. The schedule is then the same
  on both sides, so every request's tokens, finish reason and text, and
  the engines' counters (preemptions, pipelined chunks, input rebuilds),
  equal the JAX engine's.
- mixed: the soak's own temperatures. Sampled rows draw from other
  generators on the two sides, so the schedules may drift apart; the
  port's run keeps the soak's invariants (every request finishes, the
  pool ends leak-free, streams concatenate to the text, logprobs stay
  aligned) and the greedy, unpenalized requests that neither side
  cancelled emit the JAX engine's tokens (greedy output is event-invariant;
  a penalized one is not across a preemption, whose replay counts only the
  tokens generated since, as in the JAX engine).
"""

import inspect
import json
import os
import random
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# test_scheduler_soak.py's engine (24 pages of 8: it preempts under load).
SOAK_SCHED = dict(num_pages=24, page_size=8, max_slots=3, max_pages_per_seq=16,
                  prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=2,
                  max_steps_per_sync=4, prefill_chunk_tokens=16, speculate_k=2,
                  repetition_max_period=0, repetition_min_repeats=0)
SOAK_SEED, N_REQUESTS, DEFAULT_MAX_NEW = 1234, 14, 8
# The greedy variant's budgets are the soak's times this (4-40 tokens), so
# that deep chunks, the pipeline and preemptions engage.
BUDGET_SCALE = 4


# The schedule and the loop that serves it run on both sides: their source also runs in
# the JAX subprocess, against the JAX engine.
def run_soak(make_engine, variant):
    """The soak's schedule and loop: its request specs (``seed`` dropped;
    in the ``greedy`` variant every request greedy, budgets scaled by
    BUDGET_SCALE), then, from the same generator, its random trickle of
    submissions and its cancels, step by step."""
    from test_scheduler_soak import _random_requests

    rng = random.Random(SOAK_SEED)
    specs = _random_requests(rng, N_REQUESTS)
    for sp in specs:
        sp["seed"] = None
        if variant == "greedy":
            sp["temperature"] = 0.0
            sp["max_new_tokens"] *= BUDGET_SCALE
    eng = make_engine()
    streams, finals, id_of, cancel_at = {}, {}, {}, {}
    pending = list(range(len(specs)))
    steps = 0
    while pending or eng.has_work():
        for _ in range(min(len(pending), rng.randint(0, 2))):
            i = pending.pop(0)
            sp = specs[i]
            cb = None
            if sp["stream"]:
                def cb(delta, reason, i=i):
                    streams.setdefault(i, []).append(delta)
                    if reason is not None:
                        finals[i] = reason
            opts = {k: sp[k] for k in ("max_new_tokens", "temperature", "top_p", "stop",
                                       "logprobs", "presence_penalty", "frequency_penalty",
                                       "logit_bias")}
            rid = eng.submit(sp["prompt"], images=sp["images"], stream_cb=cb, **opts)
            id_of[i] = rid
            if sp["cancel_after"] is not None:
                cancel_at[rid] = sp["cancel_after"]
        eng.step()
        steps += 1
        for rid in list(cancel_at):
            cancel_at[rid] -= 1
            if cancel_at[rid] <= 0:
                eng.cancel(rid)  # may already be finished: a no-op then
                del cancel_at[rid]
        assert steps < 600, "soak did not drain"
    out = []
    for i in range(len(specs)):
        req = eng.finished_request(id_of[i])
        out.append(dict(tokens=req.prior_output + req.output_ids, reason=req.finished_reason,
                        text=eng.request_text(id_of[i]), preempted=req.preempted,
                        n_logprobs=len(req.output_logprobs),
                        stream="".join(streams[i]) if i in streams else None,
                        stream_final=finals.get(i)))
    return dict(specs=[{k: sp[k] for k in ("temperature", "presence_penalty",
                                           "frequency_penalty", "logprobs", "stream")}
                       for sp in specs],
                requests=out, preemptions=eng.metrics["preemptions"],
                pipelined=eng.metrics.get("pipelined_chunks", 0),
                rebuilds=eng.metrics["chunk_input_rebuilds"],
                spec_chunks=eng.metrics.get("spec_chunks", 0),
                free_pages=eng.allocator.free_pages, tables=len(eng.allocator._tables))


def run_preemptions(make_engine, kw):
    """test_scheduler_soak.py's check that its engine preempts: five
    5-word requests of 24 tokens on the 3-slot, 24-page pool."""
    from test_scheduler_soak import WORDS

    rng = random.Random(99)
    eng = make_engine(**kw)
    ids = [eng.submit(" ".join(rng.choice(WORDS) for _ in range(5)), max_new_tokens=24,
                      temperature=0.0) for _ in range(5)]
    eng.run()
    return dict(tokens=[eng.finished_request(i).prior_output + eng.finished_request(i).output_ids
                        for i in ids],
                preemptions=eng.metrics["preemptions"],
                pipelined=eng.metrics.get("pipelined_chunks", 0),
                rebuilds=eng.metrics["chunk_input_rebuilds"],
                free_pages=eng.allocator.free_pages)


JAX_SIDE = "\n".join(inspect.getsource(f) for f in (run_soak, run_preemptions)) + '''
import json, random, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu.models.config import DotsOCRConfig
from dots_ocr_tpu.models.init import init_params
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["tests"])
SOAK_SEED, N_REQUESTS, BUDGET_SCALE = spec["seed"], spec["n"], spec["scale"]
params = init_params(jax.random.PRNGKey(0), DotsOCRConfig.tiny(), scale=0.3)


def make_engine(**kw):
    return ContinuousBatchingEngine(params, DotsOCRConfig.tiny(),
                                    sched=SchedulerConfig(**{**spec["sched"], **kw}),
                                    default_max_new_tokens=spec["max_new"])


out = {v: run_soak(make_engine, v) for v in ("greedy", "mixed")}
out["preemptions"] = run_preemptions(make_engine, {"speculate_k": 0})
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_side():
    spec = dict(sched=SOAK_SCHED, seed=SOAK_SEED, n=N_REQUESTS, max_new=DEFAULT_MAX_NEW,
                scale=BUDGET_SCALE, tests=os.path.join(REPO, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(spec)], env=env,
                          capture_output=True, text=True, timeout=900, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def make_engine():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=0.3)
    params = from_numpy_params(jax.tree.map(np.asarray, jparams), DotsOCRConfig.tiny(), CPU)

    def make(**kw):
        return ContinuousBatchingEngine(params, DotsOCRConfig.tiny(), CPU,
                                        sched=SchedulerConfig(**{**SOAK_SCHED, **kw}),
                                        default_max_new_tokens=DEFAULT_MAX_NEW)
    return make


def check_invariants(run):
    """The soak's invariants on one run."""
    assert run["free_pages"] == SOAK_SCHED["num_pages"] - 1 and run["tables"] == 0
    for sp, req in zip(run["specs"], run["requests"]):
        assert req["reason"] in ("stop", "length", "cancelled", "repetition", "prompt_too_long")
        ended = req["reason"] in ("stop", "length", "repetition")
        if sp["logprobs"] and ended:
            assert req["n_logprobs"] == len(req["tokens"])
        elif not sp["logprobs"]:
            assert req["n_logprobs"] == 0
        if sp["stream"] and ended:
            assert req["stream"] == req["text"] and req["stream_final"] is not None


@pytest.mark.parametrize("variant", ["greedy", "mixed"])
def test_soak_schedule_matches_jax_engine(jax_side, make_engine, variant):
    ours, theirs = run_soak(make_engine, variant), jax_side[variant]
    check_invariants(ours)
    reasons = [r["reason"] for r in ours["requests"]]
    assert "cancelled" in reasons and reasons.count("length") >= 5
    assert ours["spec_chunks"] >= 1
    if variant == "greedy":
        # one schedule on both sides: everything equal
        assert ours["preemptions"] >= 1
        assert ours["requests"] == theirs["requests"]
        for key in ("preemptions", "pipelined", "rebuilds", "spec_chunks"):
            assert ours[key] == theirs[key], key
        return
    compared = 0
    for sp, mine, jax_req in zip(ours["specs"], ours["requests"], theirs["requests"]):
        if (sp["temperature"] == 0.0 and not sp["presence_penalty"]
                and not sp["frequency_penalty"]
                and mine["reason"] in ("stop", "length") and jax_req["reason"] in ("stop", "length")):
            assert mine["tokens"] == jax_req["tokens"] and mine["text"] == jax_req["text"]
            compared += 1
    assert compared >= 4


def test_soak_pool_preempts_while_pipelined_with_jax_tokens(jax_side, make_engine):
    """Without speculation on both sides: on this schedule the JAX engine's
    k = 2 verify emits a token that is not the greedy one (ROADMAP.md queue
    C), so the port's k = 2 run is held to the port's k = 0 run instead."""
    ours, theirs = run_preemptions(make_engine, {"speculate_k": 0}), jax_side["preemptions"]
    assert ours == theirs
    assert ours["preemptions"] >= 1 and ours["pipelined"] >= 1
    assert ours["free_pages"] == SOAK_SCHED["num_pages"] - 1
    assert all(len(t) == 24 for t in ours["tokens"])
    spec = run_preemptions(make_engine, {})
    assert spec["tokens"] == ours["tokens"] and spec["preemptions"] >= 1
    assert spec["free_pages"] == SOAK_SCHED["num_pages"] - 1
