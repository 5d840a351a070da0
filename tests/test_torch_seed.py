"""Per-request ``seed`` and scheduling-invariant sampling in the port's
continuous engine, held to the JAX engine's tokens (the port's
counterparts of ``tests/test_seed.py``'s 8 cases, plus k = 2 and chunked
prefill).

Both engines run ``DotsOCRConfig.tiny()`` in float32 on the same weights
(scale 0.3), sampling at temperature 0.7 with top_p 0.9 (the nucleus
pool) or 1.0 (full-vocabulary draws). The port's attention runs the JAX
engine's CPU path (the ``"xla"`` implementations), so both compute the
same function; draws are ``jax.random``'s bit for bit (Gumbel noise to an
ulp of XLA:CPU's ``log``), so the token streams must be equal.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine as JaxEngine
from dots_ocr_tpu.engine.scheduler import SchedulerConfig as JaxSched
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.ops import flash_attention, paged_attention

SCHED = dict(num_pages=96, page_size=8, max_slots=4, max_pages_per_seq=8,
             prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=4)
TEMP = 0.7


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=0.3)
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), DotsOCRConfig.tiny(),
                                torch.device("cpu"))
    return jparams, tparams


@pytest.fixture(autouse=True)
def xla_attention(monkeypatch):
    for ops in (flash_attention, paged_attention):
        monkeypatch.setitem(ops.IMPLEMENTATIONS, "kernel", ops.IMPLEMENTATIONS["xla"])


def _engines(weights, **overrides):
    """A (JAX, port) engine pair on the same weights and settings."""
    jparams, tparams = weights
    sched = {**SCHED, **overrides}
    return (JaxEngine(jparams, JaxConfig.tiny(), sched=JaxSched(**sched),
                      default_max_new_tokens=16),
            ContinuousBatchingEngine(tparams, DotsOCRConfig.tiny(), torch.device("cpu"),
                                     sched=SchedulerConfig(**sched), default_max_new_tokens=16))


def _drain(eng):
    while eng.has_work():
        eng.step()


def _tokens_of(eng, rid):
    req = eng.finished_request(rid)
    toks = list(req.prior_output) + list(req.output_ids)
    eng.take_finished(rid)
    return toks, req


def _run_one(eng, prompt, seed, max_new=14, top_p=0.9):
    rid = eng.submit(prompt, temperature=TEMP, top_p=top_p, seed=seed, max_new_tokens=max_new)
    _drain(eng)
    return _tokens_of(eng, rid)[0]


def _both(weights, fn, **overrides):
    """fn(engine) on a fresh JAX engine and a fresh port engine."""
    return [fn(eng) for eng in _engines(weights, **overrides)]


@pytest.mark.parametrize("top_p", [0.9, 1.0])
def test_seeded_request_invariant_to_cobatching(weights, top_p):
    def scenario(eng):
        alone = _run_one(eng, "the quick brown fox", seed=42, top_p=top_p)
        rid = eng.submit("the quick brown fox", temperature=TEMP, top_p=top_p, seed=42,
                         max_new_tokens=14)
        others = [eng.submit(f"other request {i}", temperature=TEMP, top_p=top_p,
                             max_new_tokens=14) for i in range(3)]
        _drain(eng)
        got = _tokens_of(eng, rid)[0]
        return alone, got, [_tokens_of(eng, o)[0] for o in others]

    (j_alone, j_got, j_others), (t_alone, t_got, t_others) = _both(weights, scenario)
    assert t_alone == t_got == j_alone == j_got
    assert t_others == j_others  # unseeded co-batched streams: the engine chain


def test_same_seed_across_engine_instances(weights):
    jax_eng, port_eng = _engines(weights)
    ja = _run_one(jax_eng, "reproducible stream", seed=7)
    ta = _run_one(port_eng, "reproducible stream", seed=7)
    tb = _run_one(_engines(weights)[1], "reproducible stream", seed=7)
    jc = _run_one(_engines(weights)[0], "reproducible stream", seed=8)
    tc = _run_one(_engines(weights)[1], "reproducible stream", seed=8)
    assert ta == tb == ja
    assert tc == jc and ta != tc


def test_full_vocab_rows_also_reproducible(weights):
    def scenario(eng):
        rid = eng.submit("full vocab sampling", temperature=1.0, top_p=1.0, seed=123,
                         max_new_tokens=12)
        _drain(eng)
        return _tokens_of(eng, rid)[0]

    jtoks, ttoks = _both(weights, scenario)
    assert ttoks == jtoks and len(ttoks) >= 2


def test_preemption_replays_identical_stream(weights):
    def scenario(eng):
        rid = eng.submit("preempt me please", temperature=TEMP, top_p=0.9, seed=99,
                         max_new_tokens=20)
        eng.step()
        eng.step()
        assert eng.finished_request(rid) is None, "must still be mid-decode"
        if hasattr(eng, "_drain_inflight"):
            eng._drain_inflight()  # the port lands its pipelined chunk first
        eng._preempt_youngest()
        _drain(eng)
        toks, req = _tokens_of(eng, rid)
        assert req.preempted == 1
        return toks

    refs = _both(weights, lambda eng: _run_one(eng, "preempt me please", seed=99, max_new=20))
    replays = _both(weights, scenario)
    assert refs[1] == replays[1] == refs[0] == replays[0]


def test_unseeded_requests_draw_distinct_streams(weights):
    def scenario(eng):
        r1 = eng.submit("identical prompt", temperature=1.0, top_p=1.0, max_new_tokens=12)
        r2 = eng.submit("identical prompt", temperature=1.0, top_p=1.0, max_new_tokens=12)
        _drain(eng)
        return _tokens_of(eng, r1)[0], _tokens_of(eng, r2)[0]

    (j1, j2), (t1, t2) = _both(weights, scenario)
    assert (t1, t2) == (j1, j2) and t1 != t2


def test_greedy_ignores_seed(weights):
    eng = _engines(weights)[1]
    a = eng.generate_one("greedy text", temperature=0.0, max_new_tokens=8)
    rid = eng.submit("greedy text", temperature=0.0, seed=5, max_new_tokens=8)
    _drain(eng)
    assert a == eng.take_finished(rid)


def test_http_seed_validation_and_reproducibility(weights):
    """'seed' must be an integer; equal seeds give equal completions through
    the port server's HTTP path, and the JAX engine's text."""
    from aiohttp.test_utils import TestClient, TestServer

    from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer

    jax_eng, eng = _engines(weights)
    server = OpenAIServer(eng, model_name="tiny")
    assert server._validate_params({"seed": "abc"}) is not None
    assert server._validate_params({"seed": True}) is not None
    assert server._validate_params({"seed": 42}) is None
    rid = jax_eng.submit("http seeded", temperature=TEMP, top_p=0.9, seed=11, max_new_tokens=10)
    _drain(jax_eng)
    want = jax_eng.take_finished(rid)

    async def run():
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            texts = []
            for _ in range(2):
                resp = await client.post("/v1/chat/completions", json={
                    "messages": [{"role": "user", "content": "http seeded"}],
                    "max_tokens": 10, "temperature": TEMP, "top_p": 0.9, "seed": 11})
                assert resp.status == 200
                texts.append((await resp.json())["choices"][0]["message"]["content"])
            return texts
        finally:
            await client.close()

    a, b = asyncio.run(run())
    assert a == b == want


def test_seed_sequence_matches_serial_generate_one(weights):
    def serial(eng_index):
        out = []
        for s in (100, 101, 102):
            eng = _engines(weights)[eng_index]
            out.append(eng.generate_one("page text here", temperature=TEMP, top_p=0.9, seed=s,
                                        max_new_tokens=12))
        return out

    j_serial, t_serial = serial(0), serial(1)
    eng = _engines(weights)[1]
    batched = eng.generate_batch(["page text here"] * 3, [[], [], []], temperature=TEMP,
                                 top_p=0.9, seed=[100, 101, 102], max_new_tokens=12)
    assert batched == t_serial == j_serial
    assert len(set(t_serial)) > 1
    with pytest.raises(ValueError, match="seed sequence length"):
        eng.generate_batch(["a", "b"], [[], []], seed=[1])


@pytest.mark.parametrize("overrides", [dict(speculate_k=2, spec_min_tokens_per_iter=0.0),
                                       dict(prefill_chunk_tokens=16)],
                         ids=["k2", "chunked"])
def test_seeded_streams_equal_jax_under_k2_and_chunked_prefill(weights, overrides):
    """The k = 2 verify (acceptance uniforms and corrective draws keyed per
    iteration) and chunked prefill's first token keep the JAX engine's
    sampled tokens, nucleus and full-vocabulary rows together."""
    def scenario(eng):
        ids = [eng.submit("speculate on this " * 2, temperature=TEMP, top_p=0.9, seed=5,
                          max_new_tokens=16),
               eng.submit("and on this one", temperature=TEMP, top_p=1.0, seed=6,
                          max_new_tokens=16)]
        _drain(eng)
        return [_tokens_of(eng, rid)[0] for rid in ids], dict(eng.metrics)

    (jtoks, jm), (ttoks, tm) = _both(weights, scenario, **overrides)
    assert ttoks == jtoks
    if "speculate_k" in overrides:
        assert tm["spec_chunks"] >= 1 and jm["spec_chunks"] >= 1
    else:
        assert tm["prefill_chunks"] >= 2
