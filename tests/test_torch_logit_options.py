"""The OpenAI logit options in the port's engine against the JAX engine, on
the CPU (tiny config, float32, bridged weights; the JAX engine runs in a
subprocess as in ``test_torch_engine_parity.py``): the cases of
``test_logprobs.py``, ``test_penalties.py`` and ``test_logit_bias.py``.

- logprobs: each generated token's log-probability, within LOGPROB_ATOL of
  the JAX engine's and of a teacher-forced dense forward of the port over
  prompt + output, the first token included (after monolithic and chunked
  prefill); a co-batched request without logprobs is unchanged.
- presence/frequency penalties: greedy tokens equal the JAX engine's and a
  teacher-forced argmax of the penalized logits; an unpenalized neighbour
  is unchanged.
- logit_bias: a ban keeps the banned token out, the first token after
  monolithic and chunked prefill included; a boost makes every token the
  boosted one; the bias composes with k = 2 speculation exactly;
  oversized biases are rejected and out-of-vocabulary ids are inert.
- speculation stays off while a logprobs or penalized request is live.
- the port's server carries the options over HTTP, ``seed`` included.
"""

import asyncio
import inspect
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.decoder import decoder_prefill, embed_tokens, logits_from_hidden
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# Both engines compute in float32; the paged decode and the dense
# teacher-forced forward sum in other orders (~1e-6 apart).
LOGPROB_ATOL = 1e-4
BASE = dict(num_pages=96, page_size=8, max_slots=4, max_pages_per_seq=16,
            prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=4,
            repetition_min_repeats=0)
CHUNKED = dict(prefill_chunk_tokens=16)  # "check my logprobs" (36 tokens) takes 3 chunks
# name: (scheduler overrides, [(prompt, max_new_tokens, submit options)])
SCENARIOS = {
    "logprobs": ({}, [("check my logprobs", 8, {"logprobs": True}),
                      ("neighbor text", 8, {})]),
    "logprobs_chunked": (CHUNKED, [("check my logprobs", 8, {"logprobs": True})]),
    "logprobs_k3": (dict(speculate_k=3), [("spec vs logprobs", 10, {"logprobs": True})]),
    # the greedy outputs of the first two prompts repeat tokens within 24
    "penalties": ({}, [("penalty differential", 24,
                        {"presence_penalty": 0.7, "frequency_penalty": 0.4}),
                       ("hello world", 24, {"presence_penalty": 1.0, "frequency_penalty": 2.0}),
                       ("innocent neighbor", 8, {})]),
    "penalties_k3": (dict(speculate_k=3), [("spec gate", 8, {"presence_penalty": 0.5})]),
    "plain": ({}, [("penalty differential", 24, {}), ("hello world", 24, {}),
                   ("innocent neighbor", 8, {})]),
}
BIAS_PROMPT, BOOST_ID = "bias me", 42
BIAS_CONFIGS = {"monolithic": {}, "chunked": dict(prefill_chunk_tokens=8),
                "k2": dict(speculate_k=2, spec_min_tokens_per_iter=0.0)}


# The scenarios run on both sides: their source also runs in the JAX
# subprocess, against the JAX engine.
def run_scenario(make_engine, kw, requests):
    eng = make_engine(kw)
    ids = [eng.submit(p, temperature=0.0, max_new_tokens=n, **opts) for p, n, opts in requests]
    eng.run()
    reqs = [eng.finished_request(i) for i in ids]
    return dict(tokens=[r.prior_output + r.output_ids for r in reqs],
                logprobs=[list(r.output_logprobs) for r in reqs],
                prompts=[r.prompt_ids for r in reqs],
                spec_chunks=eng.metrics.get("spec_chunks", 0))


def run_bias(make_engine, kw, prompt, boost_id):
    eng = make_engine(kw)

    def one(**opts):
        rid = eng.submit(prompt, temperature=0.0, max_new_tokens=6, **opts)
        eng.run()
        return eng.finished_request(rid).output_ids

    plain = one()
    return dict(plain=plain, ban=one(logit_bias={plain[0]: -100.0}),
                boost=one(logit_bias={boost_id: 100.0}),
                oov=one(logit_bias={10**7: -100.0, -5: 50.0}),
                spec_chunks=eng.metrics.get("spec_chunks", 0))


JAX_SIDE = "\n".join(inspect.getsource(f) for f in (run_scenario, run_bias)) + '''
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


out = {name: run_scenario(make_engine, kw, reqs) for name, (kw, reqs) in spec["scenarios"].items()}
out["bias"] = {name: run_bias(make_engine, kw, spec["bias_prompt"], spec["boost_id"])
               for name, kw in spec["bias_configs"].items()}
print(json.dumps(out))
'''


@pytest.fixture(scope="module")
def jax_side():
    spec = dict(base=BASE, scenarios=SCENARIOS, bias_configs=BIAS_CONFIGS,
                bias_prompt=BIAS_PROMPT, boost_id=BOOST_ID)
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


def dense_logits(params, prompt_ids, tokens) -> np.ndarray:
    """Teacher-forced float64 logits of the port's dense forward at the
    positions that predict each generated token."""
    cfg = DotsOCRConfig.tiny().decoder
    ids = torch.tensor([prompt_ids + tokens])
    t = ids.shape[1]
    hidden, _ = decoder_prefill(params["decoder"], cfg, embed_tokens(params["decoder"], ids),
                                torch.arange(t)[None], torch.tensor([t]))
    logits = logits_from_hidden(params["decoder"], cfg, hidden)[0].double().numpy()
    return logits[len(prompt_ids) - 1:len(prompt_ids) - 1 + len(tokens)]


@pytest.mark.parametrize("name", ["logprobs", "logprobs_chunked", "logprobs_k3"])
def test_logprobs_match_jax_engine_and_teacher_forcing(jax_side, make_engine, params, name):
    kw, requests = SCENARIOS[name]
    ours, theirs = run_scenario(make_engine, kw, requests), jax_side[name]
    assert ours["tokens"] == theirs["tokens"]
    toks, lps = ours["tokens"][0], ours["logprobs"][0]
    assert len(lps) == len(toks) == requests[0][1]
    np.testing.assert_allclose(lps, theirs["logprobs"][0], rtol=0, atol=LOGPROB_ATOL)
    logits = dense_logits(params, ours["prompts"][0], toks)
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    want = logits[np.arange(len(toks)), toks] - lse
    np.testing.assert_allclose(lps, want, rtol=0, atol=LOGPROB_ATOL)
    assert all(lp <= 0 for lp in lps)
    plain = run_scenario(make_engine, {}, [(p, n, {}) for p, n, _ in requests])
    assert ours["tokens"] == plain["tokens"]  # logprobs change no token
    assert all(lp == [] for lp in ours["logprobs"][1:])  # nor a neighbour's output
    if name == "logprobs_k3":
        assert ours["spec_chunks"] == theirs["spec_chunks"] == 0


def test_penalized_greedy_tokens_match_jax_engine(jax_side, make_engine, params):
    kw, requests = SCENARIOS["penalties"]
    ours = run_scenario(make_engine, kw, requests)
    assert ours["tokens"] == jax_side["penalties"]["tokens"]
    # each choice is the argmax of the teacher-forced penalized logits
    for j in (0, 1):
        toks, opts = ours["tokens"][j], requests[j][2]
        pres, freq = opts.get("presence_penalty", 0.0), opts.get("frequency_penalty", 0.0)
        counts = np.zeros(DotsOCRConfig.tiny().decoder.vocab_size)
        for k, row in enumerate(dense_logits(params, ours["prompts"][j], toks)):
            assert int(np.argmax(row - pres * (counts > 0) - freq * counts)) == toks[k]
            counts[toks[k]] += 1
    plain = jax_side["plain"]["tokens"]
    for j in (0, 1):  # the penalties change the output: fewer repeats
        assert ours["tokens"][j] != plain[j]
        assert len(set(ours["tokens"][j])) > len(set(plain[j]))
    assert ours["tokens"][2] == plain[2]  # the unpenalized neighbour is unchanged


@pytest.mark.parametrize("name", ["penalties_k3", "logprobs_k3"])
def test_speculation_stays_off_while_logprobs_or_penalties_are_live(jax_side, make_engine, name):
    kw, requests = SCENARIOS[name]
    eng = make_engine(kw)
    rid = eng.submit(requests[0][0], temperature=0.0, max_new_tokens=requests[0][1],
                     **requests[0][2])
    eng.run()
    assert eng.metrics["spec_chunks"] == 0 and eng.metrics["steps"] >= 1
    assert eng.finished_request(rid).output_ids == jax_side[name]["tokens"][0]
    # a later plain request speculates again
    eng.submit("spec back on", temperature=0.0, max_new_tokens=8)
    eng.run()
    assert eng.metrics["spec_chunks"] >= 1


@pytest.mark.parametrize("name", sorted(BIAS_CONFIGS))
def test_logit_bias_matches_jax_engine(jax_side, make_engine, name):
    ours = run_bias(make_engine, BIAS_CONFIGS[name], BIAS_PROMPT, BOOST_ID)
    theirs = jax_side["bias"][name]
    for key in ("plain", "ban", "boost", "oov"):
        assert ours[key] == theirs[key], key
    assert ours["plain"][0] not in ours["ban"]  # the first token included
    assert ours["boost"] == [BOOST_ID] * 6
    assert ours["oov"] == ours["plain"]
    if name == "chunked":
        assert len(make_engine(BIAS_CONFIGS[name]).prepare(BIAS_PROMPT).prompt_ids) > 16
    if name == "k2":  # the bias composes with the verify: speculation stayed on
        assert ours["spec_chunks"] >= 1
        assert ours["ban"] == run_bias(make_engine, {}, BIAS_PROMPT, BOOST_ID)["ban"]


def test_submit_validates_logit_bias(make_engine):
    eng = make_engine({})
    with pytest.raises(ValueError, match="at most 32"):
        eng.submit("too many", logit_bias={i: 1.0 for i in range(33)})
    rid = eng.submit("inert", logit_bias={10**7: -100.0, -5: 50.0})
    assert eng._waiting[-1].req_id == rid and eng._waiting[-1].logit_bias is None
    eng.submit("seeded", seed=1)  # seeds are served: the request keeps PRNGKey(1)
    assert eng._waiting[-1].sample_key.tolist() == [0, 1]


def test_http_logit_options_on_the_port_server(make_engine):
    eng = make_engine({})

    async def run():
        client = TestClient(TestServer(OpenAIServer(eng, model_name="tiny").build_app()))
        await client.start_server()

        async def post(**body):
            resp = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "options"}], "max_tokens": 6,
                "temperature": 0, **body})
            return resp.status, await resp.json()

        try:
            status, data = await post(logprobs=True)
            assert status == 200
            choice = data["choices"][0]
            content = choice["logprobs"]["content"]
            assert len(content) == data["usage"]["completion_tokens"] == 6
            assert all(e["logprob"] <= 0 and isinstance(e["bytes"], list) for e in content)
            assert "".join(e["token"] for e in content) == choice["message"]["content"]
            assert (await post(logprobs=True, top_logprobs=2))[0] == 400
            assert (await post(logprobs=True, stream=True))[0] == 400
            status, data = await post(frequency_penalty=1.0, presence_penalty=0.5)
            assert status == 200 and data["usage"]["completion_tokens"] == 6
            assert (await post(presence_penalty=3.0))[0] == 400
            status, data = await post(logit_bias={str(BOOST_ID): 100})
            assert status == 200 and data["usage"]["completion_tokens"] == 6
            assert (await post(logit_bias={"x": 1.0}))[0] == 400
            assert (await post(logit_bias={str(i): 1 for i in range(40)}))[0] == 400
            status, data = await post(seed=1)
            assert status == 200 and data["usage"]["completion_tokens"] == 6
        finally:
            await client.close()

    asyncio.run(run())
    assert not eng.has_work() and eng.allocator.free_pages == BASE["num_pages"] - 1
