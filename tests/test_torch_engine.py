"""The port's serving slice against the JAX package on the CPU: the JAX
``ContinuousBatchingEngine`` and the port's engine on bridged tiny weights
give identical greedy tokens; the port's copy of ``OpenAIServer`` serves
its engine, long prompts through chunked prefill; the shipped serving
flags (speculation, int8 weights, int8 KV) build engines that serve;
unported flags fail loudly, and ``seed`` is served. The shipped options' token parity
with the JAX engine is in ``test_torch_engine_parity.py``.
"""

import asyncio
import os

import jax
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer
from PIL import Image

from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine as JaxEngine
from dots_ocr_tpu.engine.scheduler import SchedulerConfig as JaxSched
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params, init_params
from dots_ocr_tpu_torch.serve import server as torch_server
from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer
from dots_ocr_tpu_torch.utils.image_io import pil_to_base64

CPU = torch.device("cpu")
RECEIPT = os.path.join(os.path.dirname(__file__), "..", "demo", "assets", "sample_receipt.png")
SCHED = dict(num_pages=64, page_size=8, max_slots=4, max_pages_per_seq=16,
             prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=4)


def _engine(params=None, **sched):
    cfg = DotsOCRConfig.tiny()
    if params is None:
        params = init_params(cfg, CPU, torch.Generator().manual_seed(0))
    return ContinuousBatchingEngine(params, cfg, CPU,
                                    sched=SchedulerConfig(**{**SCHED, **sched}),
                                    default_max_new_tokens=6)


def test_greedy_tokens_match_jax_engine():
    # scale 0.3: at the default 0.02 the tiny model emits one token forever
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=0.3)
    jeng = JaxEngine(jparams, JaxConfig.tiny(), sched=JaxSched(**SCHED))
    teng = _engine(from_numpy_params(jax.tree.map(np.asarray, jparams),
                                     DotsOCRConfig.tiny(), CPU))
    receipt = Image.open(RECEIPT)
    requests = [("Extract the text content from this image.", [receipt]),
                ("hello world", []), ("a second, longer text prompt", [])]
    outputs = []
    for eng in (jeng, teng):
        ids = [eng.submit(p, images=imgs, max_new_tokens=12, temperature=0.0,
                          max_pixels=28 * 28 * 12) for p, imgs in requests]
        eng.run()
        outputs.append([(eng.finished_request(i).output_ids,
                         eng.finished_request(i).finished_reason) for i in ids])
    assert outputs[0] == outputs[1]
    assert len({t for toks, _ in outputs[1] for t in toks}) > 12  # not one repeated token
    assert all(len(toks) >= 1 for toks, _ in outputs[1])
    assert teng.allocator.free_pages == SCHED["num_pages"] - 1


def test_stop_strings_stream_and_cancel():
    eng = _engine()
    deltas = []
    rid = eng.submit("hi", max_new_tokens=10, temperature=0.0,
                     stream_cb=lambda d, f: deltas.append((d, f)))
    eng.run()
    req = eng.finished_request(rid)
    assert deltas[-1][1] in ("stop", "length", "repetition")
    assert "".join(d for d, _ in deltas) == eng.take_finished(rid)
    assert eng.finished_request(rid) is None
    # stop ids end a request at the first occurrence, excluded from the text
    first = req.output_ids[0]
    rid = eng.submit("hi", max_new_tokens=10, temperature=0.0, stop_token_ids=[first])
    eng.run()
    done = eng.finished_request(rid)
    assert done.output_ids == [first] and done.finished_reason == "stop"
    # cancel frees the slot and pages
    rid = eng.submit("hi", max_new_tokens=10, temperature=0.0)
    eng.step()
    assert eng.cancel(rid) and eng.finished_request(rid).finished_reason == "cancelled"
    assert not eng.has_work() and eng.allocator.free_pages == SCHED["num_pages"] - 1


@pytest.mark.parametrize("kwargs", [{"seed": 3}])
def test_unported_features_raise(kwargs):
    """``seed`` was the last request option the port refused: a seeded
    request now keeps PRNGKey(seed) as its key, and a seed that is not an
    integer raises."""
    eng = _engine()
    eng.submit("hi", **kwargs)
    assert eng._waiting[-1].sample_key.tolist() == [0, kwargs["seed"]]
    with pytest.raises(ValueError):
        eng.submit("hi", seed="not a number")


def test_long_prompt_served_through_chunked_prefill():
    """A prompt longer than the chunk is served end to end through the
    port's OpenAIServer: several prefill chunks, interleaved with a
    short request's decode, and /metrics counts them."""
    eng = _engine(prefill_chunk_tokens=16)

    async def run():
        client = TestClient(TestServer(OpenAIServer(eng, model_name="torch").build_app()))
        await client.start_server()
        try:
            async def one(text):
                resp = await client.post("/v1/chat/completions", json={
                    "messages": [{"role": "user", "content": text}],
                    "max_tokens": 5, "temperature": 0})
                assert resp.status == 200
                return (await resp.json())["usage"]

            long, short = await asyncio.gather(one("x" * 60), one("hi"))
            assert long["prompt_tokens"] > 3 * 16 and long["completion_tokens"] >= 1
            assert short["completion_tokens"] >= 1
            metrics = await (await client.get("/metrics")).text()
            chunks = [int(line.split()[1]) for line in metrics.splitlines()
                      if line.startswith("dots_ocr_engine_prefill_chunks ")]
            assert chunks and chunks[0] >= 4
        finally:
            await client.close()

    asyncio.run(run())
    assert eng.allocator.free_pages == SCHED["num_pages"] - 1


def test_server_round_trip_on_port_engine():
    eng = _engine()
    img = pil_to_base64(Image.fromarray(
        np.random.RandomState(0).randint(0, 255, (56, 84, 3), np.uint8)))

    async def run():
        client = TestClient(TestServer(OpenAIServer(eng, model_name="torch").build_app()))
        await client.start_server()
        try:
            async def one(i):
                content = [{"type": "text", "text": f"req {i}"}]
                if i == 0:
                    content.insert(0, {"type": "image_url", "image_url": {"url": img}})
                resp = await client.post("/v1/chat/completions", json={
                    "messages": [{"role": "user", "content": content}],
                    "max_tokens": 5, "temperature": 0})
                assert resp.status == 200
                data = await resp.json()
                assert data["choices"][0]["finish_reason"] in ("stop", "length", "repetition")
                return data["usage"]["completion_tokens"]

            assert all(c >= 1 for c in await asyncio.gather(*[one(i) for i in range(4)]))
            resp = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "x"}], "seed": 1})
            assert resp.status == 200
            metrics = await (await client.get("/metrics")).text()
            assert "dots_ocr_engine_prefills 5" in metrics
        finally:
            await client.close()

    asyncio.run(run())
    assert eng.allocator.free_pages == SCHED["num_pages"] - 1


@pytest.mark.parametrize("flags", [
    ["--engine", "batch", "--tensor-parallel-size", "2"],
    ["--quantize", "int4", "--tensor-parallel-size", "2"],
    ["--tensor-parallel-size", "2"], ["--tensor-parallel-size", "2", "--warmup", "background"],
    ["--tensor-parallel-size", "4", "--vision-attn", "windowed"],
    ["--weights", "ckpt", "--tensor-parallel-size", "8", "--warmup", "background"],
    ["--tensor-parallel-size", "2", "--compile-cache", "c"],
])
def test_server_refuses_unported_flags(flags):
    """What TP does not serve is refused whatever else is asked for, the
    warmup and compile-cache flags included (before the cache directory is
    touched): ``--engine batch`` and ``--quantize int4`` with TP, and the
    default nccl backend without a CUDA device a rank (here, none)."""
    args = torch_server.build_parser().parse_args(["--random-tiny", "--platform", "cpu"] + flags)
    with pytest.raises(SystemExit, match="--tensor-parallel-size"):
        torch_server.build_engine(args)


SMALL = ["--num-pages", "64", "--page-size", "8", "--max-slots", "4",
         "--max-seq-tokens", "128", "--steps-per-sync", "4"]


@pytest.mark.parametrize("flags", [
    ["--speculate-k", "2", "--spec-min-tokens-per-iter", "0"],
    ["--quantize", "int8"],
    ["--kv-cache-dtype", "int8"],
    ["--quantize", "int8", "--kv-cache-dtype", "int8", "--speculate-k", "2",
     "--prefill-chunk-tokens", "16"],
    ["--quantize", "int4", "--vision-quantize", "int8", "--kv-cache-dtype", "int8",
     "--speculate-k", "2", "--prefill-chunk-tokens", "16"],
])
def test_server_builds_shipped_flag_engines_that_serve(flags):
    """The shipped serving flags, and the fully quantized configuration,
    build a CPU engine that serves requests: speculation runs verify
    chunks, int8 weights and the int8 pool are in place, and a long prompt
    takes the chunked prefill. ``--quantize int4`` on the tiny config
    (hidden 64, not int4-aligned) falls back to int8 kernel by kernel;
    ``--vision-quantize int8`` makes the vision block linears W8A8."""
    args = torch_server.build_parser().parse_args(
        ["--random-tiny", "--platform", "cpu"] + SMALL + flags)
    eng = torch_server.build_engine(args)
    assert eng.sched.speculate_k == args.speculate_k
    assert eng.sched.spec_min_tokens_per_iter == args.spec_min_tokens_per_iter
    texts = eng.generate_batch(["hello there", "y" * 30], temperature=0.0, max_new_tokens=8)
    assert len(texts) == 2 and eng.metrics["generated_tokens"] >= 2 and not eng.has_work()
    if args.speculate_k:
        assert eng.metrics["spec_chunks"] >= 1 and eng.metrics["spec_emitted"] >= 2
    if args.quantize in ("int8", "int4"):
        assert eng.params["decoder"]["blocks"]["mlp"]["up"]["qint8"].dtype == torch.int8
        assert eng.params["decoder"]["embed"]["scale"].dtype == torch.float32
    if args.vision_quantize == "int8":
        assert eng.params["vision"]["blocks"]["attn"]["wq"]["qint8_act"].dtype == torch.int8
    if args.kv_cache_dtype == "int8":
        assert eng.paged.quantized and eng.paged.v[0].dtype == torch.int8
    if args.prefill_chunk_tokens == 16:
        assert eng.metrics["prefill_chunks"] >= 2


def test_server_builds_windowed_engine_and_full_clears_it(monkeypatch):
    """``--vision-attn windowed`` with a window and full layers builds a
    windowed tiny engine that serves an image (window-major packs); the
    ``full`` override clears a window the config has."""
    args = torch_server.build_parser().parse_args(
        ["--random-tiny", "--platform", "cpu", *SMALL, "--kv-cache-dtype", "int8",
         "--vision-attn", "windowed", "--vision-window-patches", "4",
         "--vision-full-layers", "1"])
    eng = torch_server.build_engine(args)
    assert eng.config.vision.window_size == 4 and eng.config.vision.full_attn_layers == (1,)
    img = Image.fromarray(np.random.RandomState(1).randint(0, 255, (56, 84, 3), np.uint8))
    texts = eng.generate_batch(["read this"], [[img]], temperature=0.0, max_new_tokens=4)
    assert len(texts) == 1 and eng.metrics["prefills"] == 1 and not eng.has_work()
    packed = eng.prepare("read this", [img]).packed
    assert packed.window_ids is not None and len(packed.segment_ids) % 16 == 0
    windowed = eng.config
    args = torch_server.build_parser().parse_args(
        ["--random-tiny", "--platform", "cpu", *SMALL, "--vision-attn", "full"])
    monkeypatch.setattr(DotsOCRConfig, "tiny", staticmethod(lambda: windowed))
    eng = torch_server.build_engine(args)
    assert eng.config.vision.window_size == 0 and eng.config.vision.full_attn_layers == ()


def test_spec_gate_turns_speculation_off_and_back_on():
    """Below the break-even for 3 chunks in a row, speculation stops for
    the current load and re-probes once the engine drains. The gate reads
    a chunk when it lands: synchronous, after the third verify chunk;
    pipelined (the default), the fourth is already in flight then."""
    for pipeline, verify_chunks in ((False, 3), (True, 4)):
        eng = _engine(speculate_k=2, spec_min_tokens_per_iter=10.0, pipeline_decode=pipeline)
        eng.generate_batch(["hello", "world"], temperature=0.0, max_new_tokens=60)
        assert eng.metrics["spec_chunks"] == verify_chunks
        assert eng.metrics["spec_auto_disabled"] == 1
        assert eng.metrics["steps"] > verify_chunks  # plain chunks after the gate closed
        assert (eng.metrics["pipelined_chunks"] > 0) == pipeline
        assert eng._spec_enabled  # drained: the next load probes again


def test_server_builds_cpu_engine_warms_up_and_refuses_missing_cuda():
    # a geometry that holds the 560 x 420 warm page and keeps the CPU
    # warmup's decode programs small
    args = torch_server.build_parser().parse_args(
        ["--random-tiny", "--platform", "cpu", "--num-pages", "128", "--page-size", "8",
         "--max-slots", "4", "--max-seq-tokens", "512", "--steps-per-sync", "4"])
    eng = torch_server.build_engine(args)
    assert eng.device.type == "cpu"
    warm = torch_server.warm_up(eng)
    assert eng.metrics["prefills"] == 2 and not eng.has_work()
    assert warm["thunks"] == 4 and warm["graphs"] == 0 and warm["pool_bytes"] is None
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            torch_server.build_engine(torch_server.build_parser().parse_args(["--random-tiny"]))
