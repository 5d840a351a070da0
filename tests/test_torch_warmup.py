"""The port's warmup and its graph-keyed decode chunks against the JAX
engine, on the CPU (tiny config, float32, bridged weights).

The JAX warmup tests (``test_paged.py``'s warmup cases and
``test_server.py::test_background_warmup_drains_while_serving``) replayed
on the port: the warmup is inert, ``max_len`` bounds the plan, the ticks
drain the queue and yield to live traffic, a drained queue is inert, and
the background server drains to ``dots_ocr_engine_warm_pending 0`` while a
request sent mid-warm succeeds. The port's plan is the JAX plan at one
page-table width (the port's tables are always ``max_pages_per_seq``
wide), in the same order; greedy tokens after the warmup equal the JAX
engine's. On the CPU nothing is captured: each thunk runs its program
once, as the JAX thunk does. The server's ``--warmup`` and
``--compile-cache`` flags, the chunk inputs' fixed buffers, the graph key
and the launch counters' bookkeeping are held here too; the graphs
themselves run in ``test_torch_cuda.py`` on the card.
"""

import asyncio
import functools
import os
import subprocess
import time

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
from dots_ocr_tpu_torch.engine import graphs
from dots_ocr_tpu_torch.engine.scheduler import (
    ContinuousBatchingEngine,
    SchedulerConfig,
    decode_program,
    spec_decode_program,
)
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.ops import kernel_lib
from dots_ocr_tpu_torch.serve import server as torch_server
from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
RECEIPT = os.path.join(REPO, "demo", "assets", "sample_receipt.png")
# test_paged.py's cb_engine geometry (steps_per_sync 8, max_steps_per_sync 64)
SCHED = dict(num_pages=64, page_size=8, max_slots=4, max_pages_per_seq=16,
             prompt_bucket_step=32, vision_bucket_step=16)


@functools.lru_cache(maxsize=None)
def _weights(scale: float = 0.02):
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=scale)
    return jparams, from_numpy_params(jax.tree.map(np.asarray, jparams),
                                      DotsOCRConfig.tiny(), CPU)


def _port(scale: float = 0.02, **sched):
    return ContinuousBatchingEngine(_weights(scale)[1], DotsOCRConfig.tiny(), CPU,
                                    sched=SchedulerConfig(**{**SCHED, **sched}),
                                    default_max_new_tokens=8)


def _jax(scale: float = 0.02, **sched):
    return JaxEngine(_weights(scale)[0], JaxConfig.tiny(), sched=JaxSched(**{**SCHED, **sched}),
                     default_max_new_tokens=8)


def jax_width_buckets(eng, max_len) -> int:
    """The page-table widths the JAX engine's plan warms (its
    ``warmup_plan`` loop): 1 on a static-width route, else the powers of
    two up to ``max_len``'s pages (capped by ``max_pages_per_seq``)."""
    if eng._static_width:
        return 1
    cap = eng.sched.max_pages_per_seq
    top = cap if max_len is None else min(eng.allocator.pages_needed(max_len), cap)
    n, w = 1, 1
    while w < top:
        w, n = w * 2, n + 1
    return n


def jax_thunk(thunk) -> tuple:
    """A JAX plan thunk as (speculative, depth, nucleus, table width)."""
    cells = dict(zip(thunk.__code__.co_freevars, (c.cell_contents for c in thunk.__closure__)))
    return ("spec_thunk" in thunk.__qualname__, cells["depth"], cells["nucleus"],
            cells["tables"].shape[1])


def port_thunk(thunk) -> tuple:
    spec_k, depth, nucleus = thunk.args
    return (spec_k > 0, depth, nucleus)


# -- test_paged.py:332-406 on the port ---------------------------------------


def test_warmup_decode_precompiles_and_is_inert():
    """warmup_decode on an idle engine runs every thunk without changing
    later greedy output or leaking pages or slots; the JAX engine's count
    is the port's times its width buckets (10 = 2 depths x 5 widths)."""
    eng, jeng = _port(), _jax()
    before = eng.generate_one("warmup probe", temperature=0.0, max_new_tokens=6)
    n = eng.warmup_decode(nucleus_variants=(False,))
    jax_n = len(jeng.warmup_plan(nucleus_variants=(False,)))
    assert jax_n == 10 and n == jax_n // jax_width_buckets(jeng, None) == 2
    assert eng.allocator.free_pages == 63
    assert all(r is None for r in eng._slot_req)
    after = eng.generate_one("warmup probe", temperature=0.0, max_new_tokens=6)
    assert before == after
    assert eng.metrics["graph_captures"] == eng.metrics["graph_replays"] == 0  # CPU
    with pytest.raises(RuntimeError, match="idle"):
        eng.submit("busy", max_new_tokens=2, temperature=0.0)
        eng.warmup_decode()


def test_warmup_decode_max_len_bounds_widths():
    # 3 tokens + page_size 8 -> 1 page -> one width on both engines (x2 depths)
    eng, jeng = _port(), _jax()
    assert eng.warmup_decode(max_len=3, nucleus_variants=(False,)) == 2
    assert len(jeng.warmup_plan(max_len=3, nucleus_variants=(False,))) == 2


def test_incremental_warmup_ticks_drain_and_yield_to_traffic():
    """queue_warmup + warm_tick run the plan one thunk per tick (the first
    SUBMITS vision + text warm requests that drain through the step loop),
    refuse to run while requests are live, and leave later greedy output
    unchanged; a drained queue is inert."""
    eng = _port()
    before = eng.generate_one("inc warm probe", temperature=0.0, max_new_tokens=6)
    n = eng.queue_warmup(nucleus_variants=(False,))
    assert n == eng.warm_pending > 1
    rid = eng.submit("busy", max_new_tokens=4, temperature=0.0)
    assert eng.warm_tick() is False  # a live request blocks warm ticks
    while eng.has_work():
        eng.step()
    eng.take_finished(rid)
    ticks = 0
    while eng.warm_pending:
        if eng.warm_tick():
            ticks += 1
        while eng.has_work():  # the warm requests, as the server loop drains them
            eng.step()
    assert ticks == n and eng.warm_pending == 0
    assert eng.warm_tick() is False
    # the probe, "busy" and the warm text; the 560 x 420 warm page exceeds
    # this geometry's 128-token envelope and is refused, as in the JAX test
    assert eng.metrics["prefills"] == 3
    for wrid in list(eng._finished):
        eng.take_finished(wrid)
    after = eng.generate_one("inc warm probe", temperature=0.0, max_new_tokens=6)
    assert before == after
    assert eng.allocator.free_pages == 63


def test_warm_tick_waits_for_a_chunk_in_flight():
    """A pipelined chunk in flight is live work: no tick runs until it lands."""
    eng = _port(steps_per_sync=2, max_steps_per_sync=4)
    eng.queue_warmup(nucleus_variants=(False,), vision_sizes=())
    eng.submit("in flight", max_new_tokens=24, temperature=0.0)
    while eng._inflight is None:
        eng.step()
    assert eng.warm_tick() is False and eng.warm_pending == 3
    eng.run()
    assert eng.warm_tick() is True and eng.warm_pending == 2


# -- test_server.py:305-361 on the port ---------------------------------------


def test_background_warmup_drains_while_serving():
    """--warmup background: the worker loop runs warm ticks on idle, the
    queue drains to zero, and a request served mid-warm still succeeds."""
    engine = _port(steps_per_sync=4)
    engine.default_max_new_tokens = 6
    n = engine.queue_warmup(nucleus_variants=(False,))
    assert n > 1

    async def run():
        server = OpenAIServer(engine, model_name="cb-model")
        client = TestClient(TestServer(server.build_app()))
        await client.start_server()
        try:
            resp = await client.post("/v1/chat/completions", json={
                "messages": [{"role": "user", "content": "mid warm"}],
                "max_tokens": 4, "temperature": 0})
            assert resp.status == 200
            deadline = time.time() + 120
            while engine.warm_pending and time.time() < deadline:
                await asyncio.sleep(0.5)
            assert engine.warm_pending == 0
            m = await (await client.get("/metrics")).text()
            assert "dots_ocr_engine_warm_pending 0" in m
            assert "dots_ocr_engine_graph_captures 0" in m
        finally:
            await client.close()

    asyncio.run(run())
    assert engine.allocator.free_pages == 63


# -- the plan against the JAX plan ------------------------------------------


@pytest.mark.parametrize("sched", [
    {}, dict(speculate_k=2), dict(steps_per_sync=4, max_steps_per_sync=4),
    dict(speculate_k=3, steps_per_sync=16, max_steps_per_sync=64),
    dict(speculate_k=2, steps_per_sync=4, max_steps_per_sync=12),
], ids=["plain", "k2", "shallow_only", "k3_deep", "k2_spec_deep_equals_shallow"])
@pytest.mark.parametrize("max_len", [None, 3, 100])
@pytest.mark.parametrize("variants", [(False,), (False, True)])
def test_plan_is_the_jax_plan_at_one_width(sched, max_len, variants):
    """The port's thunks are the JAX plan's at each width, in its order
    (nucleus variant, then speculative before plain, shallow before deep);
    so the port's count is the JAX count over its width buckets."""
    eng, jeng = _port(**sched), _jax(**sched)
    port = [port_thunk(t) for t in eng.warmup_plan(max_len, variants)]
    jax_plan = [jax_thunk(t) for t in jeng.warmup_plan(max_len, variants)]
    widths = sorted({w for *_, w in jax_plan})
    assert len(widths) == jax_width_buckets(jeng, max_len)
    for w in widths:
        assert [t[:3] for t in jax_plan if t[3] == w] == port
    assert len(port) == len(jax_plan) // len(widths)


def test_shipping_env_plan():
    """deploy/shipping.env's scheduler (k = 2, steps 16, deep 64): spec
    depths 16 and 21, decode depths 16 and 64, both nucleus variants: 8
    thunks."""
    eng = _port(steps_per_sync=16, max_steps_per_sync=64, speculate_k=2)
    assert [port_thunk(t) for t in eng.warmup_plan()] == [
        (True, 16, False), (True, 21, False), (False, 16, False), (False, 64, False),
        (True, 16, True), (True, 21, True), (False, 16, True), (False, 64, True)]


# -- tokens after the warmup --------------------------------------------------


def test_greedy_tokens_after_warmup_match_jax_engine():
    """After warmup_decode and after a drained queued warmup, the port's
    greedy tokens equal the JAX engine's exactly (scale 0.3 weights, as
    test_torch_engine.py: at 0.02 the tiny model repeats one token)."""
    sched = dict(steps_per_sync=4)
    receipt = Image.open(RECEIPT)
    requests = [("Extract the text content from this image.", [receipt]),
                ("hello world", []), ("a second, longer text prompt", [])]

    def serve(eng):
        ids = [eng.submit(p, images=imgs, max_new_tokens=12, temperature=0.0,
                          max_pixels=28 * 28 * 12) for p, imgs in requests]
        eng.run()
        return [(eng.finished_request(i).output_ids, eng.finished_request(i).finished_reason)
                for i in ids]

    want = serve(_jax(0.3, **sched))
    warmed = _port(0.3, **sched)
    warmed.warmup_decode()
    assert serve(warmed) == want
    queued = _port(0.3, **sched)
    queued.queue_warmup(vision_sizes=((56, 84),))
    while queued.warm_pending:
        queued.warm_tick()
        queued.run()
    assert serve(queued) == want
    assert len({t for toks, _ in want for t in toks}) > 12


# -- the fixed chunk inputs and the graph key ---------------------------------


def test_chunk_inputs_are_fixed_buffers_refilled_in_place():
    """Events refill the mode's buffers in place: across admissions,
    finishes and a mode change every mode keeps the tensors it was
    allocated with, and the engine's chunk inputs are always one of them."""
    eng = _port(steps_per_sync=2, max_steps_per_sync=8, speculate_k=2,
                spec_min_tokens_per_iter=0.0)
    seen = {}

    def record():
        if eng._dev is not None:
            assert eng._dev is eng._inputs[eng._dev.mode]
        for mode, dev in eng._inputs.items():
            ptrs = {f: getattr(dev, f).data_ptr() for f in ("tokens", "positions", "budgets",
                                                            "tables", "active", "keys", "buf")
                    if getattr(dev, f) is not None}
            assert seen.setdefault(mode, ptrs) == ptrs

    for wave in ([("alpha", 6), ("beta gamma", 20)], [("delta", 12, True)]):
        for prompt, n, *lp in wave:
            eng.submit(prompt, max_new_tokens=n, temperature=0.0, logprobs=bool(lp))
        while eng.has_work():
            eng.step()
            record()
    assert set(eng._inputs) == {(True, False, False), (False, False, False)}
    assert eng.metrics["chunk_input_rebuilds"] >= 3
    assert eng.allocator.free_pages == 63


@pytest.mark.parametrize("spec", [False, True])
def test_nucleus_cannot_change_an_all_greedy_chunk(spec):
    """The graph key drops ``nucleus`` when no row samples: the programs
    give the same packed result and carry either way."""
    eng = _port(speculate_k=2 if spec else 0, spec_min_tokens_per_iter=0.0)
    for prompt in ("alpha", "beta gamma"):
        eng.submit(prompt, max_new_tokens=40, temperature=0.0, top_p=0.5)
    eng.step()
    active = [i for i, r in enumerate(eng._slot_req) if r is not None]
    assert active
    dev = eng._chunk_inputs(active, (spec, False, False))
    assert not dev.any_sampled and dev.nucleus
    outs = []
    for nucleus in (False, True):
        args = dict(page_tables=dev.tables, active=dev.active, temperature=dev.temps,
                    top_p=dev.top_ps, slot_keys=dev.keys, any_sampled=False, nucleus=nucleus,
                    page_size=eng.sched.page_size, num_steps=4)
        if spec:
            packed, carry = spec_decode_program(eng.params, eng.config, eng.paged,
                                                dev.buf.clone(), dev.tokens, dev.positions,
                                                dev.budgets, dev.gen_start, spec_k=2, **args)
        else:
            packed, carry = decode_program(eng.params, eng.config, eng.paged, dev.tokens,
                                           dev.positions, dev.budgets, **args)
        outs.append((packed, carry))
    assert torch.equal(outs[0][0], outs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1]))
    key = eng._chunk_key(dev, 2 if spec else 0, 4, False)
    assert key.nucleus is False and key == eng._chunk_key(dev, 2 if spec else 0, 4, False)
    dev.any_sampled = True
    assert eng._chunk_key(dev, 2 if spec else 0, 4, False).nucleus is True


def test_chunk_key_keeps_every_static_argument():
    base = dict(spec_k=0, num_steps=16, any_sampled=True, nucleus=True, with_logprobs=False,
                penalties=False, bias=False, int4_act=True, int4_weights=True)
    key = graphs.chunk_key(**base)
    changed = [graphs.chunk_key(**{**base, name: value}) for name, value in (
        ("spec_k", 2), ("num_steps", 64), ("any_sampled", False), ("nucleus", False),
        ("with_logprobs", True), ("penalties", True), ("bias", True), ("int4_act", False),
        ("int4_weights", False))]
    assert all(k != key for k in changed)
    # folded: nucleus without a sampled row, the activation mode without int4
    assert graphs.chunk_key(**{**base, "any_sampled": False}) == graphs.chunk_key(
        **{**base, "any_sampled": False, "nucleus": False})
    assert graphs.chunk_key(**{**base, "int4_weights": False}) == graphs.chunk_key(
        **{**base, "int4_weights": False, "int4_act": False})


def test_launch_counters_cover_every_wrapper_and_add_deltas():
    """``launch_counts`` reads every counter chip_smoke.py reports (each
    wrapper's attributes ending in "launches"); ``add_launches`` adds a
    graph's per-replay deltas to them."""
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention
    from dots_ocr_tpu_torch.ops.int4_matmul import int4_matmul
    from dots_ocr_tpu_torch.ops.paged_attention import paged_attention_multiquery_bf16

    counts = graphs.launch_counts()
    names = {(fn.__name__, attr) for fn, attr in counts}
    assert {("flash_attention", "launches"), ("flash_attention", "offset_launches"),
            ("paged_attention_multiquery_bf16", "verify_launches"),
            ("paged_attention_multiquery_int8", "launches"),
            ("paged_attention_stacked", "int8_launches"), ("window_attention", "launches"),
            ("int4_matmul", "w4a8_split_launches"), ("int4_matmul", "w4a8_wgmma_launches"),
            ("gumbel_argmax", "launches")} <= names
    deltas = {(flash_attention, "launches"): 3, (int4_matmul, "w4a8_launches"): 5,
              (paged_attention_multiquery_bf16, "verify_launches"): 28}
    graphs.add_launches(deltas)
    after = graphs.launch_counts()
    graphs.add_launches({c: -d for c, d in deltas.items()})
    assert all(after[c] == counts[c] + deltas.get(c, 0) for c in counts)
    assert graphs.launch_counts() == counts


# -- the server's flags and the launcher ---------------------------------------


def test_server_accepts_warmup_background_and_compile_cache(monkeypatch):
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", kernel_lib.BUILD_DIR)
    args = torch_server.build_parser().parse_args(
        ["--random-tiny", "--platform", "cpu", "--num-pages", "64", "--page-size", "8",
         "--max-slots", "4", "--max-seq-tokens", "128", "--warmup", "background",
         "--warmup-pages", "56x84, 28X28", "--compile-cache", ".cache/kernels"])
    eng = torch_server.build_engine(args)
    assert kernel_lib.BUILD_DIR == os.path.join(REPO, ".cache", "kernels")
    assert torch_server.start_warmup(eng, args) is None
    assert eng.warm_pending == 1 + len(eng.warmup_plan())
    assert torch_server.parse_pages("56x84, 28X28") == ((56, 84), (28, 28))
    assert torch_server.parse_pages("") == ((560, 420),)
    eng._warm_queue.pop(0)()  # the warm requests: both pages and the text
    assert len(eng._waiting) == 3
    assert torch_server.apply_compile_cache("/abs/dir") == "/abs/dir"


def test_compile_cache_keeps_the_loaded_library(tmp_path, monkeypatch):
    """set_build_dir copies a library the process has loaded into the new
    directory under its hash name, so that a second process finds it there
    and never runs nvcc."""
    built = tmp_path / "first" / kernel_lib._so_name()
    built.parent.mkdir()
    built.write_bytes(b"\x7fELF stand-in")
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", str(built.parent))
    monkeypatch.setattr(kernel_lib, "lib_path", str(built))
    kernel_lib.set_build_dir(str(tmp_path / "cache"))
    assert kernel_lib.BUILD_DIR == str(tmp_path / "cache")
    assert (tmp_path / "cache" / built.name).read_bytes() == built.read_bytes()
    monkeypatch.setattr(kernel_lib, "_nvcc", lambda: pytest.fail("nvcc ran"))
    assert kernel_lib._build() == str(tmp_path / "cache" / built.name)


def test_cuda_launcher_sources_shipping_env(tmp_path):
    """deploy/launch_server_cuda.sh serves deploy/shipping.env with every
    key, WARMUP and COMPILE_CACHE included (a relative cache resolved
    against the repository root); the environment overrides the file."""
    fake = tmp_path / "python"
    fake.write_text("#!/bin/sh\necho \"$@\"\n")
    fake.chmod(0o755)
    env = {"PATH": f"{tmp_path}:{os.environ['PATH']}", "HOME": str(tmp_path)}
    out = subprocess.run(["bash", os.path.join(REPO, "deploy", "launch_server_cuda.sh"),
                          "/w", "9000"], env=env, capture_output=True, text=True, check=True)
    args = out.stdout.split()
    flags = dict(zip(args[2::2], args[3::2]))
    assert args[:2] == ["-m", "dots_ocr_tpu_torch.serve.server"]
    assert flags["--weights"] == "/w" and flags["--port"] == "9000"
    assert flags["--warmup"] == "full" and flags["--platform"] == "cuda"
    assert os.path.normpath(flags["--compile-cache"]) == os.path.join(REPO, ".cache", "xla")
    assert (flags["--quantize"], flags["--kv-cache-dtype"], flags["--speculate-k"],
            flags["--page-size"], flags["--max-slots"]) == ("int8", "bf16", "2", "128", "64")
    out = subprocess.run(["bash", os.path.join(REPO, "deploy", "launch_server_cuda.sh")],
                         env={**env, "WARMUP": "background", "COMPILE_CACHE": "/tmp/k",
                              "KV_DTYPE": "int8"},
                         capture_output=True, text=True, check=True)
    args = out.stdout.split()
    flags = dict(zip(args[2::2], args[3::2]))
    assert (flags["--warmup"], flags["--compile-cache"], flags["--kv-cache-dtype"]) == (
        "background", "/tmp/k", "int8")
