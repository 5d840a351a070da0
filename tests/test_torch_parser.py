"""The port's parser, CLI and client against the JAX package's, on the CPU.

- Given the model outputs of ``tests/test_parser.py``'s ``FakeEngine``,
  the port's ``DotsOCRParser`` writes the same artifacts as the JAX
  parser: byte-identical ``.json``, ``.md``, ``_nohf.md`` and ``.jsonl``,
  and an equal ``.jpg``, for an image, a PDF, the layout-only, OCR and
  grounding prompts, and the salvage path (a response that is not JSON).
  The batched PDF path passes the same ``seed + page_no`` list.
- Local mode over the tiny port engines (the batch ``InferenceEngine`` and
  the continuous engine's batched PDF path) gives the JAX parser's
  artifacts over the JAX engines on the same weights, seeded and sampled.
- Server mode: the port's CLI (``python -m dots_ocr_tpu_torch``) against
  the port's server gives the same artifacts as the JAX CLI against the
  same server, with ``--seed``.
"""

import asyncio
import json
import os
import shutil
import socket
import threading

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import test_parser
from dots_ocr_tpu import cli as jax_cli
from dots_ocr_tpu.engine.engine import InferenceEngine as JaxBatchEngine
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine as JaxEngine
from dots_ocr_tpu.engine.scheduler import SchedulerConfig as JaxSched
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.parser import DotsOCRParser as JaxParser
from dots_ocr_tpu_torch import cli as torch_cli
from dots_ocr_tpu_torch.engine.engine import InferenceEngine
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.ops import flash_attention, paged_attention
from dots_ocr_tpu_torch.parser import DotsMOCRParser, DotsOCRParser
from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer

CPU = torch.device("cpu")
SMALL_PIXELS = 28 * 28 * 12


def _snapshot(out_dir):
    """{relative path: bytes} of every artifact; .jpg files as pixels."""
    snap = {}
    for root, _, files in os.walk(out_dir):
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, out_dir)
            if name.endswith(".jpg"):
                snap[rel] = np.asarray(Image.open(path)).tobytes()
            else:
                with open(path, "rb") as f:
                    snap[rel] = f.read()
    return snap


def _parse_both(tmp_path, make_engines, input_path, **parse_kw):
    """Parse ``input_path`` with the JAX parser, then with the port's, into
    the same output directory (the manifests hold absolute paths)."""
    out = str(tmp_path / "out")
    snaps, results = [], []
    parser_kw = parse_kw.pop("parser_kw", {})
    for parser_cls, engine in zip((JaxParser, DotsOCRParser), make_engines()):
        shutil.rmtree(out, ignore_errors=True)
        parser = parser_cls(engine=engine, output_dir=out, **parser_kw)
        results.append(parser.parse_file(input_path, **parse_kw))
        snaps.append(_snapshot(out))
    return snaps, results


def _fakes(response=None, cls=None):
    cls = cls or test_parser.FakeEngine
    return lambda: (cls(response), cls(response))


class FakeBatchingEngine(test_parser.FakeEngine):
    """A FakeEngine that looks like a continuous engine (``submit``), so a
    multi-page PDF takes the batched local path."""

    def submit(self, *args, **kwargs):
        raise AssertionError("the batched path calls generate_batch")


@pytest.fixture
def image_file(tmp_path):
    p = tmp_path / "page.png"
    Image.fromarray(np.random.RandomState(0).randint(200, 255, (420, 600, 3), np.uint8)).save(p)
    return str(p)


@pytest.fixture
def pdf_file(tmp_path):
    p = tmp_path / "doc.pdf"
    pages = [Image.new("RGB", (300, 200), (250, 250, 250)),
             Image.new("RGB", (300, 200), (240, 240, 240))]
    pages[0].save(str(p), format="PDF", save_all=True, append_images=pages[1:])
    return str(p)


SALVAGE = '[{"bbox": [1, 2, 30, 40], "category": "Text", "text": "cut off mid'


@pytest.mark.parametrize("mode,kw", [
    ("image_layout", dict(prompt_mode="prompt_layout_all_en")),
    ("image_layout_fitz", dict(prompt_mode="prompt_layout_all_en", fitz_preprocess=True)),
    ("layout_only", dict(prompt_mode="prompt_layout_only_en")),
    ("ocr", dict(prompt_mode="prompt_ocr")),
    ("grounding", dict(prompt_mode="prompt_grounding_ocr", bbox=[10, 20, 300, 200])),
    ("custom_prompt", dict(prompt_mode="prompt_layout_all_en", custom_prompt="read it")),
    ("salvage", dict(prompt_mode="prompt_layout_all_en")),
])
def test_image_artifacts_identical(tmp_path, image_file, mode, kw):
    response = SALVAGE if mode == "salvage" else None
    if mode in ("ocr", "grounding", "custom_prompt"):
        response = "## Heading\n\nSome **plain** text."
    (jax_snap, ours), results = _parse_both(tmp_path, _fakes(response), image_file, **kw)
    assert ours == jax_snap and results[0] == results[1]
    assert any(k.endswith(".jsonl") for k in ours)
    if mode == "salvage":
        assert results[1][0]["filtered"] is True
    if mode == "image_layout":
        assert {os.path.basename(k) for k in ours} == {
            "page.json", "page.jpg", "page.md", "page_nohf.md", "page.jsonl"}


@pytest.mark.parametrize("batching", [False, True], ids=["serial", "batched"])
def test_pdf_artifacts_identical(tmp_path, pdf_file, batching):
    engines = _fakes(cls=FakeBatchingEngine if batching else None)()
    (jax_snap, ours), results = _parse_both(
        tmp_path, lambda: engines, pdf_file, prompt_mode="prompt_layout_all_en",
        parser_kw=dict(seed=40))
    assert ours == jax_snap and len(results[1]) == 2
    assert [c["kwargs"].get("seed") for c in engines[1].calls] == \
        [c["kwargs"].get("seed") for c in engines[0].calls]
    if batching:
        assert engines[1].calls[0]["kwargs"]["seed"] == [40, 41]
    assert DotsMOCRParser is DotsOCRParser


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=0.3)
    return jparams, from_numpy_params(jax.tree.map(np.asarray, jparams), DotsOCRConfig.tiny(), CPU)


def test_local_mode_batch_engine_matches_jax(tmp_path, image_file, weights):
    jparams, tparams = weights
    kw = dict(prompt_bucket_step=32, vision_bucket_step=16)
    engines = lambda: (JaxBatchEngine(jparams, JaxConfig.tiny(), **kw),  # noqa: E731
                       InferenceEngine(tparams, DotsOCRConfig.tiny(), **kw))
    (jax_snap, ours), _ = _parse_both(
        tmp_path, engines, image_file, prompt_mode="prompt_ocr",
        parser_kw=dict(seed=7, max_completion_tokens=10, max_pixels=SMALL_PIXELS,
                       temperature=0.7))
    assert ours == jax_snap
    md = [v for k, v in ours.items() if k.endswith(".md")]
    assert md and len(md[0]) > 0


def test_local_mode_continuous_engine_batched_pdf_matches_jax(tmp_path, pdf_file, weights,
                                                              monkeypatch):
    jparams, tparams = weights
    for ops in (flash_attention, paged_attention):
        monkeypatch.setitem(ops.IMPLEMENTATIONS, "kernel", ops.IMPLEMENTATIONS["xla"])
    sched = dict(num_pages=256, page_size=8, max_slots=4, max_pages_per_seq=64,
                 prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=4)
    engines = lambda: (JaxEngine(jparams, JaxConfig.tiny(), sched=JaxSched(**sched)),  # noqa: E731
                       ContinuousBatchingEngine(tparams, DotsOCRConfig.tiny(), CPU,
                                                sched=SchedulerConfig(**sched)))
    (jax_snap, ours), _ = _parse_both(
        tmp_path, engines, pdf_file, prompt_mode="prompt_ocr",
        parser_kw=dict(seed=3, max_completion_tokens=10, max_pixels=SMALL_PIXELS,
                       temperature=0.7, top_p=0.9))
    assert ours == jax_snap
    assert sum(k.endswith(".md") for k in ours) == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_server_mode_matches_jax_cli(tmp_path, image_file, weights, monkeypatch):
    """Both CLIs against the port's server (a tiny continuous engine on the
    CPU, in a thread): the same seeded artifacts, and the same again."""
    from aiohttp import web

    _, tparams = weights
    eng = ContinuousBatchingEngine(
        tparams, DotsOCRConfig.tiny(), CPU,
        sched=SchedulerConfig(num_pages=128, page_size=8, max_slots=4, max_pages_per_seq=64,
                              prompt_bucket_step=32, vision_bucket_step=16))
    port = _free_port()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(OpenAIServer(eng, model_name="tiny").build_app())
    loop.run_until_complete(runner.setup())
    loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        snaps = []
        for main in (jax_cli.main, torch_cli.main, torch_cli.main):
            out = str(tmp_path / "out")
            shutil.rmtree(out, ignore_errors=True)
            main([image_file, "--port", str(port), "--ip", "127.0.0.1", "--output", out,
                  "--prompt", "prompt_ocr", "--seed", "5", "--max_completion_tokens", "8",
                  "--max_pixels", str(SMALL_PIXELS), "--no_fitz_preprocess"])
            snaps.append(_snapshot(out))
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(timeout=30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(timeout=30)
    assert snaps[1] == snaps[0] == snaps[2]
    md = [v for k, v in snaps[1].items() if k.endswith(".md")]
    assert md and md[0]
    assert torch_cli.build_arg_parser().parse_args(["x.png"]).platform == \
        os.environ.get("DOTS_OCR_PLATFORM", "cuda")


def test_client_payload_and_transport_error():
    """The port's client sends the JAX client's JSON body and returns None
    on a transport error."""
    from dots_ocr_tpu_torch.client.inference import inference_with_server

    img = Image.new("RGB", (28, 28))
    assert inference_with_server(img, "hi", port=_free_port(), timeout=5) is None
