"""Greedy tokens of the JAX engine and the port's engine on the fully
quantized configuration, on the CPU: int4 decoder block linears (int8
embedding), W8A8 vision, int8 KV, chunked prefill and k = 2 speculation,
on the int4-aligned miniature config of ``test_int4_engine.py`` (decoder
hidden 256; the stock tiny config falls back to int8 everywhere).

The JAX engine runs in a subprocess with ``--xla_allow_excess_precision=
false`` (the int8 embedding makes the activations bf16; see
``test_torch_engine_parity.py``). On the CPU the JAX package's int4 linears
take its XLA oracle, so the port's int4 implementation is set to the twin
of that oracle (``"xla"``), as its attention functions are; the plain
version of the kernel is held against the Pallas kernel in
``test_torch_int4.py``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dots_ocr_tpu.models import quantize as jquant
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models import quantize as tquant
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.ops import flash_attention, int4_matmul, paged_attention
from test_int4_engine import aligned_tiny
from test_torch_engine import RECEIPT, SCHED
from test_torch_engine_parity import REQUESTS
from test_torch_int4 import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONS = dict(prefill_chunk_tokens=16, speculate_k=2, kv_cache_dtype="int8")
SCALE = 0.3  # as in test_torch_engine_parity.py: varied tokens from a tiny model

JAX_SIDE = """
import json, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
from PIL import Image
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["tests"])
from test_int4_engine import aligned_tiny
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu.models.init import init_params
from dots_ocr_tpu.models.quantize import quantize_decoder_params_int4, quantize_vision_params
cfg = aligned_tiny()
params = quantize_vision_params(quantize_decoder_params_int4(
    init_params(jax.random.PRNGKey(0), cfg, scale=spec["scale"])))
sched = SchedulerConfig(**spec["sched"], **spec["options"])
eng = ContinuousBatchingEngine(params, cfg, sched=sched)
receipt = Image.open(spec["receipt"])
ids = [eng.submit(text, images=[receipt] if img else [], max_new_tokens=12, temperature=0.0,
                  max_pixels=28 * 28 * 12) for text, img in spec["requests"]]
eng.run()
print(json.dumps([[eng.finished_request(i).output_ids, eng.finished_request(i).finished_reason]
                  for i in ids]))
"""


@pytest.fixture(scope="module")
def jax_tokens():
    spec = dict(tests=os.path.join(REPO, "tests"), scale=SCALE, sched=SCHED, options=OPTIONS,
                requests=REQUESTS, receipt=RECEIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(spec)], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fully_quantized_greedy_tokens_match_jax_engine(jax_tokens, monkeypatch):
    for ops in (flash_attention, paged_attention, int4_matmul):
        monkeypatch.setitem(ops.IMPLEMENTATIONS, "kernel", ops.IMPLEMENTATIONS["xla"])
    calls = []

    def counted(*args):
        calls.append(args[1].shape)
        return int4_matmul.int4_matmul_xla(*args)

    monkeypatch.setitem(int4_matmul.IMPLEMENTATIONS, "kernel", counted)
    jcfg = aligned_tiny()
    jtree = jquant.quantize_vision_params(jquant.quantize_decoder_params_int4(
        jax_init(jax.random.PRNGKey(0), jcfg, scale=SCALE)))
    params = from_numpy_params(jax.tree.map(np.asarray, jtree), port_config(jcfg),
                               torch.device("cpu"))
    eng = ContinuousBatchingEngine(params, port_config(jcfg), torch.device("cpu"),
                                   sched=SchedulerConfig(**SCHED, **OPTIONS))
    receipt = Image.open(RECEIPT)
    ids = [eng.submit(text, images=[receipt] if img else [], max_new_tokens=12,
                      temperature=0.0, max_pixels=28 * 28 * 12) for text, img in REQUESTS]
    eng.run()
    ours = [[eng.finished_request(i).output_ids, eng.finished_request(i).finished_reason]
            for i in ids]
    assert ours == jax_tokens
    assert len({t for toks, _ in ours for t in toks}) > 12  # not one repeated token
    assert eng.allocator.free_pages == SCHED["num_pages"] - 1
    # the int4 and W8A8 leaves reached the engine, and the int4 linears ran
    blocks = eng.params["decoder"]["blocks"]
    assert all(tquant.is_int4_kernel(blocks[g][n]) for g, n in tquant.BLOCK_KERNELS)
    assert tquant.is_quantized_kernel(eng.params["decoder"]["embed"])
    assert tquant.is_act_quantized_kernel(eng.params["vision"]["blocks"]["mlp"]["down"])
    assert len(calls) >= 7 * jcfg.decoder.num_layers and (256, 256) in calls  # down: in 512
    assert eng.metrics["prefill_chunks"] >= 2 and eng.metrics["spec_chunks"] >= 1
    assert eng.paged.k[0].dtype == torch.int8
