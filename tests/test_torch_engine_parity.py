"""Greedy tokens of the JAX engine and the port's engine on the shipped
serving path's options, on the CPU: chunked prefill, k = 2 speculation,
int8 weights, int8 KV, and all four together (tiny config, bridged weights,
the ``SCHED`` of ``test_torch_engine.py``).

The JAX engine runs in a subprocess with ``--xla_allow_excess_precision=
false``: with int8 weights the activations are bf16, and XLA's default
lets a jitted program skip the bf16 roundings its source asks for, so its
tokens would depend on fusion decisions. The port's engine runs with its
attention functions set to the JAX engine's own CPU path (the ``"xla"``
implementations: dense attention, int8 KV dequantized to bf16), so the two
compute the same function and must emit the same tokens. The kernels'
plain versions are held against the Pallas kernels in
``test_torch_quantized.py`` and ``test_torch_serving_path.py``.
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

from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.models.quantize import quantize_decoder_params
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.ops import flash_attention, paged_attention
from test_torch_engine import RECEIPT, SCHED

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {
    "chunked": dict(prefill_chunk_tokens=16),
    "k2": dict(speculate_k=2),
    "int8_weights": dict(),
    "int8_kv": dict(kv_cache_dtype="int8"),
    "all_four": dict(prefill_chunk_tokens=16, speculate_k=2, kv_cache_dtype="int8"),
}
INT8_WEIGHTS = ("int8_weights", "all_four")
REQUESTS = [("Extract the text content from this image.", True),
            ("hello world", False), ("a second, longer text prompt", False)]

JAX_SIDE = """
import json, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
from PIL import Image
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu.models.config import DotsOCRConfig
from dots_ocr_tpu.models.init import init_params
from dots_ocr_tpu.models.quantize import quantize_decoder_params
spec = json.loads(sys.argv[1])
params = init_params(jax.random.PRNGKey(0), DotsOCRConfig.tiny(), scale=0.3)
receipt = Image.open(spec["receipt"])
out = {}
for name, kw in spec["configs"].items():
    p = quantize_decoder_params(params) if name in spec["int8_weights"] else params
    eng = ContinuousBatchingEngine(p, DotsOCRConfig.tiny(), sched=SchedulerConfig(**spec["sched"], **kw))
    ids = [eng.submit(text, images=[receipt] if img else [], max_new_tokens=12,
                      temperature=0.0, max_pixels=28 * 28 * 12) for text, img in spec["requests"]]
    eng.run()
    out[name] = [[eng.finished_request(i).output_ids, eng.finished_request(i).finished_reason]
                 for i in ids]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_tokens():
    spec = dict(configs=CONFIGS, int8_weights=INT8_WEIGHTS, sched=SCHED,
                requests=REQUESTS, receipt=RECEIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(spec)], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def params():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=0.3)
    return {quantized: from_numpy_params(
        jax.tree.map(np.asarray, quantize_decoder_params(jparams) if quantized else jparams),
        DotsOCRConfig.tiny(), torch.device("cpu")) for quantized in (False, True)}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_tokens_match_jax_engine(jax_tokens, params, name, monkeypatch):
    for ops in (flash_attention, paged_attention):
        monkeypatch.setitem(ops.IMPLEMENTATIONS, "kernel", ops.IMPLEMENTATIONS["xla"])
    kw = CONFIGS[name]
    eng = ContinuousBatchingEngine(params[name in INT8_WEIGHTS], DotsOCRConfig.tiny(),
                                   torch.device("cpu"), sched=SchedulerConfig(**SCHED, **kw))
    receipt = Image.open(RECEIPT)
    ids = [eng.submit(text, images=[receipt] if img else [], max_new_tokens=12,
                      temperature=0.0, max_pixels=28 * 28 * 12) for text, img in REQUESTS]
    eng.run()
    ours = [[eng.finished_request(i).output_ids, eng.finished_request(i).finished_reason]
            for i in ids]
    assert ours == jax_tokens[name]
    assert len({t for toks, _ in ours for t in toks}) > 12  # not one repeated token
    assert eng.allocator.free_pages == SCHED["num_pages"] - 1
    # the options took their paths
    if "prefill_chunk_tokens" in kw:
        assert eng.metrics["prefill_chunks"] >= 2
    if "speculate_k" in kw:
        assert eng.metrics["spec_chunks"] >= 1 and eng.metrics["spec_emitted"] > 0
    if name in INT8_WEIGHTS:
        assert eng.params["decoder"]["embed"]["qint8"].dtype == torch.int8
    if kw.get("kv_cache_dtype") == "int8":
        assert eng.paged.k[0].dtype == torch.int8
