"""Windowed vision in the port against the JAX package, on the CPU: the
plain version of the window kernel against the Pallas kernel in interpret
mode, window-major packing bit for bit, and the windowed encoder against
the JAX encoder's XLA path (tiny config, bridged weights), and the
engine's greedy tokens with windowed vision and int8 KV against the JAX
engine's."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dots_ocr_tpu.models import preprocess as jpre
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.models.rope import vision_rope_device as jax_vrope
from dots_ocr_tpu.models.vision import vision_forward as jax_vision_forward
from dots_ocr_tpu.ops.attention import make_segment_mask, mha_reference
from dots_ocr_tpu.ops.window_attention import window_attention as jax_window
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models import preprocess as tpre
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.models.rope import vision_rope_device
from dots_ocr_tpu_torch.models.vision import vision_forward
from dots_ocr_tpu_torch.ops import flash_attention, paged_attention
from dots_ocr_tpu_torch.ops import window_attention as twin
from test_torch_engine import RECEIPT, SCHED
from test_torch_engine_parity import REQUESTS
from test_torch_model import _images

H, D, W = 4, 32, 64  # tests/test_window_attention.py's shapes


def _seg_cases():
    """The five cases of tests/test_window_attention.py: (nw, segment ids)."""
    edge = np.zeros((3, W), np.int32)
    edge[1, W // 3:] = -1
    bucket = np.zeros((4, W), np.int32)
    bucket[3, :] = -1
    distinct = np.tile(np.arange(5, dtype=np.int32)[:, None], (1, W))
    distinct[2, W // 2:] = -1
    return {"all_valid": np.zeros((3, W), np.int32), "padded_edge": edge,
            "fully_padded_bucket": bucket, "single": np.zeros((1, W), np.int32),
            "distinct_images": distinct}


@pytest.mark.parametrize("case", sorted(_seg_cases()))
def test_window_reference_matches_pallas_interpret(case):
    """Every row, fully padded windows included, within 1 bf16 ulp of the
    output plus 1e-5: both round p to bf16 before P @ V and divide by the
    float32 sum, so only the float32 summation order differs. Valid rows
    also agree with the dense oracle within 2e-2 (it rounds the normalized
    probabilities instead)."""
    seg = _seg_cases()[case]
    nw = seg.shape[0]
    rng = np.random.RandomState(sorted(_seg_cases()).index(case))
    q, k, v = (rng.randn(nw, W, H, D).astype(np.float32) * 0.3 for _ in range(3))
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    pallas = np.asarray(jax_window(jq, jk, jv, jnp.asarray(seg), interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    ours = twin.window_attention(tq, tk, tv, torch.from_numpy(seg)).float().numpy()
    assert np.isfinite(ours).all()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(pallas), 1e-30))) - 7)
    assert (np.abs(ours - pallas) <= ulp + 1e-5).all(), np.abs(ours - pallas).max()
    if case == "fully_padded_bucket":  # the uniform average of V, as Pallas gives it
        mean_v = tv[3].float().mean(dim=0).to(torch.bfloat16).float().numpy()
        np.testing.assert_allclose(ours[3], np.broadcast_to(mean_v, ours[3].shape), atol=1e-2)
    jseg = jnp.asarray(seg)
    dense = np.asarray(mha_reference(jq, jk, jv, mask=make_segment_mask(jseg, jseg)), np.float32)
    valid = seg >= 0
    assert np.abs(ours - dense)[valid].max() < 2e-2
    xla = twin.window_attention_xla(tq, tk, tv, torch.from_numpy(seg)).float().numpy()
    np.testing.assert_allclose(xla[valid], dense[valid], rtol=0, atol=1e-2)


def _windowed(cfg, full_layers=(1,)):
    return cfg.replace(vision=dataclasses.replace(cfg.vision, window_size=4,
                                                   full_attn_layers=full_layers))


def test_windowed_packing_equals_jax():
    """pack_images and merge_packed with window 4: every array equal."""
    tcfg, jcfg = _windowed(DotsOCRConfig.tiny()).vision, _windowed(JaxConfig.tiny()).vision
    imgs = _images()
    packs = [(tpre.pack_images(imgs, tcfg, bucket_step=64),
              jpre.pack_images(imgs, jcfg, bucket_step=64))]
    singles = [(tpre.pack_images([im], tcfg, bucket_step=64),
                jpre.pack_images([im], jcfg, bucket_step=64)) for im in imgs]
    packs.append((tpre.merge_packed([t for t, _ in singles], tcfg, bucket_step=64),
                  jpre.merge_packed([j for _, j in singles], jcfg, bucket_step=64)))
    for ours, theirs in packs:
        for name in ("patches", "pos2d", "segment_ids", "window_ids"):
            a, b = getattr(ours, name), getattr(theirs, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert ours.grids == theirs.grids and ours.num_tokens == theirs.num_tokens
        assert ours.num_merged == theirs.num_merged
        assert len(ours.segment_ids) % 16 == 0 and (ours.segment_ids == -1).any()
        np.testing.assert_array_equal(ours.merged_valid_rows(4), theirs.merged_valid_rows(4))
    merged = packs[1][0]
    assert merged.window_ids.max() == 2  # 2 windows of image 0 + 1 of image 1


def test_windowed_vision_forward_matches_jax():
    """Layer 0 windowed (the plain window kernel), layer 1 image-wide, vs
    the JAX encoder's XLA path on the valid rows (float32 tiny config)."""
    jcfg, tcfg = _windowed(JaxConfig.tiny()), _windowed(DotsOCRConfig.tiny())
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny())
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg, torch.device("cpu"))
    packed = tpre.pack_images(_images(), tcfg.vision, bucket_step=64)
    jc, js = jax_vrope(jnp.asarray(packed.pos2d), tcfg.vision.head_dim, tcfg.vision.rope_theta)
    ref = np.asarray(jax_vision_forward(jparams["vision"], jcfg.vision,
                                        jnp.asarray(packed.patches), jc, js,
                                        jnp.asarray(packed.segment_ids), attn_impl="xla"))
    c, s = vision_rope_device(torch.from_numpy(packed.pos2d), tcfg.vision.head_dim,
                              tcfg.vision.rope_theta)
    valid = packed.segment_ids >= 0
    for impl in ("kernel", "xla"):
        out = vision_forward(tparams["vision"], tcfg.vision, torch.from_numpy(packed.patches),
                             c, s, torch.from_numpy(packed.segment_ids), attn_impl=impl)
        np.testing.assert_allclose(out.numpy()[valid], ref[valid], rtol=0, atol=1e-5)
    # the windows change the function: image-wide attention in layer 0 differs
    full = vision_forward(tparams["vision"], _windowed(tcfg, (0, 1)).vision,
                          torch.from_numpy(packed.patches), c, s,
                          torch.from_numpy(packed.segment_ids))
    assert np.abs(full.numpy()[valid] - ref[valid]).max() > 1e-3


JAX_WINDOWED = """
import dataclasses, json, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
from PIL import Image
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu.models.config import DotsOCRConfig
from dots_ocr_tpu.models.init import init_params
spec = json.loads(sys.argv[1])
cfg = DotsOCRConfig.tiny()
cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, window_size=4, full_attn_layers=(1,)))
eng = ContinuousBatchingEngine(init_params(jax.random.PRNGKey(0), cfg, scale=0.3), cfg,
                               sched=SchedulerConfig(**spec["sched"]))
receipt = Image.open(spec["receipt"])
ids = [eng.submit(text, images=[receipt] if img else [], max_new_tokens=12, temperature=0.0,
                  max_pixels=28 * 28 * 12) for text, img in spec["requests"]]
eng.run()
print(json.dumps([[eng.finished_request(i).output_ids, eng.finished_request(i).finished_reason]
                  for i in ids]))
"""


def test_windowed_int8_kv_greedy_tokens_match_jax_engine(monkeypatch):
    """The windowed tiny config (window 4, layer 1 image-wide) with int8 KV:
    the port's engine on the JAX engine's CPU paths (the "xla"
    implementations: the windows' einsum, dense attention, int8 KV
    dequantized to bf16) emits the JAX engine's greedy tokens; the JAX side
    runs in a subprocess without XLA's excess precision."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sched = dict(SCHED, kv_cache_dtype="int8")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_WINDOWED,
         json.dumps(dict(sched=sched, requests=REQUESTS, receipt=RECEIPT))],
        env=env, capture_output=True, text=True, timeout=300, cwd=repo)
    assert proc.returncode == 0, proc.stderr[-3000:]
    theirs = json.loads(proc.stdout.strip().splitlines()[-1])

    for ops in (flash_attention, paged_attention):
        monkeypatch.setitem(ops.IMPLEMENTATIONS, "kernel", ops.IMPLEMENTATIONS["xla"])
    windows = []

    def window_xla(q, k, v, seg):
        windows.append(q.shape)
        return twin.window_attention_xla(q, k, v, seg)

    monkeypatch.setitem(twin.IMPLEMENTATIONS, "kernel", window_xla)
    tcfg = _windowed(DotsOCRConfig.tiny())
    jparams = jax_init(jax.random.PRNGKey(0), _windowed(JaxConfig.tiny()), scale=0.3)
    params = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg, torch.device("cpu"))
    eng = ContinuousBatchingEngine(params, tcfg, torch.device("cpu"),
                                   sched=SchedulerConfig(**sched))
    receipt = Image.open(RECEIPT)
    ids = [eng.submit(text, images=[receipt] if img else [], max_new_tokens=12,
                      temperature=0.0, max_pixels=28 * 28 * 12) for text, img in REQUESTS]
    eng.run()
    ours = [[eng.finished_request(i).output_ids, eng.finished_request(i).finished_reason]
            for i in ids]
    assert ours == theirs
    assert len({t for toks, _ in ours for t in toks}) > 12  # not one repeated token
    assert eng.paged.k[0].dtype == torch.int8
    assert windows and all(shape[1] == 16 for shape in windows)  # the windowed layer ran
