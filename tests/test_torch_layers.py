"""dots_ocr_tpu_torch leaf modules against the JAX package on the CPU:
config, layers, RoPE, the dense attention oracle, host packing, sampling.

Inputs come from numpy seeds and reach both frameworks as the same arrays.
Float32 throughout; JAX runs at "highest" matmul precision (conftest), so
the stated tolerance (1e-5) covers summation-order noise only.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dots_ocr_tpu.models import config as jcfg
from dots_ocr_tpu.models import layers as jlayers
from dots_ocr_tpu.models import preprocess as jpre
from dots_ocr_tpu.models import rope as jrope
from dots_ocr_tpu.ops import attention as jattn
from dots_ocr_tpu_torch.engine.sampling import prng_key, sample_logits
from dots_ocr_tpu_torch.models import config as tcfg
from dots_ocr_tpu_torch.models import layers as tlayers
from dots_ocr_tpu_torch.models import preprocess as tpre
from dots_ocr_tpu_torch.models import rope as trope
from dots_ocr_tpu_torch.ops import attention as tattn

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=atol)


@pytest.mark.parametrize("factory", ["flagship", "tiny", "small"])
def test_config_fields_match_jax(factory):
    j = getattr(jcfg.DotsOCRConfig, factory)()
    t = getattr(tcfg.DotsOCRConfig, factory)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.torch_dtype == getattr(torch, str(j.jax_dtype))
    assert (t.vision.patch_dim, t.vision.merge_dim) == (j.vision.patch_dim, j.vision.merge_dim)
    assert (t.decoder.q_dim, t.decoder.kv_dim) == (j.decoder.q_dim, j.decoder.kv_dim)


def test_rms_norm_linear_swiglu_match_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 5, 64).astype(np.float32)
    w = rng.randn(64).astype(np.float32)
    kern = (0.1 * rng.randn(64, 48)).astype(np.float32)
    bias = rng.randn(48).astype(np.float32)
    gate, up = (0.1 * rng.randn(2, 64, 96)).astype(np.float32)
    down = (0.1 * rng.randn(96, 64)).astype(np.float32)
    _close(tlayers.rms_norm(_t(x), _t(w), 1e-6), jlayers.rms_norm(x, w, 1e-6))
    _close(tlayers.linear(_t(x), _t(kern), _t(bias)), jlayers.linear(x, kern, bias))
    _close(tlayers.swiglu(_t(x), _t(gate), _t(up), _t(down)),
           jlayers.swiglu(x, gate, up, down))
    emb = rng.randn(50, 64).astype(np.float32)
    ids = rng.randint(0, 50, (2, 7))
    _close(tlayers.embed(_t(ids), _t(emb)), jlayers.embed(ids, emb))
    _close(tlayers.unembed(_t(x), _t(emb)), jlayers.unembed(x, emb), atol=1e-4)


def test_rope_matches_jax():
    rng = np.random.RandomState(1)
    positions = rng.randint(0, 4000, (2, 9)).astype(np.int32)
    jc, js = jrope.rope_table(jnp.asarray(positions), 16, 1e6)
    tc, ts = trope.rope_table(_t(positions), 16, 1e6)
    _close(tc, jc)
    _close(ts, js)
    x = rng.randn(2, 9, 4, 16).astype(np.float32)
    _close(trope.apply_rope(_t(x), tc, ts), jrope.apply_rope(x, jc, js))

    pos2d = rng.randint(0, 60, (33, 2)).astype(np.int32)
    jvc, jvs = jrope.vision_rope_device(jnp.asarray(pos2d), 16, 1e4)
    tvc, tvs = trope.vision_rope_device(_t(pos2d), 16, 1e4)
    _close(tvc, jvc)
    _close(tvs, jvs)
    xv = rng.randn(33, 2, 16).astype(np.float32)
    _close(trope.apply_rope(_t(xv), tvc, tvs), jrope.apply_rope(xv, jvc, jvs))


@pytest.mark.parametrize("grid", [(4, 6), (8, 8), (10, 14)])
def test_token_order_matches_jax(grid):
    gh, gw = grid
    jp, jw = jrope.token_order(gh, gw, merge=2)
    tp, tw = trope.token_order(gh, gw, merge=2)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(
        trope.vision_grid_positions(gh, gw), jrope.vision_grid_positions(gh, gw)
    )


def test_pack_images_and_merge_match_jax():
    rng = np.random.RandomState(2)
    imgs = [Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
            for h, w in ((56, 84), (28, 56))]
    jcv, tcv = jcfg.DotsOCRConfig.tiny().vision, tcfg.DotsOCRConfig.tiny().vision
    packs = []
    for images in (imgs, imgs[1:]):
        j = jpre.pack_images(images, jcv, bucket_step=16)
        t = tpre.pack_images(images, tcv, bucket_step=16)
        for name in ("patches", "pos2d", "segment_ids"):
            np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        assert (t.grids, t.num_tokens, t.num_merged) == (j.grids, j.num_tokens, j.num_merged)
        np.testing.assert_array_equal(t.merged_valid_rows(4), j.merged_valid_rows(4))
        packs.append((j, t))
    jm = jpre.merge_packed([p[0] for p in packs], jcv, bucket_step=16)
    tm = tpre.merge_packed([p[1] for p in packs], tcv, bucket_step=16)
    for name in ("patches", "pos2d", "segment_ids"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name))


def test_mha_reference_and_masks_match_jax():
    rng = np.random.RandomState(3)
    q = rng.randn(2, 12, 4, 16).astype(np.float32)
    k = rng.randn(2, 12, 2, 16).astype(np.float32)
    v = rng.randn(2, 12, 2, 16).astype(np.float32)
    seg = np.array([[0] * 5 + [1] * 5 + [-1] * 2, [0] * 12], np.int32)
    lens = np.array([7, 12], np.int32)
    pos = np.broadcast_to(np.arange(12), (2, 12)).astype(np.int32)
    jmask = (jattn.make_segment_mask(seg, seg) & jattn.make_causal_mask(pos, 12)
             & jattn.make_length_mask(lens, 12)[:, None, :])
    tmask = (tattn.make_segment_mask(_t(seg), _t(seg))
             & tattn.make_causal_mask(_t(pos), 12)
             & tattn.make_length_mask(_t(lens), 12)[:, None, :])
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _close(tattn.mha_reference(_t(q), _t(k), _t(v), tmask),
           jattn.mha_reference(q, k, v, mask=jmask))


def test_sampling_greedy_and_top_p():
    rng = np.random.RandomState(4)
    logits = torch.from_numpy(rng.randn(4, 300).astype(np.float32))
    key = prng_key(0)
    greedy = sample_logits(key, logits, torch.zeros(4), torch.ones(4), any_sampled=False)
    assert torch.equal(greedy, logits.argmax(-1))
    # top_p tiny keeps only the most probable token, whatever the noise;
    # greedy rows stay greedy inside a sampled batch.
    temps = torch.tensor([1.0, 0.7, 0.0, 1.0])
    top_p = torch.tensor([1e-6, 1e-6, 0.5, 1.0])
    out = sample_logits(key, logits, temps, top_p, any_sampled=True)
    assert torch.equal(out[:3], logits.argmax(-1)[:3])
    assert 0 <= int(out[3]) < 300
    # full-vocab rows follow the softmax distribution (Gumbel-max)
    peaked = torch.tensor([[0.0, np.log(3.0), -50.0]]).repeat(4000, 1)
    draws = sample_logits(key, peaked, torch.ones(4000), torch.ones(4000), any_sampled=True)
    frac = (draws == 1).float().mean().item()
    assert abs(frac - 0.75) < 0.03
