"""The port's model path against the JAX package on shared weights (CPU,
tiny config, float32): the vision encoder, VLM prefill logits and K/V, the
paged prefill write and four paged decode steps.

Weights are made by the JAX package's ``init_params`` and carried over with
``from_numpy_params``. The JAX side runs its XLA reference paths (what its
engine runs on a CPU); the port's wrappers run their plain versions.
Tolerance: 1e-4 on logits (two float32 stacks summing in different order),
1e-5 on encoder outputs and K/V.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dots_ocr_tpu.engine import kv_cache as jkv
from dots_ocr_tpu.models import decoder as jdec
from dots_ocr_tpu.models import preprocess as jpre
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.models.rope import vision_rope_device as jax_vrope
from dots_ocr_tpu.models.vision import encode_images as jax_encode
from dots_ocr_tpu.models.vlm import vlm_prefill as jax_vlm_prefill
from dots_ocr_tpu_torch.engine import kv_cache as tkv
from dots_ocr_tpu_torch.models import decoder as tdec
from dots_ocr_tpu_torch.models import preprocess as tpre
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params, init_params, param_shapes
from dots_ocr_tpu_torch.models.rope import vision_rope_device
from dots_ocr_tpu_torch.models.vision import encode_images
from dots_ocr_tpu_torch.models.vlm import build_scatter_indices, vlm_prefill

CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny())
    cfg = DotsOCRConfig.tiny()
    return cfg, jparams, from_numpy_params(jax.tree.map(np.asarray, jparams), cfg, CPU)


def test_param_tree_matches_jax_and_random_init(weights):
    cfg, jparams, tparams = weights
    jflat = {jax.tree_util.keystr(p): a.shape
             for p, a in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {jax.tree_util.keystr(p): tuple(a.shape)
             for p, a in jax.tree_util.tree_flatten_with_path(tparams)[0]}
    assert jflat == tflat
    gen = torch.Generator().manual_seed(0)
    rand = init_params(cfg, CPU, gen)
    assert jax.tree.map(lambda a: tuple(a.shape), rand) == param_shapes(cfg)
    assert torch.equal(rand["decoder"]["final_norm"], torch.ones(cfg.decoder.hidden_size))
    assert not rand["vision"]["blocks"]["attn"]["bq"].any()
    assert 0.015 < float(rand["decoder"]["embed"].std()) < 0.025


def _images():
    rng = np.random.RandomState(0)
    return [Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8))
            for h, w in ((56, 84), (28, 56))]


def test_encode_images_matches_jax(weights):
    cfg, jparams, tparams = weights
    packed = tpre.pack_images(_images(), cfg.vision, bucket_step=16)
    jpacked = jpre.pack_images(_images(), JaxConfig.tiny().vision, bucket_step=16)
    jc, js = jax_vrope(jnp.asarray(jpacked.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    ref = np.asarray(jax_encode(jparams["vision"], JaxConfig.tiny().vision,
                                jnp.asarray(jpacked.patches), jc, js,
                                jnp.asarray(jpacked.segment_ids), attn_impl="xla"))
    c, s = vision_rope_device(_t(packed.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    out = encode_images(tparams["vision"], cfg.vision, _t(packed.patches), c, s,
                        _t(packed.segment_ids)).numpy()
    rows = packed.merged_valid_rows(4)
    assert len(rows) == packed.num_merged
    np.testing.assert_allclose(out[rows], ref[rows], rtol=0, atol=1e-5)


def _prefill_inputs(cfg):
    """Row 0: text + one image span; row 1: shorter text (padded)."""
    packed = tpre.pack_images(_images()[:1], cfg.vision, bucket_step=16)
    sp = cfg.special
    row0 = [7, 8, 9, sp.img_id] + [sp.imgpad_id] * packed.num_merged + [sp.endofimg_id, 10, 11]
    row1 = [12, 13, 14, 15, 16]
    t = 32
    ids = np.full((2, t), sp.pad_token_id, np.int64)
    ids[0, :len(row0)] = row0
    ids[1, :len(row1)] = row1
    lens = np.array([len(row0), len(row1)], np.int64)
    sb, spos = build_scatter_indices(ids, sp.imgpad_id, packed.patches.shape[0] // 4,
                                     valid_rows=packed.merged_valid_rows(4))
    return packed, ids, lens, sb, spos


def test_vlm_prefill_and_paged_decode_match_jax(weights):
    cfg, jparams, tparams = weights
    jcfg = JaxConfig.tiny()
    packed, ids, lens, sb, spos = _prefill_inputs(cfg)
    b, t = ids.shape
    positions = np.broadcast_to(np.arange(t), (b, t))
    jc, js = jax_vrope(jnp.asarray(packed.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    jlogits, jcache = jax_vlm_prefill(
        jparams, jcfg, jnp.asarray(ids), jnp.asarray(positions), jnp.asarray(lens),
        patches=jnp.asarray(packed.patches), rope_cos=jc, rope_sin=js,
        segment_ids=jnp.asarray(packed.segment_ids), scatter_batch=jnp.asarray(sb),
        scatter_pos=jnp.asarray(spos), attn_impl="xla",
    )
    c, s = vision_rope_device(_t(packed.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    logits, (k, v) = vlm_prefill(
        tparams, cfg, _t(ids), _t(positions), _t(lens), patches=_t(packed.patches),
        rope_cos=c, rope_sin=s, segment_ids=_t(packed.segment_ids),
        scatter_batch=_t(sb), scatter_pos=_t(spos),
    )
    for row in range(b):
        n = lens[row]
        np.testing.assert_allclose(logits[row, :n].numpy(), np.asarray(jlogits)[row, :n],
                                   rtol=0, atol=1e-4)
        for ours, theirs in ((k, jcache.k), (v, jcache.v)):
            np.testing.assert_allclose(ours[:, row, :n].numpy(),
                                       np.asarray(theirs)[:, row, :n], rtol=0, atol=1e-5)

    # Paged cache: prefill write, then four decode steps fed the same
    # (greedy) tokens on both sides.
    page_size, max_pages, num_pages = 8, 8, 24
    alloc = tkv.PageAllocator(num_pages, page_size, max_pages)
    slot_map = np.full((b, t), -1, np.int64)
    for row in range(b):
        alloc.allocate(row, int(lens[row]) + 4)
        slot_map[row, :lens[row]] = alloc.slot_mapping(row, 0, int(lens[row]))
    tables = np.stack([alloc.padded_table(row) for row in range(b)])
    jpaged = jkv.write_prefill_kv(
        jkv.PagedKV.create(jcfg.decoder, num_pages, page_size, dtype=jnp.float32),
        jcache.k, jcache.v, jnp.asarray(slot_map.reshape(-1), jnp.int32))
    paged = tkv.PagedKV.create(cfg.decoder, num_pages, page_size, torch.float32, CPU)
    tkv.write_prefill_kv(paged, k, v, _t(slot_map.reshape(-1)))
    for layer in range(cfg.decoder.num_layers):
        for row in range(b):
            slots = slot_map[row, :lens[row]]
            np.testing.assert_allclose(paged.k[layer][:, slots].numpy(),
                                       np.asarray(jpaged.k[layer])[:, slots], rtol=0, atol=1e-5)

    tokens = np.asarray(jlogits)[np.arange(b), lens - 1].argmax(-1)
    jk, jv = jpaged.k, jpaged.v
    pos = lens.copy()
    for _ in range(4):
        slots = np.stack([alloc.slot_mapping(row, int(pos[row]), 1)[0] for row in range(b)])
        jx = jdec.embed_tokens(jparams["decoder"], jnp.asarray(tokens))
        jh, jk, jv, _, _ = jdec.decoder_decode_step_paged(
            jparams["decoder"], jcfg.decoder, jx, jnp.asarray(pos), jk, jv,
            jnp.asarray(tables), jnp.asarray(pos + 1, jnp.int32),
            jnp.asarray(slots, jnp.int32), page_size, attn_impl="reference")
        jstep = np.asarray(jdec.logits_from_hidden(jparams["decoder"], jcfg.decoder, jh))
        x = tdec.embed_tokens(tparams["decoder"], _t(tokens))
        h = tdec.decoder_decode_step_paged(
            tparams["decoder"], cfg.decoder, x, _t(pos), paged.k, paged.v, _t(tables),
            _t((pos + 1).astype(np.int32)), _t(slots), page_size)
        step = tdec.logits_from_hidden(tparams["decoder"], cfg.decoder, h).numpy()
        np.testing.assert_allclose(step, jstep, rtol=0, atol=1e-4)
        tokens = jstep.argmax(-1)
        pos = pos + 1
    # The null page (slot 0..page_size) holds padding writes in either order.
    np.testing.assert_allclose(paged.v[-1][:, page_size:].numpy(),
                               np.asarray(jv[-1])[:, page_size:], rtol=0, atol=1e-5)
