"""The port's batch engine against the JAX package's on the CPU: the
dense-cache decoder step by step (``KVCache``, ``decoder_decode_step``,
``vlm_decode_step``, ``scatter_kv_rows``), then ``generate`` and
``InferenceEngine`` token for token (greedy, seeded sampled with and
without the nucleus, unseeded through the engine's key chain, with an
image, and a mixed batch), ``from_pretrained`` over a synthetic
checkpoint, and the port's server with ``--engine batch``.

Both sides run ``DotsOCRConfig.tiny()`` in float32 on the same weights
(scale 0.3); the port's engine picks the JAX engine's CPU attention path
(``attn_impl="auto"`` -> ``"xla"`` on the CPU). Tolerances: logits 1e-4
(summation order), cache rows 1e-4, tokens exact.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from dots_ocr_tpu.engine.engine import InferenceEngine as JaxEngine
from dots_ocr_tpu.engine.generate import generate as jax_generate
from dots_ocr_tpu.models import decoder as jdec
from dots_ocr_tpu.models import vlm as jvlm
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine.engine import InferenceEngine
from dots_ocr_tpu_torch.engine.generate import bucket_length, generate
from dots_ocr_tpu_torch.engine.sampling import prng_key
from dots_ocr_tpu_torch.models import decoder as tdec
from dots_ocr_tpu_torch.models import vlm as tvlm
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.models.loader import save_checkpoint
from dots_ocr_tpu_torch.serve import server as torch_server
from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer

CPU = torch.device("cpu")
ENGINE_KW = dict(prompt_bucket_step=32, vision_bucket_step=16, default_max_new_tokens=8)


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(jax.random.PRNGKey(0), JaxConfig.tiny(), scale=0.3)
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), DotsOCRConfig.tiny(), CPU)
    return jparams, tparams


@pytest.fixture(scope="module")
def engines(weights):
    jparams, tparams = weights
    return JaxEngine(jparams, JaxConfig.tiny(), **ENGINE_KW), \
        InferenceEngine(tparams, DotsOCRConfig.tiny(), **ENGINE_KW)


def _image(seed, shape=(64, 80, 3)):
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, shape, np.uint8))


def test_dense_decode_steps_match_jax(weights):
    """Prefill into a widened KVCache, then four decode steps fed the same
    tokens: logits and cache rows equal the JAX dense path's."""
    jparams, tparams = weights
    jcfg, cfg = JaxConfig.tiny(), DotsOCRConfig.tiny()
    rng = np.random.RandomState(0)
    lens = np.array([5, 11], np.int32)
    t = 16
    ids = rng.randint(0, 300, (2, t)).astype(np.int32)
    pos = np.broadcast_to(np.arange(t), (2, t)).astype(np.int32)
    jlog, jcache = jvlm.vlm_prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                                    jnp.asarray(lens), last_logit_only=True)
    tlog, tcache = tvlm.vlm_prefill(tparams, cfg, torch.from_numpy(ids).long(),
                                    torch.from_numpy(pos).long(), torch.from_numpy(lens).long(),
                                    attn_impl="xla", last_logit_only=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
    total = t + 4
    jc = jdec.KVCache.create(jcfg.decoder, 2, total, dtype=jnp.float32)
    jc = jdec.KVCache(jc.k.at[:, :, :t].set(jcache.k), jc.v.at[:, :, :t].set(jcache.v))
    tc = tdec.KVCache.create(cfg.decoder, 2, total, dtype=torch.float32)
    tc.k[:, :, :t], tc.v[:, :, :t] = tcache.k, tcache.v
    tokens = np.asarray(jlog).argmax(-1).astype(np.int32)
    p = lens.copy()
    for _ in range(4):
        jl, jc = jvlm.vlm_decode_step(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(p), jc,
                                      jnp.asarray(p + 1))
        tl, tc = tvlm.vlm_decode_step(tparams, cfg, torch.from_numpy(tokens).long(),
                                      torch.from_numpy(p).long(), tc,
                                      torch.from_numpy(p + 1).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
        tokens, p = np.asarray(jl).argmax(-1).astype(np.int32), p + 1
    for row in range(2):
        n = int(p[row])
        np.testing.assert_allclose(tc.k[:, row, :n].numpy(), np.asarray(jc.k)[:, row, :n],
                                   rtol=0, atol=1e-4)


def test_scatter_kv_rows_matches_jax():
    rng = np.random.RandomState(1)
    pool = rng.randn(2, 40, 8).astype(np.float32)
    slots = np.array([3, 17, 0, 39], np.int32)
    upd = rng.randn(4, 2, 8).astype(np.float32)
    want = np.asarray(jdec.scatter_kv_rows(jnp.asarray(pool), jnp.asarray(slots), jnp.asarray(upd)))
    got = tdec.scatter_kv_rows(torch.from_numpy(pool.copy()), torch.from_numpy(slots),
                               torch.from_numpy(upd))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nucleus", [False, True])
def test_generate_matches_jax(weights, nucleus):
    """``generate`` itself, sampled at mixed temperatures from one key:
    the legacy chain (a split before the first draw and one per step)."""
    jparams, tparams = weights
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 300, (3, 32)).astype(np.int32)
    lens = np.array([7, 32, 19], np.int32)
    temps = np.array([0.0, 0.8, 1.1], np.float32)
    top_p = np.array([1.0, 0.9, 1.0], np.float32)
    want = jax_generate(jparams, JaxConfig.tiny(), jnp.asarray(ids), jnp.asarray(lens),
                        jax.random.PRNGKey(5), jnp.asarray(temps), jnp.asarray(top_p),
                        max_new_tokens=10, nucleus=nucleus)
    got = generate(tparams, DotsOCRConfig.tiny(), torch.from_numpy(ids).long(),
                   torch.from_numpy(lens).long(), prng_key(5), torch.from_numpy(temps),
                   torch.from_numpy(top_p), max_new_tokens=10, attn_impl="xla", nucleus=nucleus)
    assert (got.tokens.numpy() == np.asarray(want.tokens)).all()
    assert (got.num_generated.numpy() == np.asarray(want.num_generated)).all()
    assert bucket_length(130) == 256 and bucket_length(5) == 128


@pytest.mark.parametrize("kw", [
    dict(temperature=0.0),
    dict(temperature=0.7, top_p=0.9, seed=3),
    dict(temperature=0.7, top_p=1.0, seed=4),
    dict(temperature=[0.0, 0.7, 1.0], top_p=[1.0, 0.9, 1.0], seed=9),
], ids=["greedy", "seeded_nucleus", "seeded_full_vocab", "mixed"])
def test_generate_batch_matches_jax(engines, kw):
    jeng, teng = engines
    prompts = ["Extract the text.", "hello world", "a longer text prompt here"]
    images = [[_image(0)], [], [_image(1, (56, 56, 3))]]
    want = jeng.generate_batch(prompts, images, max_new_tokens=10, **kw)
    got = teng.generate_batch(prompts, images, max_new_tokens=10, **kw)
    assert got == want
    assert vars(teng.last_stats)["completion_tokens"] == jeng.last_stats.completion_tokens
    assert teng.last_stats.vision_tokens == jeng.last_stats.vision_tokens > 0


def test_unseeded_chain_and_generate_one_match_jax(weights):
    """Unseeded sampled calls draw successive splits of the engine chain
    (PRNGKey(0) at construction), as the JAX engine."""
    jparams, tparams = weights
    jeng = JaxEngine(jparams, JaxConfig.tiny(), **ENGINE_KW)
    teng = InferenceEngine(tparams, DotsOCRConfig.tiny(), **ENGINE_KW)
    for prompt in ("first call", "second call", "first call"):
        want = jeng.generate_one(prompt, temperature=0.9, max_new_tokens=6)
        assert teng.generate_one(prompt, temperature=0.9, max_new_tokens=6) == want
    img = _image(3)
    assert teng.generate_one("describe", images=[img], temperature=0.0, max_new_tokens=4) == \
        jeng.generate_one("describe", images=[img], temperature=0.0, max_new_tokens=4)


def test_from_pretrained_and_random_init(tmp_path, weights):
    _, tparams = weights
    save_checkpoint(str(tmp_path), tparams, DotsOCRConfig.tiny())
    eng = InferenceEngine.from_pretrained(str(tmp_path), config=DotsOCRConfig.tiny(),
                                          device="cpu", **ENGINE_KW)
    assert eng.device.type == "cpu" and eng.attn_impl == "xla"
    assert torch.equal(eng.params["decoder"]["embed"], tparams["decoder"]["embed"])
    rand = InferenceEngine.random_init(device="cpu", **ENGINE_KW)
    assert rand.config == DotsOCRConfig.tiny()
    assert isinstance(rand.generate_one("hi", temperature=0.0, max_new_tokens=3), str)
    zeros = InferenceEngine.random_init(device="cpu", zeros=True)
    assert not zeros.params["decoder"]["embed"].any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngine.from_pretrained(str(tmp_path))


def test_server_engine_batch_and_weights_answer(tmp_path, weights):
    """``--engine batch --platform cpu`` builds the batch engine over a
    checkpoint directory (``--weights``), warms up and answers over HTTP,
    a seeded request included."""
    _, tparams = weights
    save_checkpoint(str(tmp_path), tparams, DotsOCRConfig.tiny())
    args = torch_server.build_parser().parse_args(
        ["--platform", "cpu", "--engine", "batch", "--weights", str(tmp_path)])
    eng = torch_server.build_engine(args)
    assert isinstance(eng, InferenceEngine) and eng.config.dtype == "bfloat16"
    # the loaded tiny checkpoint keeps the tiny shapes; serve it with the
    # tiny config's special ids (a synthetic checkpoint has no tokenizer)
    eng = InferenceEngine(tparams, DotsOCRConfig.tiny(), device="cpu", **ENGINE_KW)
    torch_server.warm_up(eng)

    async def run():
        from aiohttp.test_utils import TestClient, TestServer

        client = TestClient(TestServer(OpenAIServer(eng, model_name="tiny").build_app()))
        await client.start_server()
        try:
            bodies = [{"messages": [{"role": "user", "content": f"req {i}"}], "max_tokens": 4,
                       "temperature": 0, "seed": 1} for i in range(3)]
            resps = await asyncio.gather(*[client.post("/v1/chat/completions", json=b)
                                           for b in bodies])
            assert all(r.status == 200 for r in resps)
            return [(await r.json())["usage"]["completion_tokens"] for r in resps]
        finally:
            await client.close()

    assert all(0 < n for n in asyncio.run(run()))
    cont = torch_server.build_engine(torch_server.build_parser().parse_args(
        ["--platform", "cpu", "--weights", str(tmp_path), "--num-pages", "64",
         "--page-size", "8", "--max-slots", "4", "--max-seq-tokens", "128"]))
    assert torch.equal(cont.params["decoder"]["final_norm"],
                       tparams["decoder"]["final_norm"].to(torch.bfloat16))
