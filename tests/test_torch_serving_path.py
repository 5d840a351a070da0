"""The shipped serving path's decoder steps against the JAX package on the
CPU (tiny config, float32, bridged weights): the chunked prefill extend,
the speculative verify step and the int8 decode step, with bf16-mode
(float32 here) and int8 pools, including the pools and scales they write.

Both sides start from the same cache: a prefix of numpy K/V written by each
package's ``write_prefill_kv``. The port runs ``attn_impl="xla"`` against
the JAX package's XLA paths (what its engine runs on a CPU), and its kernel
path (the kernels' plain versions here) against the JAX package's Pallas
kernels in interpret mode where the JAX decoder can call them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.engine import kv_cache as jkv
from dots_ocr_tpu.models import decoder as jdec
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu_torch.engine import kv_cache as tkv
from dots_ocr_tpu_torch.models import decoder as tdec
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params

CPU = torch.device("cpu")
PAGE, NUM_PAGES, MAX_PAGES = 8, 24, 6


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    jparams = jax_init(jax.random.PRNGKey(1), JaxConfig.tiny(), scale=0.1)
    cfg = DotsOCRConfig.tiny()
    return cfg, jparams, from_numpy_params(jax.tree.map(np.asarray, jparams), cfg, CPU)


class Cache:
    """The same paged cache in both packages, with ``prefix[row]`` tokens
    of random K/V already written for each row."""

    def __init__(self, cfg, prefix, quantized, extra, seed=0):
        rng = np.random.RandomState(seed)
        dc = cfg.decoder
        self.alloc = tkv.PageAllocator(NUM_PAGES, PAGE, MAX_PAGES)
        t = max(prefix)
        slot_map = np.full((len(prefix), t), -1, np.int32)
        for row, n in enumerate(prefix):
            self.alloc.allocate(row, n + extra)
            slot_map[row, :n] = self.alloc.slot_mapping(row, 0, n)
        self.tables = np.stack([self.alloc.padded_table(r) for r in range(len(prefix))])
        shape = (dc.num_layers, len(prefix), t, dc.num_kv_heads, dc.head_dim)
        k, v = rng.randn(*shape).astype(np.float32), rng.randn(*shape).astype(np.float32)
        self.jax = jkv.write_prefill_kv(
            jkv.PagedKV.create(JaxConfig.tiny().decoder, NUM_PAGES, PAGE, dtype=jnp.float32,
                               quantized=quantized),
            jnp.asarray(k), jnp.asarray(v), jnp.asarray(slot_map.reshape(-1)))
        self.torch = tkv.PagedKV.create(dc, NUM_PAGES, PAGE, torch.float32, CPU, quantized)
        tkv.write_prefill_kv(self.torch, _t(k), _t(v), _t(slot_map.reshape(-1)))

    def jax_args(self):
        return dict(k_scales=self.jax.k_scale, v_scales=self.jax.v_scale)

    def torch_args(self):
        return dict(k_scales=self.torch.k_scale, v_scales=self.torch.v_scale)

    def check_pools(self, jk, jv, jks, jvs, scale_rtol=1e-5):
        """Every pool and scale the JAX step returned equals the port's
        in-place state: float pools within 1e-5, int8 codes at most one
        apart (a K/V value within float32 summation noise, or the kernel
        path's bf16 P rounding, of a rounding boundary flips one code) and
        their scales within ``scale_rtol``."""
        for layer in range(len(jk)):
            for ours, ref in ((self.torch.k, jk), (self.torch.v, jv)):
                a, b = ours[layer].numpy().astype(np.float32), np.asarray(ref[layer], np.float32)
                if self.torch.quantized:
                    assert np.abs(a - b).max() <= 1
                else:
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
            if self.torch.quantized:
                for ours, ref in ((self.torch.k_scale, jks), (self.torch.v_scale, jvs)):
                    np.testing.assert_allclose(ours[layer].numpy(), np.asarray(ref[layer]),
                                               rtol=scale_rtol, atol=0)


IMPLS = [("xla", "xla"), ("kernel", "flash_interpret")]


@pytest.mark.parametrize("quantized", [False, True], ids=["f32_kv", "int8_kv"])
@pytest.mark.parametrize("impl,jax_impl", IMPLS)
def test_prefill_extend_matches_jax(weights, quantized, impl, jax_impl):
    """Second chunk (q_offset 16, kv_hi 32) of two prompts of 40 and 25
    tokens over a 16-token prefix. Hidden states of the valid rows: 1e-4
    (float32 stacks in different summation order); with int8 KV the
    gathered K/V are bf16 and both packages round P to bf16, the kernel
    path before normalizing it and the XLA path after: 2e-2 there."""
    cfg, jparams, tparams = weights
    dc = cfg.decoder
    chunk, q_offset = 16, 16
    kv_hi = q_offset + chunk
    plen = np.array([40, 25])
    cache = Cache(cfg, [q_offset, q_offset], quantized, extra=plen.max() - q_offset)
    rng = np.random.RandomState(5)
    embeds = rng.randn(2, chunk, dc.hidden_size).astype(np.float32)
    positions = q_offset + np.arange(chunk)
    slots = np.zeros((2, chunk), np.int32)
    for row in range(2):
        n = min(chunk, plen[row] - q_offset)
        slots[row, :n] = cache.alloc.slot_mapping(row, q_offset, n)
    tables = cache.tables[:, :kv_hi // PAGE]
    jh, jk, jv, jks, jvs = jdec.decoder_prefill_extend_batched(
        jparams["decoder"], JaxConfig.tiny().decoder, jnp.asarray(embeds),
        jnp.asarray(positions), jnp.asarray(plen), cache.jax.k, cache.jax.v,
        jnp.asarray(tables), jnp.asarray(slots), PAGE, kv_hi, q_offset,
        attn_impl=jax_impl, **cache.jax_args())
    h = tdec.decoder_prefill_extend_batched(
        tparams["decoder"], dc, _t(embeds), _t(positions), _t(plen), cache.torch.k,
        cache.torch.v, _t(tables), _t(slots), PAGE, kv_hi, q_offset, attn_impl=impl,
        **cache.torch_args())
    bf16_p = quantized and impl == "kernel"
    for row in range(2):
        n = min(chunk, plen[row] - q_offset)
        np.testing.assert_allclose(h[row, :n].numpy(), np.asarray(jh)[row, :n], rtol=0,
                                   atol=2e-2 if bf16_p else 1e-4)
    # Layers past the first write K/V from those hidden states: their
    # scales then agree to the same 1e-2.
    cache.check_pools(jk, jv, jks, jvs, scale_rtol=1e-2 if bf16_p else 1e-5)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32_kv", "int8_kv"])
@pytest.mark.parametrize("impl,jax_impl", [("xla", "reference"), ("kernel", "paged_interpret")])
def test_spec_step_matches_jax(weights, quantized, impl, jax_impl):
    """A k = 2 verify step (nq = 3) for three slots, one inactive: the
    drafts' K/V are scattered before attention on both sides. 1e-4 on the
    active slots' hidden states: the int8 plain version at its 64-token
    tile and the Pallas kernel at its 48-token block see one tile here."""
    cfg, jparams, tparams = weights
    dc = cfg.decoder
    nq = 3
    base = np.array([10, 0, 21])  # 0: inactive slot
    cache = Cache(cfg, [10, 1, 21], quantized, extra=nq, seed=1)
    rng = np.random.RandomState(6)
    embeds = rng.randn(3, nq, dc.hidden_size).astype(np.float32)
    live = base > 0
    positions = np.where(live[:, None], base[:, None] + np.arange(nq), 0)
    slots = np.zeros((3, nq), np.int32)
    for row in np.nonzero(live)[0]:
        slots[row] = cache.alloc.slot_mapping(int(row), int(base[row]), nq)
    seq_lens = np.where(live, base + 1, 0).astype(np.int32)
    jh, jk, jv, jks, jvs = jdec.decoder_spec_step_paged(
        jparams["decoder"], JaxConfig.tiny().decoder, jnp.asarray(embeds),
        jnp.asarray(positions), cache.jax.k, cache.jax.v, jnp.asarray(cache.tables),
        jnp.asarray(seq_lens), jnp.asarray(slots), PAGE, attn_impl=jax_impl,
        **cache.jax_args())
    h = tdec.decoder_spec_step_paged(
        tparams["decoder"], dc, _t(embeds), _t(positions), cache.torch.k, cache.torch.v,
        _t(cache.tables), _t(seq_lens), _t(slots), PAGE, attn_impl=impl,
        **cache.torch_args())
    assert h.shape == (3, nq, dc.hidden_size)
    np.testing.assert_allclose(h[live].numpy(), np.asarray(jh)[live], rtol=0, atol=1e-4)
    cache.check_pools(jk, jv, jks, jvs)


@pytest.mark.parametrize("impl,jax_impl", [("xla", "reference"), ("kernel", "paged_interpret")])
def test_int8_decode_step_matches_jax(weights, impl, jax_impl):
    """Four decode steps (nq = 1) over an int8 cache, each step's token K/V
    quantized and written with its scales at head * N + slot; the logits
    within 1e-4 at every step."""
    cfg, jparams, tparams = weights
    dc = cfg.decoder
    base = np.array([5, 17])
    cache = Cache(cfg, list(base), True, extra=4, seed=2)
    rng = np.random.RandomState(7)
    jk, jv, jks, jvs = cache.jax.k, cache.jax.v, cache.jax.k_scale, cache.jax.v_scale
    for step in range(4):
        pos = base + step
        slots = np.array([cache.alloc.slot_mapping(r, int(pos[r]), 1)[0] for r in range(2)])
        x = rng.randn(2, dc.hidden_size).astype(np.float32)
        jh, jk, jv, jks, jvs = jdec.decoder_decode_step_paged(
            jparams["decoder"], JaxConfig.tiny().decoder, jnp.asarray(x), jnp.asarray(pos),
            jk, jv, jnp.asarray(cache.tables), jnp.asarray(pos + 1, jnp.int32),
            jnp.asarray(slots, jnp.int32), PAGE, attn_impl=jax_impl, k_scales=jks, v_scales=jvs)
        h = tdec.decoder_decode_step_paged(
            tparams["decoder"], dc, _t(x), _t(pos), cache.torch.k, cache.torch.v,
            _t(cache.tables), _t((pos + 1).astype(np.int32)), _t(slots), PAGE,
            attn_impl=impl, **cache.torch_args())
        np.testing.assert_allclose(
            tdec.logits_from_hidden(tparams["decoder"], dc, h).numpy(),
            np.asarray(jdec.logits_from_hidden(jparams["decoder"], JaxConfig.tiny().decoder, jh)),
            rtol=0, atol=1e-4)
    cache.check_pools(jk, jv, jks, jvs)
