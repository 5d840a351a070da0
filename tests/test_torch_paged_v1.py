"""Kernel 3 (the v1 paged decode kernel) in the port against the JAX
package, on the CPU: its plain version against the Pallas kernel in
interpret mode, the multi-query dispatch rule against the JAX package's,
and the decoder's ``attn_impl="v1"`` decode step against the JAX decoder."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.engine.kv_cache import quantize_kv as jax_quantize_kv
from dots_ocr_tpu.models import decoder as jdec
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.ops import paged_attention as jpaged
from dots_ocr_tpu_torch.models import decoder as tdec
from dots_ocr_tpu_torch.ops import paged_attention as tpaged
from test_torch_cuda import paged_inputs
from test_torch_serving_path import PAGE, Cache, _t, weights  # noqa: F401 (fixture)

# 0-length rows, partial last pages, rows of exactly one and several pages;
# the table is wider than any row needs (null page 0 past each row's end).
LENGTHS = [37, 0, 16, 1, 50, 0, 9]


def _inputs(seed, page_size, quantized, d=32, kv=2, h=8):
    rng = np.random.RandomState(seed)
    q, kp, vp, lens, table = paged_inputs(rng, LENGTHS, 1, kv, h, d, page_size,
                                          -(-64 // page_size) + 1)
    q = jnp.asarray(q[:, 0], jnp.bfloat16)
    if quantized:
        (kp, ks), (vp, vs) = jax_quantize_kv(jnp.asarray(kp)), jax_quantize_kv(jnp.asarray(vp))
    else:
        kp, vp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        ks = vs = None
    return q, kp, vp, ks, vs, jnp.asarray(lens), jnp.asarray(table)


def _torch(x):
    if x is None:
        return None
    a = np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)
    t = torch.from_numpy(np.array(a))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_v1_reference_matches_pallas_interpret(page_size, quantized):
    """Within 1 bf16 ulp of the output plus 1e-5: the same page tiles and
    rounding steps (P rounded to bf16, int8 V dequantized to bf16, K in
    float32), only the float32 summation order differs. Length-0 rows are
    exact zeros on both sides."""
    q, kp, vp, ks, vs, lens, table = _inputs(page_size, page_size, quantized)
    pallas = np.asarray(jpaged.paged_attention(q, kp, vp, lens, table, interpret=True,
                                               k_scales=ks, v_scales=vs), np.float32)
    ours = tpaged.paged_attention(*(_torch(x) for x in (q, kp, vp, lens, table)),
                                  k_scales=_torch(ks), v_scales=_torch(vs))
    ours = ours.float().numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(pallas), 1e-30))) - 7)
    assert (np.abs(ours - pallas) <= ulp + 1e-5).all(), np.abs(ours - pallas).max()
    zero = np.asarray(lens) == 0
    assert (ours[zero] == 0).all() and (pallas[zero] == 0).all()
    # the stacked form reads the layer by index
    k_all = torch.stack([torch.zeros_like(_torch(kp)), _torch(kp)]).flatten(2, 3)
    v_all = torch.stack([torch.zeros_like(_torch(vp)), _torch(vp)]).flatten(2, 3)
    scales = {}
    if quantized:
        scales = {"k_scales_all": torch.stack([torch.ones_like(_torch(ks)), _torch(ks)]).flatten(2),
                  "v_scales_all": torch.stack([torch.ones_like(_torch(vs)), _torch(vs)]).flatten(2)}
    stacked = tpaged.paged_attention_stacked(_torch(q), k_all, v_all, 1, _torch(lens),
                                             _torch(table), page_size, **scales)
    np.testing.assert_array_equal(stacked.float().numpy(), ours)


# Rows of length 0 and 1, exactly one split of 64, a split and one, split
# boundaries inside rows, a row shorter than one split.
V1_SPLIT_LENGTHS = [0, 1, 64, 65, 150, 30, 127, 191]


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("page_size", [8, 16])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_v1_split_plain_matches_unsplit_and_pallas(quantized, page_size, chunk):
    """Kernel 3's plain version in its kernel's order (a fresh online
    softmax per split of ``chunk`` tokens over 64-token steps, the splits
    merged by log-sum-exp) against the unsplit one (the CPU wrapper's,
    bit for bit the Pallas kernel in interpret mode here) and the Pallas
    kernel: P is rounded to bf16 against other running maxima, so outputs
    move by at most 2^-7 |ref| + 0.05 x the RMS over D of the row (the card's
    tight bound), and 1e-2 relative RMS. Its partials merge to its output
    bit for bit; a split past a row's length is dead (m = -inf, l = 0,
    o = 0); length 0 gives exact zeros on every side."""
    rng = np.random.RandomState(page_size + chunk)
    q, kp, vp, lens, table = paged_inputs(rng, V1_SPLIT_LENGTHS, 1, 2, 8, 32, page_size,
                                          192 // page_size)
    q = jnp.asarray(q[:, 0], jnp.bfloat16)
    if quantized:
        (kp, ks), (vp, vs) = jax_quantize_kv(jnp.asarray(kp)), jax_quantize_kv(jnp.asarray(vp))
    else:
        kp, vp = jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16)
        ks = vs = None
    pallas = torch.from_numpy(np.asarray(jpaged.paged_attention(
        q, kp, vp, jnp.asarray(lens), jnp.asarray(table), interpret=True, k_scales=ks,
        v_scales=vs), np.float32))
    tq, tk, tv, tks, tvs = (_torch(x) for x in (q, kp, vp, ks, vs))
    (k_all, ks_all), (v_all, vs_all) = tpaged._stack_one(tk, tks), tpaged._stack_one(tv, tvs)
    args = (tq, k_all, v_all, 0, torch.from_numpy(lens), torch.from_numpy(table), page_size,
            ks_all, vs_all)
    unsplit = tpaged.paged_attention_v1_reference(*args)
    split = tpaged.paged_attention_v1_reference(*args, chunk=chunk)
    assert torch.equal(unsplit.float(), pallas)
    err = (split.float() - pallas).abs()
    allow = 2.0**-7 * pallas.abs() + 0.05 * pallas.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool((err <= allow).all()), float(torch.where(err > 0, err / allow, 0.0).max())
    assert float(err.norm()) <= 1e-2 * float(pallas.norm())
    assert (split[0] == 0).all() and (pallas[0] == 0).all()
    m, l, o = tpaged.paged_v1_split_partials(*args[:7], chunk, *args[7:])
    n_split = -(-192 // chunk)
    assert m.shape == (len(V1_SPLIT_LENGTHS), n_split, 1, 8) and o.shape == (*m.shape, 32)
    assert torch.equal(tpaged.merge_split_partials(m, l, o, base2=False)[:, 0].to(split.dtype),
                       split)
    for row, n in enumerate(V1_SPLIT_LENGTHS):
        live = -(-n // chunk)
        assert torch.isfinite(m[row, :live]).all() and (l[row, :live] > 0).all()
        assert torch.isinf(m[row, live:]).all() and (l[row, live:] == 0).all()
        assert (o[row, live:] == 0).all()


def _jax_route(head_dim, page_size, quantized, nq, monkeypatch):
    """Which function the JAX package's paged_attention_multiquery computes
    at these shapes: its two fallbacks are replaced by recorders and its
    Pallas call by a sentinel (kernel 2)."""
    seen = []

    class Kernel2(Exception):
        pass

    def kernel2(*args, **kwargs):
        raise Kernel2

    monkeypatch.setattr(jpaged, "paged_attention",
                        lambda q, *a, **k: seen.append("v1") or q)
    monkeypatch.setattr(jpaged, "paged_attention_multiquery_reference",
                        lambda q, *a, **k: seen.append("xla") or q)
    monkeypatch.setattr(jpaged.pl, "pallas_call", kernel2)
    q = jnp.zeros((1, nq, 4, head_dim), jnp.bfloat16)
    pages = jnp.zeros((2, 2, page_size, head_dim), jnp.int8 if quantized else jnp.bfloat16)
    scales = jnp.ones((2, 2, page_size), jnp.float32) if quantized else None
    try:
        jpaged.paged_attention_multiquery.__wrapped__(
            q, pages, pages, jnp.ones((1,), jnp.int32), jnp.ones((1, 2), jnp.int32),
            k_scales=scales, v_scales=scales)
    except Kernel2:
        seen.append("multiquery")
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_choose_paged_kernel_follows_jax_rule(quantized, nq, monkeypatch):
    for head_dim in (16, 64, 96, 128, 256):
        for page_size in (8, 16, 64, 128, 256):
            want = _jax_route(head_dim, page_size, quantized, nq, monkeypatch)
            assert tpaged.choose_paged_kernel(head_dim, page_size, quantized, nq) == want, (
                head_dim, page_size)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32_kv", "int8_kv"])
def test_decoder_v1_step_matches_jax_reference(weights, quantized):  # noqa: F811
    """Three decode steps with ``attn_impl="v1"`` (kernel 3's plain version
    on every layer) against the JAX decoder's reference branch, logits and
    pools. float32 pools: 1e-4 (summation order). int8 pools: kernel 3
    keeps K times its scale in float32 where the reference rounds it to
    bf16, and rounds P to bf16 before normalizing where the reference
    rounds after: 2e-2."""
    cfg, jparams, tparams = weights
    dc, jdc = cfg.decoder, JaxConfig.tiny().decoder
    base = np.array([5, 17, 0])  # 0: an inactive slot
    cache = Cache(cfg, [5, 17, 1], quantized, extra=3, seed=3)
    rng = np.random.RandomState(8)
    jk, jv, jks, jvs = cache.jax.k, cache.jax.v, cache.jax.k_scale, cache.jax.v_scale
    live = base > 0
    for step in range(3):
        pos = np.where(live, base + step, 0)
        slots = np.array([cache.alloc.slot_mapping(r, int(pos[r]), 1)[0] if live[r] else 0
                          for r in range(3)])
        lens = np.where(live, pos + 1, 0).astype(np.int32)
        x = rng.randn(3, dc.hidden_size).astype(np.float32)
        jh, jk, jv, jks, jvs = jdec.decoder_decode_step_paged(
            jparams["decoder"], jdc, jnp.asarray(x), jnp.asarray(pos), jk, jv,
            jnp.asarray(cache.tables), jnp.asarray(lens), jnp.asarray(slots, jnp.int32), PAGE,
            attn_impl="reference", k_scales=jks, v_scales=jvs)
        h = tdec.decoder_decode_step_paged(
            tparams["decoder"], dc, _t(x), _t(pos), cache.torch.k, cache.torch.v,
            _t(cache.tables), _t(lens), _t(slots), PAGE, attn_impl="v1",
            **cache.torch_args())
        np.testing.assert_allclose(
            tdec.logits_from_hidden(tparams["decoder"], dc, h).numpy()[live],
            np.asarray(jdec.logits_from_hidden(jparams["decoder"], jdc, jh))[live],
            rtol=0, atol=2e-2 if quantized else 1e-4)
    cache.check_pools(jk, jv, jks, jvs, scale_rtol=1e-2 if quantized else 1e-5)
    with pytest.raises(ValueError, match="one query"):
        tdec.decoder_spec_step_paged(
            tparams["decoder"], dc, _t(rng.randn(3, 3, dc.hidden_size).astype(np.float32)),
            _t(np.zeros((3, 3), np.int64)), cache.torch.k, cache.torch.v, _t(cache.tables),
            _t(np.zeros(3, np.int32)), _t(np.zeros((3, 3), np.int32)), PAGE, attn_impl="v1",
            **cache.torch_args())
