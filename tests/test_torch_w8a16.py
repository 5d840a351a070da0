"""The W8A16 matmul's plain version and plan on the CPU, against the JAX
package (``csrc/int8_matmul.cu`` runs on the card: ``test_torch_cuda.py``).

- The int8 weight-only ``linear`` (``[in, out]`` layout, with and without a
  bias, on a layer's view of a stacked leaf), the tied int8 ``unembed``
  (``[vocab, d]``) and an untied int8 lm_head against
  ``dots_ocr_tpu.models``'s, with ``quantize_kernel`` /
  ``quantize_embedding`` weights, at the rows of a decode step (1, 3, 64),
  a k = 2 verify (192) and a small chunk across two leading axes (300): the
  linear equal to the last bit (the products are exact in float32 on both
  sides), the float32 logits within 1e-5 (their summation order).
- ``w8a16_plan`` at every flagship shape and the 192 / 193 boundary: the
  regime by rows, the row tile that holds the rows, clusters whose ranks
  cover the contraction's units exactly, and enough CTAs to fill the card.
- On the CPU ``linear`` and ``unembed`` never reach the kernel.

Inputs come from numpy seeds and reach both frameworks as the same arrays.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.models import decoder as jdec
from dots_ocr_tpu.models import layers as jlayers
from dots_ocr_tpu.models import quantize as jquant
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu_torch.models import decoder as tdec
from dots_ocr_tpu_torch.models import layers as tlayers
from dots_ocr_tpu_torch.models import quantize as tquant
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.ops import int8_matmul as w8
from dots_ocr_tpu_torch.ops import kernel_lib

ROWS = [1, 3, 64, 192, 300]
# The flagship decoder's int8 linears (K, N) and its tied lm_head (K, N of
# the unembed: the weight is [N, K]).
FLAGSHIP = {"wq_wo": (1536, 1536), "wk_wv": (1536, 256), "gate_up": (1536, 8960),
            "down": (8960, 1536), "lm_head": (1536, 151936)}
SMS = 132  # an H100 SXM


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _x(rng, rows, k):
    """bf16-representable activations: [rows, k], or [2, rows / 2, k] for an
    even chunk of more than 192 rows (the leading axes are flattened)."""
    x = rng.randn(rows, k).astype(np.float32)
    if rows > 192:
        x = x.reshape(2, rows // 2, k)
    return x


def _bf16_ulp(x):
    """One bf16 unit in the last place at |x| (7 stored mantissa bits)."""
    return 2.0 ** (np.floor(np.log2(np.abs(x) + 1e-30)) - 7)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rows", ROWS)
def test_int8_linear_plain_equals_jax_on_stacked_views(rows, with_bias):
    """Equal to the last bit where the float32 sums are exact in any order
    (activations on a grid of 1/8 below 4: every product of an int8 weight
    and such an x is a multiple of 1/8 and every partial sum stays below
    2^21); within one bf16 ulp for N(0, 1) activations, where XLA:CPU and
    torch's CPU matmul add the exact products in different orders."""
    rng = np.random.RandomState(rows + 7 * with_bias)
    k, n, layers = 256, 384, 3
    w = (0.05 * rng.randn(layers, k, n)).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    jq = jquant.quantize_kernel(jnp.asarray(w[1]))  # the JAX package quantizes a layer
    tq = tquant.quantize_kernel(torch.from_numpy(w))  # the stacked [L, in, out] leaf
    np.testing.assert_array_equal(np.asarray(jq["qint8"]), tq["qint8"][1].numpy())
    b_j = jnp.asarray(bias) if with_bias else None
    b_t = torch.from_numpy(bias) if with_bias else None
    layer = tlayers.layer_params({"w": tq}, 1)["w"]
    assert layer["qint8"].data_ptr() == tq["qint8"][1].data_ptr()  # a view, not a copy
    x = _x(rng, rows, k)
    for exact, xv in ((True, np.clip(np.round(x * 8) / 8, -3.875, 3.875)), (False, x)):
        xb, xt = jnp.asarray(xv, jnp.bfloat16), torch.from_numpy(xv).to(torch.bfloat16)
        ours = tlayers.linear(xt, layer, b_t)
        ref = _np(jlayers.linear(xb, jq, b_j))
        assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == x.shape[:-1] + (n,)
        if exact:
            np.testing.assert_array_equal(_np(ours), ref)
        else:
            assert (np.abs(_np(ours) - ref) <= _bf16_ulp(ref)).all()
        # the wrapper's plain version is the same function
        np.testing.assert_array_equal(
            _np(w8.int8_linear_reference(xt, layer["qint8"], layer["scale"], b_t)), _np(ours))


@pytest.mark.parametrize("rows", ROWS)
def test_int8_unembed_plain_within_1e5_of_jax(rows):
    rng = np.random.RandomState(100 + rows)
    vocab, d = 640, 128
    emb = (0.05 * rng.randn(vocab, d)).astype(np.float32)
    x = _x(rng, rows, d)
    je, te = jquant.quantize_embedding(jnp.asarray(emb)), tquant.quantize_embedding(
        torch.from_numpy(emb))
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    ours = tlayers.unembed(xt, te)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == x.shape[:-1] + (vocab,)
    np.testing.assert_allclose(_np(ours), _np(jlayers.unembed(xb, je)), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        _np(w8.int8_unembed_reference(xt, te["qint8"], te["scale"])), _np(ours))


def test_untied_int8_head_plain_within_1e5_of_jax():
    cfg = dataclasses.replace(DotsOCRConfig.tiny(), dtype="bfloat16")
    jcfg = JaxConfig.tiny().replace(dtype="bfloat16")
    untied_t = dataclasses.replace(cfg.decoder, tie_word_embeddings=False)
    untied_j = dataclasses.replace(jcfg.decoder, tie_word_embeddings=False)
    rng = np.random.RandomState(9)
    d, vocab = cfg.decoder.hidden_size, cfg.decoder.vocab_size
    hidden = rng.randn(3, d).astype(np.float32)
    head = (0.1 * rng.randn(d, vocab)).astype(np.float32)
    jh, th = jquant.quantize_kernel(jnp.asarray(head)), tquant.quantize_kernel(
        torch.from_numpy(head))
    ours = tdec.logits_from_hidden({"lm_head": th}, untied_t,
                                   torch.from_numpy(hidden).to(torch.bfloat16))
    ref = jdec.logits_from_hidden({"lm_head": jh}, untied_j, jnp.asarray(hidden, jnp.bfloat16))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(_np(ours), _np(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("rows", [1, 3, 16, 17, 32, 33, 64, 192, 193, 2048])
@pytest.mark.parametrize("shape", sorted(FLAGSHIP))
def test_w8a16_plan_at_flagship_shapes(shape, rows):
    """The regime by rows alone (split up to 192, wgmma from 193, its
    contraction over the fewest ranks that fill the card twice, balanced); the
    smallest row tile that holds the rows, or a smaller one only where the
    largest clusters over that tile's grid would leave half the SMs without
    a CTA;
    cluster ranks whose contiguous unit ranges cover the contraction
    exactly, each a nonempty range; and as many units on the longest rank as
    with the fewest ranks that give every SM CTAS_PER_SM CTAs (or the most
    the cluster takes: at most MAX_CLUSTER, at most one a unit), on as few
    ranks as that allows."""
    k, n = FLAGSHIP[shape]
    nk = shape == "lm_head"
    assert k % w8.K_MULTIPLE == 0 and n % w8.SPLIT_COLS == 0
    plan = w8.w8a16_plan(rows, k, n, SMS, nk)
    if rows > w8.SPLIT_ROWS:
        assert plan.regime == "wgmma" and plan.rows_tile == 0
        blocks = k // w8.K_MULTIPLE
        wgmma_tiles = -(-rows // w8.WGMMA_ROWS) * (n // w8.SPLIT_COLS)
        fewest = max(1, min(w8.MAX_CLUSTER, blocks,
                            -(-w8.WGMMA_CTAS_PER_SM * SMS // wgmma_tiles)))
        assert 1 <= plan.cluster <= fewest
        assert -(-blocks // plan.cluster) == -(-blocks // fewest)
        return
    assert plan.regime == "split" and plan.rows_tile in w8.ROW_TILES
    units = k // w8.SPLIT_UNIT[nk]
    most = min(w8.MAX_CLUSTER, units)

    def tiles(tile):
        return -(-rows // tile) * (n // w8.SPLIT_COLS)

    holds = next((t for t in w8.ROW_TILES if rows <= t), w8.ROW_TILES[-1])
    assert plan.rows_tile <= holds
    for larger in (t for t in w8.ROW_TILES if plan.rows_tile < t <= holds):
        assert 2 * tiles(larger) * most < SMS
    ranges = w8.unit_ranges(k, plan.cluster, nk)
    assert ranges[0][0] == 0 and ranges[-1][1] == units
    assert all(a < b for a, b in ranges)
    assert all(prev[1] == nxt[0] for prev, nxt in zip(ranges, ranges[1:]))
    assert 1 <= plan.cluster <= most
    # The fewest ranks that give CTAS_PER_SM CTAs an SM (or the most the
    # cluster takes), then the fewest ranks with no longer share of units.
    target = w8.CTAS_PER_SM * SMS
    fewest = max(1, min(most, -(-target // tiles(plan.rows_tile))))
    longest = -(-units // fewest)
    assert max(b - a for a, b in ranges) == longest
    assert plan.cluster == 1 or -(-units // (plan.cluster - 1)) > longest


def test_w8a16_plan_spreads_over_the_card_at_every_flagship_decode_shape():
    """At a one-slot and a 64-slot decode step and a k = 2 verify every
    linear's grid has a CTA for at least half the 132 SMs: wq / wo and down
    at 64 rows take 96 CTAs of 64 rows (12 column tiles x 8 ranks), which
    the card runs faster than twice as many CTAs of 32 rows (kernel_ab.py's
    sweep), and wk / wv takes 16-row tiles and 8 ranks of 3 units up to 64
    rows (64 CTAs at 64 rows: 4 row tiles x 2 column tiles x 8 ranks), the
    most the design gives it."""
    for shape, (k, n) in FLAGSHIP.items():
        for rows in (1, 64, 192):
            plan = w8.w8a16_plan(rows, k, n, SMS, shape == "lm_head")
            ctas = plan.cluster * -(-rows // plan.rows_tile) * (n // w8.SPLIT_COLS)
            if shape == "wk_wv" and rows <= 64:  # the most CTAs the design gives it
                assert plan == w8.W8A16Plan(16, w8.MAX_CLUSTER)
            else:
                assert 2 * ctas >= SMS, (shape, rows, plan)
    assert w8.w8a16_plan(64, 1536, 1536, SMS) == w8.W8A16Plan(64, 8)
    assert w8.w8a16_plan(64, 8960, 1536, SMS) == w8.W8A16Plan(64, 8)
    assert w8.w8a16_plan(64, 1536, 256, SMS) == w8.W8A16Plan(16, 8)
    assert w8.w8a16_plan(64, 1536, 151936, SMS, True) == w8.W8A16Plan(64, 1)


def test_w8a16_plan_splits_the_wgmma_regime_only_where_tiles_are_few():
    """A 2,048-row prefill chunk: gate/up (70 x 16 tiles) takes one rank;
    wq/wo and down (12 x 16 = 192 tiles, one CTA an SM) two; wk/wv (2 x 16)
    six ranks of 2 of its 12 blocks; the lm_head's 1,187 column tiles one."""
    plans = {shape: w8.w8a16_plan(2048, k, n, SMS, shape == "lm_head").cluster
             for shape, (k, n) in FLAGSHIP.items()}
    assert plans == {"wq_wo": 2, "wk_wv": 6, "gate_up": 1, "down": 2, "lm_head": 1}
    assert w8.w8a16_plan(193, 8960, 1536, SMS) == w8.W8A16Plan(0, 8)


def test_linear_and_unembed_on_cpu_never_reach_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(kernel_lib, "load", refuse)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(5, 128).astype(np.float32)).to(torch.bfloat16)
    qk = tquant.quantize_kernel(torch.from_numpy(rng.randn(128, 256).astype(np.float32)))
    qe = tquant.quantize_embedding(torch.from_numpy(rng.randn(384, 128).astype(np.float32)))
    counts = (w8.w8a16_matmul.launches, w8.w8a16_matmul.split_launches,
              w8.w8a16_matmul.wgmma_launches)
    assert tlayers.linear(x, qk, torch.ones(256)).shape == (5, 256)
    assert tlayers.unembed(x, qe).shape == (5, 384)
    assert w8.w8a16_matmul(x, qk["qint8"], qk["scale"], out_f32=True).dtype == torch.float32
    assert counts == (w8.w8a16_matmul.launches, w8.w8a16_matmul.split_launches,
                      w8.w8a16_matmul.wgmma_launches)
