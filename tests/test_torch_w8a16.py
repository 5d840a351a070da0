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
  regime by rows, the row tile (wgmma's N) that holds the rows rounded up
  to 8, the consumer warpgroups a CTA, clusters whose ranks cover the
  contraction exactly in rank order, a grid whose tiles cover N and every
  row, and enough CTAs to fill the card.
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


def _ranks(blocks, tiles):
    """The cluster the plan's rule gives: the most ranks (at most
    MAX_CLUSTER, at most one a 64-deep block) whose CTAs fit one wave of
    one CTA an SM, at least one; then the fewest ranks with no longer share
    of the blocks."""
    most = max(1, min(w8.MAX_CLUSTER, blocks, SMS // tiles))
    per = -(-blocks // most)
    return -(-blocks // per)


@pytest.mark.parametrize("rows", [1, 3, 16, 17, 32, 33, 64, 192, 193, 2048])
@pytest.mark.parametrize("shape", sorted(FLAGSHIP))
def test_w8a16_plan_at_flagship_shapes(shape, rows):
    """The regime by rows alone (decode up to 192, prefill from 193); the
    decode tile the smallest instantiated one that holds every row (a
    multiple of 8 at least the rows rounded up to 8), the prefill tile 128
    rows. Decode: one warpgroup a CTA over the cluster the weight's shape
    gives (the most ranks whose CTAs fit one wave, at least one,
    balanced), the same at every decode row count. Prefill: for a [K, N]
    weight with a long contraction (64 blocks or more) two warpgroups
    splitting it over ranks of 64 blocks; else two of 128 columns where N
    is a multiple of 256 over at most 4 ranks that fit one wave; else one.
    The ranks' contraction ranges cover K exactly and in rank order."""
    k, n = FLAGSHIP[shape]
    nk = shape == "lm_head"
    assert k % w8.K_MULTIPLE == 0 and n % w8.COLS == 0
    plan = w8.w8a16_plan(rows, k, n, SMS, nk)
    assert plan.rows_tile % 8 == 0
    blocks = k // w8.K_BLOCK
    if rows > w8.DECODE_ROWS:
        assert plan.regime == "prefill" and plan.rows_tile == w8.PREFILL_ROWS_TILE
        row_tiles = -(-rows // 128)
        if nk:
            expect = (1, "columns", _ranks(blocks, row_tiles * (n // 128)))
        elif blocks >= 64:
            expect = (2, "contraction", -(-blocks // -(-blocks // (blocks // 64))))
        elif n % 256 == 0:
            most = max(1, min(4, blocks, SMS // (row_tiles * (n // 256))))
            expect = (2, "columns", -(-blocks // -(-blocks // most)))
        else:
            expect = (1, "columns", _ranks(blocks, row_tiles * (n // 128)))
    else:
        assert plan.regime == "decode" and plan.rows_tile >= -(-rows // 8) * 8
        assert plan.rows_tile == min(t for t in w8.ROW_TILES if t >= rows)
        expect = (1, "columns", _ranks(blocks, n // 128))
        assert w8.w8a16_plan(1, k, n, SMS, nk)[2:] == plan[2:]  # the same at any decode rows
    assert (plan.consumers, plan.split, plan.cluster) == expect
    assert plan.cols_tile == (128 * plan.consumers if plan.split == "columns" else 128)
    ranges = w8.contraction_ranges(k, plan.cluster)
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a < b for a, b in ranges)
    assert all(prev[1] == nxt[0] for prev, nxt in zip(ranges, ranges[1:]))
    assert 1 <= plan.cluster <= min(w8.MAX_CLUSTER, blocks)


def test_w8a16_plan_spreads_over_the_card_at_every_flagship_decode_shape():
    """At a one-slot and a 64-slot decode step and a k = 2 verify every
    linear reads its weight once (one row tile), no grid spills into a
    second wave of one CTA an SM, and every shape but wk / wv (2 column
    tiles) puts at least 70 CTAs on the card: gate/up its 70 column tiles on
    one rank; wq / wo and down their 12 over 8 ranks (96 CTAs); the lm_head
    1,187 tiles on one rank; each the same at every decode row count."""
    for shape, (k, n) in FLAGSHIP.items():
        for rows in (1, 64, 192):
            plan = w8.w8a16_plan(rows, k, n, SMS, shape == "lm_head")
            ranks, cols, row_tiles = w8.launch_grid(plan, rows, n)
            assert row_tiles == 1 and plan.consumers == 1
            assert ranks * cols <= SMS or ranks == 1, (shape, rows, plan)
            if shape != "wk_wv":
                assert ranks * cols >= 70, (shape, rows, plan)
    assert w8.w8a16_plan(64, 1536, 8960, SMS) == w8.W8A16Plan("decode", 64, 1, "columns", 1)
    assert w8.w8a16_plan(192, 1536, 8960, SMS) == w8.W8A16Plan("decode", 192, 1, "columns", 1)
    assert w8.w8a16_plan(64, 1536, 1536, SMS) == w8.W8A16Plan("decode", 64, 1, "columns", 8)
    assert w8.w8a16_plan(64, 8960, 1536, SMS) == w8.W8A16Plan("decode", 64, 1, "columns", 8)
    assert w8.w8a16_plan(192, 8960, 1536, SMS) == w8.W8A16Plan("decode", 192, 1, "columns", 8)
    assert w8.w8a16_plan(1, 1536, 151936, SMS, True) == w8.W8A16Plan("decode", 8, 1, "columns", 1)
    assert w8.w8a16_plan(192, 1536, 151936, SMS, True) == w8.W8A16Plan("decode", 192, 1, "columns",
                                                                        1)


def test_w8a16_plan_splits_the_wgmma_regime_only_where_tiles_are_few():
    """A 2,048-row prefill chunk (16 row tiles of 128): gate/up (35 x 16
    tiles of 256 columns) and wq/wo (6 x 16) take one rank; wk/wv (1 x 16
    tiles of 256 columns) four ranks of 6 of its 24 blocks; down (140
    blocks) two warpgroups splitting the contraction over two ranks of 70;
    the lm_head's 1,187 x 16 tiles of 128 columns one."""
    plans = {shape: w8.w8a16_plan(2048, k, n, SMS, shape == "lm_head")
             for shape, (k, n) in FLAGSHIP.items()}
    assert {shape: (p.consumers, p.split, p.cluster) for shape, p in plans.items()} == {
        "wq_wo": (2, "columns", 1), "wk_wv": (2, "columns", 4), "gate_up": (2, "columns", 1),
        "down": (2, "contraction", 2), "lm_head": (1, "columns", 1)}
    assert all(p.regime == "prefill" and p.rows_tile == 128 for p in plans.values())
    assert w8.w8a16_plan(193, 8960, 1536, SMS) == w8.W8A16Plan("prefill", 128, 2, "contraction", 2)


@pytest.mark.parametrize("rows", [1, 7, 8, 9, 63, 64, 65, 191, 192, 193, 2048])
def test_w8a16_rows_round_up_to_a_wgmma_width(rows):
    """The rows of x a CTA (wgmma's N) are a multiple of 8 at least the rows
    rounded up to 8 and at most 256 (wgmma's widest N): rows past M arrive
    as zeros and are never stored; up to 192 rows one tile holds them all,
    so the weight is read once."""
    for shape, (k, n) in FLAGSHIP.items():
        plan = w8.w8a16_plan(rows, k, n, SMS, shape == "lm_head")
        assert plan.rows_tile % 8 == 0 and 8 <= plan.rows_tile <= 256
        assert plan.rows_tile * w8.launch_grid(plan, rows, n)[2] >= -(-rows // 8) * 8
        if rows <= w8.DECODE_ROWS:
            assert plan.rows_tile >= -(-rows // 8) * 8 and w8.launch_grid(plan, rows, n)[2] == 1
            assert plan.rows_tile < 2 * -(-rows // 8) * 8 or plan.rows_tile == 8


@pytest.mark.parametrize("in_dim", [128, 192 * 8, 8960, 1536 + 128])
@pytest.mark.parametrize("cluster", [1, 2, 3, 5, 8])
def test_w8a16_contraction_ranges_cover_k_in_rank_order(in_dim, cluster):
    """The ranks' contraction rows, as the kernel takes them (rank r: blocks
    [r B / C, (r + 1) B / C) of B = K / 64): contiguous and ascending in rank
    order, whole 64-deep blocks, each rank's share within one block of the
    others', together exactly [0, K)."""
    blocks = in_dim // w8.K_BLOCK
    if cluster > blocks:
        return
    ranges = w8.contraction_ranges(in_dim, cluster)
    assert len(ranges) == cluster
    covered = [k for a, b in ranges for k in range(a, b)]
    assert covered == list(range(in_dim))
    assert all(a % w8.K_BLOCK == 0 and b % w8.K_BLOCK == 0 and b > a for a, b in ranges)
    sizes = [b - a for a, b in ranges]
    assert max(sizes) - min(sizes) <= w8.K_BLOCK


@pytest.mark.parametrize("rows", [1, 64, 192, 2048])
def test_w8a16_grid_covers_every_column_and_row(rows):
    """The launch grid's column tiles cover N exactly (no ragged tile: N a
    multiple of the CTA's 128 or 256 columns) and its row tiles every row;
    each dimension fits the launch limits."""
    for shape, (k, n) in FLAGSHIP.items():
        plan = w8.w8a16_plan(rows, k, n, SMS, shape == "lm_head")
        ranks, cols, row_tiles = w8.launch_grid(plan, rows, n)
        assert cols * plan.cols_tile == n and n % plan.cols_tile == 0
        assert (row_tiles - 1) * plan.rows_tile < rows <= row_tiles * plan.rows_tile
        assert ranks == plan.cluster and max(cols, row_tiles) <= 65535


def test_linear_and_unembed_on_cpu_never_reach_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(kernel_lib, "load", refuse)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(5, 128).astype(np.float32)).to(torch.bfloat16)
    qk = tquant.quantize_kernel(torch.from_numpy(rng.randn(128, 256).astype(np.float32)))
    qe = tquant.quantize_embedding(torch.from_numpy(rng.randn(384, 128).astype(np.float32)))
    counts = (w8.w8a16_matmul.launches, w8.w8a16_matmul.decode_launches,
              w8.w8a16_matmul.prefill_launches)
    assert tlayers.linear(x, qk, torch.ones(256)).shape == (5, 256)
    assert tlayers.unembed(x, qe).shape == (5, 384)
    assert w8.w8a16_matmul(x, qk["qint8"], qk["scale"], out_f32=True).dtype == torch.float32
    assert counts == (w8.w8a16_matmul.launches, w8.w8a16_matmul.decode_launches,
                      w8.w8a16_matmul.prefill_launches)
