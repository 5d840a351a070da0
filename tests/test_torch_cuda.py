"""The port's CUDA kernels against their plain versions, on the card (bf16).

Every test here is marked ``cuda`` and skips where torch sees no GPU: a
CUDA kernel has no CPU mode. This module imports no jax (the card's host
has none), so it runs there without the repo's jax-configuring conftest:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

The input builders are shared with ``test_torch_kernels.py``, which holds
the same cases against the JAX package's Pallas kernels on the CPU.
"""

import numpy as np
import pytest
import torch

from dots_ocr_tpu_torch.engine.kv_cache import quantize_kv
from dots_ocr_tpu_torch.models.layers import linear, matmul_f32
from dots_ocr_tpu_torch.models.quantize import quantize_kernel_act, quantize_kernel_int4
from dots_ocr_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain
from dots_ocr_tpu_torch.ops.flash_attention import (
    BLOCK_K,
    TILE_MASKED,
    TILE_SKIP,
    TILE_UNMASKED,
    _flash_launch,
    _tile_ranges,
    flash_attention,
    flash_attention_reference,
    flash_tile_plan,
)
from dots_ocr_tpu_torch.ops.paged_attention import (
    INT8_TILE,
    _paged_bf16_launch,
    merge_split_partials,
    paged_attention,
    paged_attention_int8_reference,
    paged_attention_multiquery,
    paged_attention_multiquery_bf16,
    paged_attention_multiquery_int8,
    paged_attention_multiquery_reference,
    paged_attention_stacked,
    paged_attention_v1_reference,
    paged_split_partials,
    paged_split_plan,
)
from dots_ocr_tpu_torch.ops.window_attention import window_attention, window_attention_reference

FLASH_CASES = {
    # name: (B, Tq, S, H, KV, D, segment lengths per row, causal, q_offset)
    "vision_packed": (1, 96, 96, 4, 4, 16, [[40, 30]], False, 0),
    "prefill_causal_padded": (2, 64, 64, 4, 2, 16, [[50], [64]], True, 0),
    "extend_q_offset": (2, 32, 96, 4, 2, 16, None, True, 64),
}


def packed_segments(b, t, lens_per_row):
    """Segment ids in packing order: 0, 1, ... then -1 padding AFTER the
    positive ids (ids are not monotonic)."""
    seg = np.full((b, t), -1, np.int32)
    for row, lens in enumerate(lens_per_row):
        off = 0
        for i, n in enumerate(lens):
            seg[row, off:off + n] = i
            off += n
    return seg


def int8_pools(k_pages, v_pages):
    """quantize_kv of float pools: (k_i8, v_i8, k_scales, v_scales), the
    scales shaped [KV, num_pages, page_size] as the kernel reads them."""
    kq, ks = quantize_kv(torch.as_tensor(k_pages))
    vq, vs = quantize_kv(torch.as_tensor(v_pages))
    return kq, vq, ks, vs


def paged_inputs(rng, lengths, nq, kv, h, d, page_size, max_pages):
    """q and a pool of random junk (unreferenced slots too) with shuffled
    pages; rows get pages for lengths[b] + nq - 1 tokens."""
    batch = len(lengths)
    num_pages = batch * max_pages + 1
    k_pages = rng.randn(kv, num_pages, page_size, d).astype(np.float32)
    v_pages = rng.randn(kv, num_pages, page_size, d).astype(np.float32)
    table = np.zeros((batch, max_pages), np.int32)  # null page 0 as padding
    free = list(rng.permutation(num_pages - 1) + 1)
    for row, n in enumerate(lengths):
        need = -(-(n + nq - 1) // page_size) if n > 0 else 0
        for p in range(need):
            table[row, p] = free.pop()
    q = rng.randn(batch, nq, h, d).astype(np.float32)
    return q, k_pages, v_pages, np.asarray(lengths, np.int32), table


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _bf16_close(out, ref):
    """bf16 I/O: 2^-8 relative rounding on each side plus f32 summation
    order; probabilities enter P @ V rounded to bf16."""
    err = (out.float() - ref.float()).abs()
    assert torch.isfinite(out.float()).all()
    assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all()), float(err.max())


def _attention_close(out, ref):
    """The bound of chip_smoke.py's tight_errors for the redesigned kernels
    1 and 2 (bf16), scaled to the output: per element one bf16 ulp of the
    plain value plus 5% of the RMS over D of that (row, head) of the plain
    output, and a relative RMS error of at most 1e-2 over the whole output
    (P rounded to bf16 against another running max gives ~3e-3; V rounded
    through fp8 e4m3 ~3e-2)."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    allow = 2.0**-7 * ref.abs() + 0.05 * ref.pow(2).mean(-1, keepdim=True).sqrt()
    assert bool((err <= allow).all()), float(torch.where(err > 0, err / allow, 0.0).max())
    assert float(err.norm()) <= 1e-2 * float(ref.norm()), float(err.norm() / ref.norm())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain_on_card(cuda, case, d):
    b, tq, s, h, kv, _, seg_lens, causal, q_offset = FLASH_CASES[case]
    scale = 5  # several 64-row tiles, ragged edges
    tq, s, q_offset = tq * scale + 3, s * scale + 3, q_offset * scale
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, tq, h, d, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(b, s, kv, d, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(b, s, kv, d, generator=gen, device=cuda).to(torch.bfloat16)
    if seg_lens is None:
        q_seg = torch.zeros(b, tq, dtype=torch.int32, device=cuda)
        kv_seg = torch.zeros(b, s, dtype=torch.int32, device=cuda)
    else:
        rows = [[n * scale for n in row] for row in seg_lens]
        q_seg = kv_seg = torch.from_numpy(packed_segments(b, s, rows)).to(cuda)
    out = flash_attention(q, k, v, q_seg, kv_seg, causal=causal, q_offset=q_offset)
    ref = flash_attention_reference(q, k, v, q_seg, kv_seg, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    _bf16_close(out, ref)
    _attention_close(out, ref)
    assert (out[q_seg < 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("nq", [1, 3])
def test_paged_kernel_matches_plain_on_card(cuda, nq, page_size):
    rng = np.random.RandomState(nq)
    lengths = [700, 0, 5, 1, 130, 2049]
    q, kp, vp, lens, table = paged_inputs(
        rng, lengths, nq, 2, 12, 128, page_size, -(-2100 // page_size))
    args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, kp, vp)]
    args += [torch.from_numpy(x).to(cuda) for x in (lens, table)]
    before = paged_attention_multiquery_bf16.launches
    out = paged_attention_multiquery_bf16(*args)
    ref = paged_attention_multiquery_reference(*args)
    assert paged_attention_multiquery_bf16.launches == before + 1
    torch.cuda.synchronize()
    _bf16_close(out, ref)
    _attention_close(out, ref)
    assert (out[1] == 0).all()  # length 0: exact zeros


def _segment_runs(runs):
    """Segment ids from (id, count) runs, in the given (unsorted) order."""
    return np.concatenate([np.full(n, i, np.int32) for i, n in runs])


# name: (Tq, q (id, count) runs, kv runs or None (= q's), causal, q_offset);
# H = 4 query heads over KV = 2 heads.
FLASH_TILE_CASES = {
    # 8 windows of 256 tokens and a partial one: most tiles skipped, the
    # rest unmasked; Tq is not a multiple of 128.
    "windowed": (2148, [(w, 256) for w in range(8)] + [(8, 100)], None, False, 0),
    # id 0 twice, -1 between segments, ids out of order.
    "non_monotonic": (560, [(0, 150), (-1, 30), (2, 200), (1, 90), (-1, 20), (0, 70)], None,
                      False, 0),
    # Q tile one segment; KV tile 1 that segment except its last key (-1),
    # and KV tile 3 except its last key (another id).
    "tile_uniform_but_last_key": (128, [(0, 128)], [(0, 127), (-1, 1), (0, 127), (5, 1), (0, 64)],
                                  False, 0),
    # causal chunk at an offset that is no tile multiple, Tq not a multiple
    # of 128, padding past the prompt.
    "q_offset_unaligned": (300, [(0, 260), (-1, 40)], [(0, 337), (-1, 40)], True, 77),
}


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(FLASH_TILE_CASES))
def test_flash_kernel_tile_list_cases_on_card(cuda, case, d):
    """The tile list's skipped, masked and unmasked tiles (flash_tile_plan
    shows every class occurs) against the plain version."""
    tq, q_runs, kv_runs, causal, q_offset = FLASH_TILE_CASES[case]
    q_seg = _segment_runs(q_runs)
    kv_seg = q_seg if kv_runs is None else _segment_runs(kv_runs)
    s = len(kv_seg)
    assert len(q_seg) == tq
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(1, tq, 4, d, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(1, s, 2, d, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(1, s, 2, d, generator=gen, device=cuda).to(torch.bfloat16)
    qs, ks = (torch.from_numpy(x[None]).to(cuda) for x in (q_seg, kv_seg))
    plan = flash_tile_plan(qs, ks, causal, q_offset)
    if case == "windowed":
        assert {TILE_SKIP, TILE_UNMASKED} <= set(plan.unique().tolist())
    if case == "tile_uniform_but_last_key":
        assert plan[0, 0].tolist() == [TILE_UNMASKED, TILE_MASKED, TILE_UNMASKED, TILE_MASKED,
                                       TILE_UNMASKED]
    out = flash_attention(q, k, v, qs, ks, causal=causal, q_offset=q_offset)
    ref = flash_attention_reference(q, k, v, qs, ks, causal=causal, q_offset=q_offset)
    torch.cuda.synchronize()
    _bf16_close(out, ref)
    _attention_close(out, ref)
    assert (out[qs < 0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("page_size,d,nq", [(16, 128, 1), (16, 128, 3), (128, 128, 1),
                                            (128, 128, 3), (16, 64, 3), (128, 64, 1)])
def test_paged_bf16_split_cases_on_card(cuda, page_size, d, nq):
    """The split-K bf16 kernel against its plain version: a row longer than
    one split, rows whose visible span ends exactly on a split, a 64-token
    tile and a page boundary, nq = 3 across a page boundary, length 0, and
    every pool position no row may see (unreferenced pages, the null page,
    the tails of live pages) set to NaN: the kernel's output stays finite
    and equal to the plain version on the same pool with those set to 0."""
    kv, h = 2, 12
    max_pages = -(-4096 // page_size)
    chunk, n_split = paged_split_plan(8, kv, h // kv * nq, d, max_pages * page_size,
                                      torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert n_split > 1 and chunk < 2500
    ends = [2 * chunk + 37, chunk, 2 * chunk, 5 * 64, 3 * page_size, 2 * page_size + 1, nq]
    lengths = [0] + [n - nq + 1 for n in ends]  # visible span len + nq - 1 = n
    rng = np.random.RandomState(page_size + d + nq)
    q, kp, vp, lens, table = paged_inputs(rng, lengths, nq, kv, h, d, page_size, max_pages)
    live = np.zeros(kp.shape[1:3], bool)  # [num_pages, page_size]
    for row, n in enumerate(lengths):
        span = n + nq - 1 if n > 0 else 0
        for pos in range(span):
            live[table[row, pos // page_size], pos % page_size] = True
    kp[:, ~live], vp[:, ~live] = np.nan, np.nan
    args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, kp, vp)]
    args += [torch.from_numpy(x).to(cuda) for x in (lens, table)]
    before = (paged_attention_multiquery_bf16.launches,
              paged_attention_multiquery_bf16.verify_launches)
    out = paged_attention_multiquery_bf16(*args)
    assert paged_attention_multiquery_bf16.launches == before[0] + 1
    assert paged_attention_multiquery_bf16.verify_launches == before[1] + (nq > 1)
    ref = paged_attention_multiquery_reference(args[0], *(torch.nan_to_num(x) for x in args[1:3]),
                                               *args[3:])
    torch.cuda.synchronize()
    _bf16_close(out, ref)
    _attention_close(out, ref)
    assert (out[0] == 0).all()  # length 0: exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_TILE_CASES))
def test_flash_tile_info_matches_tile_ranges_on_card(cuda, case):
    """The kernel's pre-pass records, read back from its tile_info scratch,
    are flash_tile_plan's per-KV-tile ranges (_tile_ranges), and the output
    equals the wrapper's."""
    tq, q_runs, kv_runs, causal, q_offset = FLASH_TILE_CASES[case]
    q_seg = _segment_runs(q_runs)
    kv_seg = q_seg if kv_runs is None else _segment_runs(kv_runs)
    gen = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn(1, tq, 4, 128, generator=gen, device=cuda).to(torch.bfloat16)
    k, v = (torch.randn(1, len(kv_seg), 2, 128, generator=gen, device=cuda).to(torch.bfloat16)
            for _ in range(2))
    qs, ks = (torch.from_numpy(x[None]).to(cuda) for x in (q_seg, kv_seg))
    tile_info = torch.full((1, -(-len(kv_seg) // BLOCK_K), 4), -7, dtype=torch.int32,
                           device=cuda)
    out = _flash_launch(q, k, v, qs, ks, tile_info, causal, q_offset, 128**-0.5)
    lo, hi, one = _tile_ranges(ks, BLOCK_K)
    assert torch.equal(tile_info.long(), torch.stack([lo, hi, one, torch.zeros_like(lo)], -1))
    assert torch.equal(out, flash_attention(q, k, v, qs, ks, causal=causal, q_offset=q_offset))


@pytest.mark.cuda
@pytest.mark.parametrize("page_size,nq", [(16, 1), (16, 3), (128, 3)])
def test_paged_split_scratch_matches_plain_partials_on_card(cuda, page_size, nq):
    """The split kernel's float32 partials, read back from its scratch:
    each live split's (m, l) equal paged_split_partials', its O / l agrees
    within the bound of _attention_close (the kernel rounds P to bf16), a
    row that saw no token of a live split holds l = 0 and O = 0, splits
    past a row's n_tok stay unwritten, and merge_split_partials of the
    kernel's partials gives the kernel's output within one bf16 ulp."""
    kv, h, d = 2, 12, 128
    g = h // kv
    rows = g * nq
    max_pages = -(-4096 // page_size)
    cap = max_pages * page_size
    chunk, n_split = paged_split_plan(8, kv, rows, d, cap,
                                      torch.cuda.get_device_properties(cuda).multi_processor_count)
    lengths = [0, 1, chunk - nq + 1, chunk + 5, 2 * chunk + 37, 3 * page_size, cap - nq + 1,
               700]
    rng = np.random.RandomState(page_size + nq)
    q, kp, vp, lens, table = paged_inputs(rng, lengths, nq, kv, h, d, page_size, max_pages)
    args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, kp, vp)]
    args += [torch.from_numpy(x).to(cuda) for x in (lens, table)]
    batch = len(lengths)
    part_o = torch.full((batch, kv, n_split, rows, d), float("nan"), device=cuda)
    part_ml = torch.full((batch, kv, n_split, rows, 2), float("nan"), device=cuda)
    out = _paged_bf16_launch(*args, part_o, part_ml, chunk, n_split, d**-0.5)

    def plain_layout(x):  # [B, KV, n_split, G * nq, ...] -> [B, n_split, nq, H, ...]
        x = x.reshape(batch, kv, n_split, g, nq, *x.shape[4:])
        return x.permute(0, 2, 4, 1, 3, *range(5, x.dim())).reshape(batch, n_split, nq, h,
                                                                    *x.shape[5:])

    k_o, k_m, k_l = plain_layout(part_o), plain_layout(part_ml[..., 0]), plain_layout(
        part_ml[..., 1])
    p_m, p_l, p_o = paged_split_partials(*args, chunk=chunk)
    n_tok = np.where(lens > 0, np.minimum(lens + nq - 1, cap), 0)
    live = torch.from_numpy(np.arange(n_split)[None] * chunk < n_tok[:, None]).to(cuda)
    assert torch.isnan(k_l[~live]).all() and torch.isnan(k_o[~live]).all()
    seen = live[:, :, None, None] & (p_l > 0)
    empty = live[:, :, None, None] & (p_l == 0)
    assert (k_l[empty] == 0).all() and (k_o[empty] == 0).all()
    assert torch.allclose(k_m[seen], p_m[seen], rtol=1e-4, atol=1e-4)
    assert torch.allclose(k_l[seen], p_l[seen], rtol=1e-4, atol=0)
    _attention_close(k_o[seen] / k_l[seen][:, None], p_o[seen] / p_l[seen][:, None])
    live_ = live[:, :, None, None]
    merged = merge_split_partials(torch.where(live_, k_m, float("-inf")),
                                  torch.where(live_, k_l, 0.0),
                                  torch.where(live_[..., None], k_o, 0.0))
    err = (merged.to(torch.bfloat16).float() - out.float()).abs()
    assert bool((err <= 2.0**-7 * out.float().abs()).all()), float(err.max())
    assert (out[0] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash", "paged_bf16"])
def test_redesigned_kernels_repeat_bit_for_bit_on_card(cuda, kernel):
    """100 calls on the same inputs give the same output bit for bit: a
    causal padded prefill (4 rows of 2,048 positions, 12 heads over 2) for
    kernel 1, a 16-row split-K decode step for kernel 2's bf16 mode."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    if kernel == "flash":
        lens = torch.tensor([2048, 1531, 800, 77], device=cuda)
        seg = torch.where(torch.arange(2048, device=cuda)[None] < lens[:, None], 0, -1)
        seg = seg.to(torch.int32)
        q = torch.randn(4, 2048, 12, 128, generator=gen, device=cuda).to(torch.bfloat16)
        k, v = (torch.randn(4, 2048, 2, 128, generator=gen, device=cuda).to(torch.bfloat16)
                for _ in range(2))

        def call():
            return flash_attention(q, k, v, seg, seg, causal=True)
    else:
        rng = np.random.RandomState(3)
        q, kp, vp, lens, table = paged_inputs(rng, list(rng.randint(0, 3000, 16)), 3, 2, 12,
                                              128, 128, 24)
        args = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (q, kp, vp)]
        args += [torch.from_numpy(x).to(cuda) for x in (lens, table)]

        def call():
            return paged_attention_multiquery_bf16(*args)
    first = call()
    differ = sum(not torch.equal(call(), first) for _ in range(100))
    assert differ == 0, f"{differ} of 100 calls differ from the first"


# int8 lengths: 0, one less than a kernel tile, a tile, page boundaries at
# 16 and 128 (nq = 3 queries straddle them), several tiles.
INT8_LENGTHS = [700, 0, INT8_TILE - 1, INT8_TILE, 127, 15, 1, 2049]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page_size", [16, 128])
@pytest.mark.parametrize("nq,h,kv", [(1, 12, 2), (3, 12, 2), (3, 8, 1)])
def test_paged_int8_kernel_matches_plain_on_card(cuda, nq, h, kv, page_size, d):
    """Kernel vs plain at the kernel's tile: the same integer products and
    rounding steps, so only the softmax denominator's summation order and
    bf16 output rounding differ (the bf16 tolerance covers both)."""
    rng = np.random.RandomState(10 * nq + h)
    q, kp, vp, lens, table = paged_inputs(
        rng, INT8_LENGTHS, nq, kv, h, d, page_size, -(-2100 // page_size))
    kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))
    qd = torch.from_numpy(q).to(cuda, torch.bfloat16)
    lens_t, table_t = torch.from_numpy(lens).to(cuda), torch.from_numpy(table).to(cuda)
    before = paged_attention_multiquery_int8.launches
    out = paged_attention_multiquery_int8(qd, kq, vq, ks, vs, lens_t, table_t)
    ref = paged_attention_int8_reference(qd, kq, vq, ks, vs, lens_t, table_t)
    torch.cuda.synchronize()
    assert paged_attention_multiquery_int8.launches == before + 1
    _bf16_close(out, ref)
    assert (out[1] == 0).all()  # length 0: exact zeros


def _stack(pages, scales):
    """One layer's [KV, num_pages, page_size, D] pool as kernel 3's stack of
    3 layers, the pool in the middle one (the layer pointer offset)."""
    kv, n, ps, d = pages.shape
    flat = pages.reshape(1, kv, n * ps, d)
    stack = torch.cat([torch.zeros_like(flat), flat, torch.zeros_like(flat)]).contiguous()
    if scales is None:
        return stack, None
    sf = scales.reshape(1, kv, n * ps)
    return stack, torch.cat([torch.zeros_like(sf), sf, torch.zeros_like(sf)]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page_size", [16, 64, 128])
def test_paged_v1_kernel_matches_plain_on_card(cuda, page_size, d, quantized):
    """Kernel 3 vs its plain version (the same page tiles and rounding
    steps; float32 summation order and bf16 output rounding differ), on
    the middle layer of a 3-layer stack, with a length-0 row, partial last
    pages and null-page table padding."""
    rng = np.random.RandomState(page_size + d)
    q, kp, vp, lens, table = paged_inputs(
        rng, INT8_LENGTHS, 1, 2, 12, d, page_size, -(-2100 // page_size))
    qd = torch.from_numpy(q[:, 0]).to(cuda, torch.bfloat16)
    lens_t, table_t = torch.from_numpy(lens).to(cuda), torch.from_numpy(table).to(cuda)
    if quantized:
        kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))
    else:
        kq, vq = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (kp, vp))
        ks = vs = None
    (k_all, ks_all), (v_all, vs_all) = _stack(kq, ks), _stack(vq, vs)
    counter = "int8_launches" if quantized else "launches"
    before = getattr(paged_attention_stacked, counter)
    out = paged_attention_stacked(qd, k_all, v_all, 1, lens_t, table_t, page_size, ks_all, vs_all)
    ref = paged_attention_v1_reference(qd, k_all, v_all, 1, lens_t, table_t, page_size,
                                       ks_all, vs_all)
    single = paged_attention(qd, kq, vq, lens_t, table_t, k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert getattr(paged_attention_stacked, counter) == before + 2
    _bf16_close(out, ref)
    assert torch.equal(out, single)
    assert (out[1] == 0).all()  # length 0: exact zeros


@pytest.mark.cuda
def test_paged_dispatch_follows_the_jax_rule_on_card(cuda):
    """int8 K/V at page 64: nq = 1 goes to kernel 3, nq = 3 to the XLA
    reference's twin; at page 128 both go to kernel 2. bf16 at D = 64:
    nq = 1 to kernel 3."""
    for page_size, d, quantized in ((64, 128, True), (128, 128, True), (64, 64, False)):
        for nq in (1, 3):
            rng = np.random.RandomState(nq)
            q, kp, vp, lens, table = paged_inputs(rng, [300, 0, 77], nq, 2, 12, d, page_size,
                                                  -(-400 // page_size))
            qd = torch.from_numpy(q).to(cuda, torch.bfloat16)
            lens_t, table_t = torch.from_numpy(lens).to(cuda), torch.from_numpy(table).to(cuda)
            if quantized:
                kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))
            else:
                kq, vq = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (kp, vp))
                ks = vs = None
            counts = lambda: (paged_attention_stacked.launches,  # noqa: E731
                              paged_attention_stacked.int8_launches,
                              paged_attention_multiquery_bf16.launches,
                              paged_attention_multiquery_int8.launches)
            before = counts()
            out = paged_attention_multiquery(qd, kq, vq, lens_t, table_t, k_scales=ks,
                                             v_scales=vs)
            moved = [a - b for a, b in zip(counts(), before)]
            if page_size == 128:
                assert moved == [0, 0, 0, 1]
            elif nq == 1:
                assert moved == ([0, 1, 0, 0] if quantized else [1, 0, 0, 0])
                ref = paged_attention(qd[:, 0], kq, vq, lens_t, table_t, k_scales=ks,
                                      v_scales=vs)
                assert torch.equal(out[:, 0], ref)
            else:
                assert moved == [0, 0, 0, 0]
                ref = paged_attention_multiquery_reference(qd, kq, vq, lens_t, table_t,
                                                           k_scales=ks, v_scales=vs)
                assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("w", [64, 256])
def test_window_kernel_matches_plain_on_card(cuda, w, d):
    """Kernel 4 vs its plain version on every row (padded query rows and a
    fully padded bucket window included): the same order of rounding, the
    float32 summation order and bf16 output rounding differ."""
    nw, h = 5, 12
    gen = torch.Generator(device=cuda).manual_seed(w + d)
    q, k, v = (torch.randn(nw, w, h, d, generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    seg = torch.zeros(nw, w, dtype=torch.int32, device=cuda)
    seg[1] = 1
    seg[2, w // 3:] = -1  # an edge window's padding
    seg[4] = -1  # a window of the bucket's tail
    before = window_attention.launches
    out = window_attention(q, k, v, seg)
    ref = window_attention_reference(q, k, v, seg)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    _bf16_close(out, ref)
    mean_v = v[4].float().mean(dim=0, keepdim=True).expand(w, h, d)
    assert torch.allclose(out[4].float(), mean_v, atol=2e-2)


@pytest.mark.cuda
def test_matmul_f32_and_linear_on_card(cuda):
    """bf16 products return their float32 sum on the card (cuBLAS with a
    float32 output), as on the CPU."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(7, 256).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(256, 96).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.randn(96).astype(np.float32)).to(torch.bfloat16)
    out = matmul_f32(x.to(cuda), w.to(cuda))
    assert out.dtype == torch.float32
    ref = matmul_f32(x, w)  # CPU: upcast operands, exact products
    np.testing.assert_allclose(out.cpu().numpy(), ref.numpy(), rtol=0, atol=1e-3)
    y = linear(x.to(cuda), w.to(cuda), bias.to(cuda))
    assert y.dtype == torch.bfloat16
    ulp = 2.0 ** (np.floor(np.log2(np.abs((ref + bias.float()).numpy()) + 1e-30)) - 7)
    assert (np.abs(y.float().cpu().numpy() - (ref + bias.float()).numpy()) <= ulp).all()


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(1, 64, 4, 96, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_attention(q.float(), q.float(), q.float())
    pages = torch.zeros(2, 4, 24, 128, dtype=torch.bfloat16, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    table = torch.ones(1, 4, dtype=torch.int32, device=cuda)
    qd = torch.zeros(1, 1, 12, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="page_size"):
        paged_attention_multiquery(qd, pages, pages, lens, table)
    pages8 = torch.zeros(2, 4, 128, 128, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="k_scales"):
        paged_attention_multiquery(qd, pages8, pages8, lens, table)
    scales = torch.ones(2, 4, 128, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        paged_attention_multiquery(qd, pages8, pages8, lens, table,
                                   k_scales=scales.double(), v_scales=scales.double())
    qw = torch.zeros(2, 96, 4, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        window_attention(qw, qw, qw, torch.zeros(2, 96, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="page_size"):
        paged_attention(qd[:, 0], pages, pages, lens, table)


def int4_inputs(rows, k, n, seed):
    """x N(0, 1) bf16 [rows, k] and int4 weights quantized from N(0, 0.02)."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(rows, k).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((0.02 * rng.randn(k, n)).astype(np.float32)).to(torch.bfloat16)
    qk = quantize_kernel_int4(w)
    return x, qk["qint4"], qk["scale4"]


def int4_close(out, ref, act_quant):
    """W4A8: bit-identical (integer group sums, one rounding per scaled
    group, the Pallas order on both sides). W4A16: the products are exact in
    float32 and only their summation order differs, so 1 bf16 ulp of the
    output (2^-7 |ref|) plus 1e-4 for the float32 order near zero."""
    assert torch.isfinite(out.float()).all()
    if act_quant:
        assert torch.equal(out, ref), float((out.float() - ref.float()).abs().max())
    else:
        err = (out.float() - ref.float()).abs()
        assert bool((err <= 2.0**-7 * ref.float().abs() + 1e-4).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("act_quant", [False, True])
@pytest.mark.parametrize("rows", [1, 15, 17, 64, 192, 4096])
def test_int4_kernel_matches_plain_on_card(cuda, rows, act_quant):
    """N = 256 (a 4-block row of tiles), K = 8,960 (the down projection's
    35 packed-row blocks); rows below, at and past a 64-row tile."""
    x, packed, scales = (t.to(cuda) for t in int4_inputs(rows, 8960, 256, rows))
    counter = "w4a8_launches" if act_quant else "launches"
    before = getattr(int4_matmul, counter)
    out = int4_matmul(x, packed, scales, act_quant)
    ref = int4_matmul_plain(x, packed, scales, act_quant)
    torch.cuda.synchronize()
    assert getattr(int4_matmul, counter) == before + 1
    assert out.shape == (rows, 256) and out.dtype == torch.bfloat16
    int4_close(out, ref, act_quant)


@pytest.mark.cuda
def test_int4_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, packed, scales = (t.to(cuda) for t in int4_inputs(8, 512, 256, 0))
    with pytest.raises(ValueError, match="bfloat16"):
        int4_matmul(x.float(), packed, scales)
    with pytest.raises(ValueError, match="multiple of 256"):
        int4_matmul(x[:, :384].contiguous(), packed[:192].contiguous(), scales[:3].contiguous())
    with pytest.raises(ValueError, match="multiple of 128"):
        int4_matmul(x, packed[:, :192].contiguous(), scales[:, :192].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul(x.t().contiguous().t(), packed, scales)
    with pytest.raises(ValueError, match="contiguous"):
        int4_matmul(x, packed[:, ::2], scales[:, ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [5, 300])
def test_w8a8_linear_on_card(cuda, rows):
    """The W8A8 product on the card (``torch._int_mm``, rows padded past 16)
    against the CPU: equal integer products and codes, so equal up to the
    float32 scale multiplies (1 bf16 ulp of the output)."""
    rng = np.random.RandomState(rows)
    x = torch.from_numpy(rng.randn(rows, 1536).astype(np.float32)).to(torch.bfloat16)
    qk = quantize_kernel_act(torch.from_numpy((0.02 * rng.randn(1536, 4224)).astype(np.float32)))
    bias = torch.from_numpy(rng.randn(4224).astype(np.float32)).to(torch.bfloat16)
    ref = linear(x, qk, bias).float()
    out = linear(x.to(cuda), {k: v.to(cuda) for k, v in qk.items()}, bias.to(cuda))
    assert out.dtype == torch.bfloat16
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs() + 1e-30)) - 7)
    assert bool(((out.float().cpu() - ref).abs() <= ulp).all())
