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
from dots_ocr_tpu_torch.models.quantize import (
    quantize_embedding,
    quantize_kernel,
    quantize_kernel_act,
    quantize_kernel_int4,
)
from dots_ocr_tpu_torch.ops import kernel_lib
from dots_ocr_tpu_torch.ops.int4_matmul import (
    _w4a8_launch,
    int4_matmul,
    int4_matmul_plain,
    int4_regime,
    int4_w4a8_plan,
    w4a8_candidates,
)
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
    int8_tile_walkers,
    _paged_bf16_launch,
    _paged_int8_launch,
    merge_split_partials,
    paged_attention,
    paged_attention_int8_reference,
    paged_attention_multiquery,
    paged_attention_multiquery_bf16,
    paged_attention_multiquery_int8,
    paged_attention_multiquery_reference,
    paged_attention_stacked,
    paged_attention_v1_reference,
    paged_int8_split_partials,
    paged_int8_split_plan,
    paged_split_partials,
    paged_split_plan,
    paged_v1_split_plan,
)
from dots_ocr_tpu_torch.ops.int8_matmul import (
    int8_linear_reference,
    int8_unembed_reference,
    w8a16_matmul,
    w8a16_plan,
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
@pytest.mark.parametrize("kernel", ["flash", "paged_bf16", "paged_int8", "window", "v1_bf16",
                                    "v1_int8", "int4_split", "int4_wgmma", "w4a8_split",
                                    "w4a8_wgmma"])
def test_redesigned_kernels_repeat_bit_for_bit_on_card(cuda, kernel):
    """100 calls on the same inputs give the same output bit for bit: a
    causal padded prefill (4 rows of 2,048 positions, 12 heads over 2) for
    kernel 1, a 16-row split-K verify step for kernel 2 in its bf16 and
    int8 modes, 9 windows of 256 tokens (a padded edge window and a fully
    padded one) for kernel 4, a 16-row split decode step for kernel 3 in
    both modes (its merge), and kernel 5's down projection at 64 rows
    (W4A16: split-K and its reduce; W4A8: the ordered cluster split) and
    2,048 rows (wgmma, both modes)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    if kernel.startswith("v1"):
        rng = np.random.RandomState(3)
        args, _, _ = _v1_case(cuda, rng, list(rng.randint(0, 3000, 16)), 128, 64, 48,
                              kernel == "v1_int8")

        def call():
            return paged_attention_stacked(*args)
    elif kernel.startswith(("int4", "w4a8")):
        rows = 64 if kernel.endswith("split") else 2048
        x, packed, scales = (t.to(cuda) for t in int4_inputs(rows, 8960, 1536, 3))

        def call():
            return int4_matmul(x, packed, scales, kernel.startswith("w4a8"))
    elif kernel == "flash":
        lens = torch.tensor([2048, 1531, 800, 77], device=cuda)
        seg = torch.where(torch.arange(2048, device=cuda)[None] < lens[:, None], 0, -1)
        seg = seg.to(torch.int32)
        q = torch.randn(4, 2048, 12, 128, generator=gen, device=cuda).to(torch.bfloat16)
        k, v = (torch.randn(4, 2048, 2, 128, generator=gen, device=cuda).to(torch.bfloat16)
                for _ in range(2))

        def call():
            return flash_attention(q, k, v, seg, seg, causal=True)
    elif kernel == "window":
        q, k, v = (torch.randn(9, 256, 12, 128, generator=gen, device=cuda).to(torch.bfloat16)
                   for _ in range(3))
        seg = torch.zeros(9, 256, dtype=torch.int32, device=cuda)
        seg[3, 100:], seg[8] = -1, -1

        def call():
            return window_attention(q, k, v, seg)
    else:
        rng = np.random.RandomState(3)
        q, kp, vp, lens, table = paged_inputs(rng, list(rng.randint(0, 3000, 16)), 3, 2, 12,
                                              128, 128, 24)
        qd = torch.from_numpy(q).to(cuda, torch.bfloat16)
        tail = [torch.from_numpy(x).to(cuda) for x in (lens, table)]
        if kernel == "paged_int8":
            kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))

            def call():
                return paged_attention_multiquery_int8(qd, kq, vq, ks, vs, *tail)
        else:
            pools = [torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (kp, vp)]

            def call():
                return paged_attention_multiquery_bf16(qd, *pools, *tail)
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
    bf16 output rounding differ (the bf16 tolerance covers both, against
    the unsplit plain version too). Against the plain version at the
    kernel's split and warps it also holds the bound scaled to the output
    (_attention_close), and at most 1 in 1,000 outputs differs at all."""
    rng = np.random.RandomState(10 * nq + h)
    q, kp, vp, lens, table = paged_inputs(
        rng, INT8_LENGTHS, nq, kv, h, d, page_size, -(-2100 // page_size))
    kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))
    qd = torch.from_numpy(q).to(cuda, torch.bfloat16)
    lens_t, table_t = torch.from_numpy(lens).to(cuda), torch.from_numpy(table).to(cuda)
    before = (paged_attention_multiquery_int8.launches,
              paged_attention_multiquery_int8.verify_launches)
    out = paged_attention_multiquery_int8(qd, kq, vq, ks, vs, lens_t, table_t)
    ref = paged_attention_int8_reference(qd, kq, vq, ks, vs, lens_t, table_t)
    chunk, _ = paged_int8_split_plan(
        len(INT8_LENGTHS), kv, h // kv * nq, d, table.shape[1] * page_size,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    split = paged_attention_int8_reference(qd, kq, vq, ks, vs, lens_t, table_t, chunk=chunk,
                                           warps=int8_tile_walkers(h // kv * nq))
    torch.cuda.synchronize()
    assert paged_attention_multiquery_int8.launches == before[0] + 1
    assert paged_attention_multiquery_int8.verify_launches == before[1] + (nq > 1)
    _bf16_close(out, ref)
    _bf16_close(out, split)
    _attention_close(out, split)
    assert float((out != split).float().mean()) <= 1e-3
    assert (out[1] == 0).all()  # length 0: exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("page_size,nq", [(16, 1), (16, 3), (128, 3)])
def test_paged_int8_split_scratch_matches_plain_partials_on_card(cuda, page_size, nq):
    """The int8 split kernel's float32 partials, read back from its
    scratch, against paged_int8_split_partials at the kernel's split and
    warps: each live split's m is equal, l agrees within 1e-5 relative (the
    summation order), O / l within the bound of _attention_close and 1e-4
    relative RMS; a row that saw no token of a live split holds l = 0 and
    O = 0; splits past a row's n_tok stay unwritten; merge_split_partials
    of the kernel's partials gives the kernel's output within one bf16 ulp.
    Every pool position no row may see holds junk codes under NaN scales:
    the output stays finite and equal to the one on a zeroed pool."""
    kv, h, d = 2, 12, 128
    g = h // kv
    rows = g * nq
    max_pages = -(-4096 // page_size)
    cap = max_pages * page_size
    chunk, n_split = paged_int8_split_plan(
        8, kv, rows, d, cap, torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert n_split > 1 and chunk % INT8_TILE == 0
    lengths = [0, 1, chunk - nq + 1, chunk + 5, 2 * chunk + 37, 3 * page_size, cap - nq + 1,
               700]
    rng = np.random.RandomState(page_size + nq)
    q, kp, vp, lens, table = paged_inputs(rng, lengths, nq, kv, h, d, page_size, max_pages)
    live_pos = np.zeros(kp.shape[1:3], bool)  # [num_pages, page_size]
    for row, n in enumerate(lengths):
        for pos in range(n + nq - 1 if n > 0 else 0):
            live_pos[table[row, pos // page_size], pos % page_size] = True
    dead_pos = torch.from_numpy(~live_pos).to(cuda)
    kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))
    clean = [x.clone() for x in (kq, vq, ks, vs)]
    for pool, scales in ((kq, ks), (vq, vs)):
        pool[:, dead_pos] = 127
        scales[:, dead_pos] = float("nan")
    for pool, scales in zip(clean[:2], clean[2:]):
        pool[:, dead_pos] = 0
        scales[:, dead_pos] = 0.0
    qd = torch.from_numpy(q).to(cuda, torch.bfloat16)
    tail = [torch.from_numpy(x).to(cuda) for x in (lens, table)]
    batch = len(lengths)
    part_o = torch.full((batch, kv, n_split, rows, d), float("nan"), device=cuda)
    part_ml = torch.full((batch, kv, n_split, rows, 2), float("nan"), device=cuda)
    out = _paged_int8_launch(qd, kq, vq, ks, vs, *tail, part_o, part_ml, chunk, n_split,
                             d**-0.5)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, paged_attention_multiquery_int8(qd, *clean, *tail))

    def plain_layout(x):  # [B, KV, n_split, G * nq, ...] -> [B, n_split, nq, H, ...]
        x = x.reshape(batch, kv, n_split, g, nq, *x.shape[4:])
        return x.permute(0, 2, 4, 1, 3, *range(5, x.dim())).reshape(batch, n_split, nq, h,
                                                                    *x.shape[5:])

    k_o, k_m, k_l = plain_layout(part_o), plain_layout(part_ml[..., 0]), plain_layout(
        part_ml[..., 1])
    p_m, p_l, p_o = paged_int8_split_partials(qd, *clean, *tail, chunk=chunk)
    n_tok = np.where(lens > 0, np.minimum(lens + nq - 1, cap), 0)
    live = torch.from_numpy(np.arange(n_split)[None] * chunk < n_tok[:, None]).to(cuda)
    assert torch.isnan(k_l[~live]).all() and torch.isnan(k_o[~live]).all()
    assert torch.isinf(p_m[~live]).all()
    seen = live[:, :, None, None] & (p_l > 0)
    empty = live[:, :, None, None] & (p_l == 0)
    assert (k_l[empty] == 0).all() and (k_o[empty] == 0).all()
    assert torch.equal(k_m[live], p_m[live])
    assert torch.allclose(k_l[seen], p_l[seen], rtol=1e-5, atol=0)
    k_avg, p_avg = k_o[seen] / k_l[seen][:, None], p_o[seen] / p_l[seen][:, None]
    _attention_close(k_avg, p_avg)
    assert float((k_avg - p_avg).norm()) <= 1e-4 * float(p_avg.norm())
    live_ = live[:, :, None, None]
    merged = merge_split_partials(torch.where(live_, k_m, float("-inf")),
                                  torch.where(live_, k_l, 0.0),
                                  torch.where(live_[..., None], k_o, 0.0), base2=False)
    err = (merged.to(torch.bfloat16).float() - out.float()).abs()
    assert bool((err <= 2.0**-7 * out.float().abs()).all()), float(err.max())
    assert (out[0] == 0).all()


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


def _v1_case(cuda, rng, lengths, d, page_size, max_pages, quantized):
    """Kernel 3's arguments over paged_inputs' pools on the card (the middle
    layer of a 3-layer stack), the one-layer pools and their scales, and
    the kernel's plan for them."""
    q, kp, vp, lens, table = paged_inputs(rng, lengths, 1, 2, 12, d, page_size, max_pages)
    qd = torch.from_numpy(q[:, 0]).to(cuda, torch.bfloat16)
    lens_t, table_t = torch.from_numpy(lens).to(cuda), torch.from_numpy(table).to(cuda)
    if quantized:
        kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))
    else:
        kq, vq = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (kp, vp))
        ks = vs = None
    (k_all, ks_all), (v_all, vs_all) = _stack(kq, ks), _stack(vq, vs)
    args = (qd, k_all, v_all, 1, lens_t, table_t, page_size, ks_all, vs_all)
    plan = paged_v1_split_plan(len(lengths), 2, 6, d, max_pages * page_size, page_size,
                               torch.cuda.get_device_properties(cuda).multi_processor_count)
    return args, (kq, vq, ks, vs), plan


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("page_size", [16, 64, 128])
def test_paged_v1_kernel_matches_plain_on_card(cuda, page_size, d, quantized):
    """Kernel 3 vs its plain version, on the middle layer of a 3-layer
    stack, with rows of length 0 and 1, exactly one split and one more,
    partial last pages and null-page table padding. Against the plain
    version in the kernel's order (its split) it holds the bound scaled to
    the output (_attention_close: the products are exact, the float32 sums
    run in another order, the int8 K scale multiplies after the dot), and
    against the unsplit one (the Pallas order) the bf16 tolerance."""
    rng = np.random.RandomState(page_size + d)
    max_pages = -(-2100 // page_size)
    _, _, (chunk, n_split) = _v1_case(cuda, rng, INT8_LENGTHS, d, page_size, max_pages, quantized)
    assert n_split > 1
    lengths = INT8_LENGTHS + [chunk, chunk + 1]
    args, (kq, vq, ks, vs), (chunk, _) = _v1_case(cuda, rng, lengths, d, page_size, max_pages,
                                                  quantized)
    counter = "int8_launches" if quantized else "launches"
    before = getattr(paged_attention_stacked, counter)
    out = paged_attention_stacked(*args)
    ref = paged_attention_v1_reference(*args)
    split = paged_attention_v1_reference(*args, chunk=chunk)
    single = paged_attention(args[0], kq, vq, args[4], args[5], k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    assert getattr(paged_attention_stacked, counter) == before + 2
    _bf16_close(out, ref)
    _attention_close(out, split)
    assert torch.equal(out, single)
    assert (out[1] == 0).all()  # length 0: exact zeros


@pytest.mark.cuda
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("page_size", [16, 64])
def test_paged_v1_kernel_ignores_nan_past_each_row_on_card(cuda, page_size, quantized):
    """Every pool position no row may see holds NaN (int8: junk codes under
    NaN scales), the slots of each row's last page past its length
    included: the output is finite and equal bit for bit to the one on a
    pool zeroed there."""
    rng = np.random.RandomState(page_size)
    lengths = [0, 1, 700, 63, 1500, 5, 2049, 300]
    max_pages = -(-2100 // page_size)
    args, _, _ = _v1_case(cuda, rng, lengths, 128, page_size, max_pages, quantized)
    table = args[5].cpu().numpy()
    live = torch.zeros(args[1].shape[2], dtype=torch.bool)
    for row, n in enumerate(lengths):
        pos = np.arange(n)
        live[torch.from_numpy(table[row, pos // page_size] * page_size + pos % page_size)] = True
    dead = (~live).to(cuda)
    clean, junk = list(args), list(args)
    for i in (1, 2):
        clean[i], junk[i] = args[i].clone(), args[i].clone()
        clean[i][:, :, dead] = 0
        junk[i][:, :, dead] = 127 if quantized else float("nan")
    if quantized:
        for i in (7, 8):
            clean[i], junk[i] = args[i].clone(), args[i].clone()
            clean[i][:, :, dead] = 0.0
            junk[i][:, :, dead] = float("nan")
    out = paged_attention_stacked(*junk)
    assert torch.isfinite(out.float()).all()
    assert torch.equal(out, paged_attention_stacked(*clean))
    assert (out[0] == 0).all()


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
@pytest.mark.parametrize("w", [64, 128, 192, 256])
def test_window_kernel_matches_plain_on_card(cuda, w, d):
    """Kernel 4 vs its plain version on every row (padded query rows and a
    fully padded bucket window included): the same order of rounding, the
    float32 summation order and bf16 output rounding differ; it also holds
    the bound scaled to the output (_attention_close)."""
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
    _attention_close(out, ref)
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
    qw = torch.zeros(2, 320, 4, 128, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="<= 256"):
        window_attention(qw, qw, qw, torch.zeros(2, 320, dtype=torch.int32, device=cuda))


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
@pytest.mark.parametrize("rows", [1, 15, 17, 64, 192, 2048, 4096])
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
@pytest.mark.parametrize("rows", [1, 15, 17, 64, 192, 2048, 4096])
@pytest.mark.parametrize("k,n", [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)],
                         ids=["wq_wo", "wk_wv", "gate_up", "down"])
def test_int4_w4a16_decoder_shapes_on_card(cuda, k, n, rows):
    """W4A16 at the decoder's four linear shapes, in both regimes (split-K
    up to 192 rows with its plan's split, wgmma above), against the plain
    version within INT4_TOL."""
    x, packed, scales = (t.to(cuda) for t in int4_inputs(rows, k, n, k + n + rows))
    assert int4_regime(rows) == ("split" if rows <= 192 else "wgmma")
    out = int4_matmul(x, packed, scales)
    int4_close(out, int4_matmul_plain(x, packed, scales), False)
    assert out.shape == (rows, n)


W4A8_COUNTERS = ("w4a8_launches", "w4a8_split_launches", "w4a8_wgmma_launches")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 64, 65, 192, 193, 2048, 4096])
@pytest.mark.parametrize("k,n", [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)],
                         ids=["wq_wo", "wk_wv", "gate_up", "down"])
def test_int4_w4a8_decoder_shapes_on_card(cuda, k, n, rows):
    """W4A8 at the decoder's four linear shapes, in both regimes (the
    ordered cluster split up to 192 rows with its plan's tiling, wgmma
    above), bit-identical to the plain version; the regime's own counter
    moves with the mode's."""
    x, packed, scales = (t.to(cuda) for t in int4_inputs(rows, k, n, k + n + rows + 1))
    regime = int4_w4a8_plan(rows, k, n, 132).regime
    assert regime == ("split" if rows <= 192 else "wgmma")
    before = [getattr(int4_matmul, name) for name in W4A8_COUNTERS]
    out = int4_matmul(x, packed, scales, True)
    ref = int4_matmul_plain(x, packed, scales, True)
    torch.cuda.synchronize()
    moved = [getattr(int4_matmul, name) - b for name, b in zip(W4A8_COUNTERS, before)]
    assert moved == [1, 1, 0] if regime == "split" else moved == [1, 0, 1]
    assert out.shape == (rows, n)
    int4_close(out, ref, True)


@pytest.mark.cuda
def test_int4_w4a8_long_contraction_on_card(cuda):
    """A contraction whose terms fit no cluster's shared memory (in =
    16,384) runs the wgmma kernel at 64 rows, bit-identical."""
    x, packed, scales = (t.to(cuda) for t in int4_inputs(64, 16384, 256, 11))
    assert int4_w4a8_plan(64, 16384, 256, 132).regime == "wgmma"
    before = int4_matmul.w4a8_wgmma_launches
    out = int4_matmul(x, packed, scales, True)
    int4_close(out, int4_matmul_plain(x, packed, scales, True), True)
    assert int4_matmul.w4a8_wgmma_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 300])
@pytest.mark.parametrize("k,n", [(8960, 1536), (1536, 8960)], ids=["down", "gate_up"])
def test_int4_w4a8_zero_row_and_outlier_on_card(cuda, k, n, rows):
    """An all-zero row (row scale 1, exact zeros out) and a row with one
    large outlier (its other entries quantize to small codes) in either
    regime: bit-identical to the plain version."""
    x, packed, scales = (t.to(cuda) for t in int4_inputs(rows, k, n, 7))
    x[3] = 0
    x[rows - 2, k // 3] = 3000.0
    out = int4_matmul(x, packed, scales, True)
    int4_close(out, int4_matmul_plain(x, packed, scales, True), True)
    assert (out[3] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 192, 300])
@pytest.mark.parametrize("k,n", [(1536, 1536), (1536, 256), (8960, 1536)],
                         ids=["wq_wo", "wk_wv", "down"])
def test_int4_w4a8_every_cluster_tiling_on_card(cuda, k, n, rows):
    """Every column width and cluster size the decode regime takes at these
    shapes (not only the plan's), and both column widths of the wgmma
    regime (300 rows), give the plain version bit for bit."""
    x, packed, scales = (t.to(cuda) for t in int4_inputs(rows, k, n, rows + 5))
    ref = int4_matmul_plain(x, packed, scales, True)
    lib = kernel_lib.load()
    stream = torch.cuda.current_stream().cuda_stream
    tilings = w4a8_candidates(rows, k, n) if rows <= 192 else [(64, 0), (128, 0)]
    for cols, cluster in tilings:
        out = torch.empty(rows, n, dtype=torch.bfloat16, device=cuda)
        kernel_lib.check(_w4a8_launch(lib, x, packed, scales, out, cols, cluster, stream),
                         f"w4a8 {cols} x {cluster}")
        assert torch.equal(out, ref), (cols, cluster)


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


@pytest.mark.cuda
def test_pipelined_engine_matches_synchronous_on_card(cuda):
    """A small engine on the card (the tiny decoder at head_dim 128 in bf16,
    so that prefill runs kernel 1 and decode kernel 2; text prompts, so no
    vision layer) gives the same greedy tokens with the lookahead pipeline
    and deep chunks on (the defaults) as synchronous and shallow, and its
    pipelined chunks are fetched through pinned host buffers, each guarded
    by an event of its own."""
    import dataclasses

    from dots_ocr_tpu_torch.engine.scheduler import (
        ContinuousBatchingEngine,
        HostFetch,
        SchedulerConfig,
    )
    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.ops.paged_attention import paged_attention_multiquery_bf16

    tiny = DotsOCRConfig.tiny()
    cfg = tiny.replace(decoder=dataclasses.replace(tiny.decoder, head_dim=128), dtype="bfloat16")
    params = init_params(cfg, cuda, torch.Generator(device=cuda).manual_seed(0), scale=0.3)
    sched = dict(num_pages=64, page_size=16, max_slots=4, max_pages_per_seq=8,
                 prompt_bucket_step=32, steps_per_sync=2, max_steps_per_sync=8,
                 repetition_min_repeats=0)
    prompts = ["alpha beta", "gamma delta epsilon", "zeta"]
    fetches = []
    real_init = HostFetch.__init__

    def spy(self, tensor):
        real_init(self, tensor)
        fetches.append((self.host.is_pinned(), self.event is not None))

    outputs = {}
    for pipeline in (False, True):
        eng = ContinuousBatchingEngine(params, cfg, cuda, sched=SchedulerConfig(**{
            **sched, "pipeline_decode": pipeline,
            **({} if pipeline else {"max_steps_per_sync": 2})}))
        HostFetch.__init__ = spy
        paged_attention_multiquery_bf16.launches = 0
        try:
            ids = [eng.submit(p, temperature=0.0, max_new_tokens=40) for p in prompts]
            eng.run()
        finally:
            HostFetch.__init__ = real_init
        outputs[pipeline] = [eng.finished_request(i).output_ids for i in ids]
        assert (eng.metrics["pipelined_chunks"] > 0) == pipeline
        assert paged_attention_multiquery_bf16.launches > 0
        assert eng.allocator.free_pages == sched["num_pages"] - 1
    assert outputs[True] == outputs[False]
    assert all(len(toks) == 40 for toks in outputs[True])
    assert fetches and all(pinned and guarded for pinned, guarded in fetches)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab", [(64, 151936), (64, 256), (3, 8193), (1, 5)])
@pytest.mark.parametrize("per_row", [False, True])
def test_gumbel_argmax_kernel_bit_equal_to_plain(cuda, rows, vocab, per_row):
    """The fused seeded draw (csrc/threefry_sample.cu) against its plain
    version on the card: the same tokens and the same Gumbel noise bit for
    bit (shared key over the flat index, or a key per row), with mixed
    temperatures, -inf entries, an all -inf row and a tied row; 10
    repeats bit-equal."""
    from dots_ocr_tpu_torch.engine.sampling import prng_key, split
    from dots_ocr_tpu_torch.ops.sampling import gumbel_argmax, gumbel_noise

    rng = np.random.RandomState(rows + vocab)
    logits = torch.from_numpy((rng.randn(rows, vocab) * 4).astype(np.float32)).to(cuda)
    logits[:, ::7] = float("-inf")
    if rows > 2:
        logits[1] = float("-inf")  # all -inf: token 0
        logits[2] = 0.0            # all tied: the draw decides
    temps = torch.from_numpy(rng.uniform(0.05, 1.5, rows).astype(np.float32)).to(cuda)
    keys = (split(prng_key(rows), rows) if per_row else prng_key(vocab)).to(cuda)
    noise = torch.empty((rows, vocab), dtype=torch.float32, device=cuda)
    before = gumbel_argmax.launches
    got = gumbel_argmax(logits, keys, temps, noise_out=noise)
    assert gumbel_argmax.launches == before + 1
    want_noise = gumbel_noise(keys, rows, vocab)
    want = torch.argmax(want_noise + logits / temps[:, None], dim=-1)
    torch.cuda.synchronize()
    assert torch.equal(noise.view(torch.int32), want_noise.view(torch.int32))
    assert torch.equal(got, want)
    if rows > 2:
        assert int(got[1]) == 0
    for _ in range(10):
        assert torch.equal(gumbel_argmax(logits, keys, temps), got)
    assert torch.equal(gumbel_argmax(logits / temps[:, None], keys), got)


@pytest.mark.cuda
def test_gumbel_argmax_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    from dots_ocr_tpu_torch.engine.sampling import prng_key
    from dots_ocr_tpu_torch.ops.sampling import gumbel_argmax

    logits = torch.zeros((4, 100), device=cuda)
    with pytest.raises(ValueError):
        gumbel_argmax(logits.half(), prng_key(0).to(cuda))
    with pytest.raises(ValueError):
        gumbel_argmax(logits, prng_key(0))  # keys on the CPU
    with pytest.raises(ValueError):
        gumbel_argmax(logits, torch.zeros((3, 2), dtype=torch.int64, device=cuda))


# -- The W8A16 matmul (csrc/int8_matmul.cu) and the threefry entry ----------

# The flagship's int8 linears (K, N, bias) and its tied lm_head ([N, K]).
W8A16_SHAPES = {"wq": (1536, 1536, True), "wk": (1536, 256, True), "gate": (1536, 8960, False),
                "down": (8960, 1536, False), "lm_head": (1536, 151936, False)}
# A tensor-parallel rank's int8 linears (parallel/sharding.py): TP = 2's wq,
# wk/wv (one KV head), gate/up, wo and down; TP = 4's gate/up and down,
# padded from 2,240 to 2,304.
TP_W8A16_SHAPES = {"wq_tp2": (1536, 768, True), "wk_tp2": (1536, 128, True),
                   "gate_tp2": (1536, 4480, False), "wo_tp2": (768, 1536, False),
                   "down_tp2": (4480, 1536, False), "gate_tp4_padded": (1536, 2304, False),
                   "down_tp4_padded": (2304, 1536, False)}
# The row-parallel ones give their float32 partial sums to the all-reduce.
TP_ROW_PARALLEL = {"wo_tp2", "down_tp2", "down_tp4_padded"}


def w8a16_inputs(label, rows, seed, bias_dtype=torch.float32):
    """x N(0, 1) bf16 [rows, K]; int8 weights from quantize_kernel of
    N(0, 0.02) [K, N] (the lm_head: quantize_embedding of N(0, 1) [N, K]);
    a bias N(0, 1) for wq / wk. Returns (x, q, scale, bias, transposed)."""
    k, n, biased = {**W8A16_SHAPES, **TP_W8A16_SHAPES}[label]
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, generator=g, device="cuda").to(torch.bfloat16)
    if label == "lm_head":
        qe = quantize_embedding(torch.randn(n, k, generator=g, device="cuda").to(torch.bfloat16))
        return x, qe["qint8"], qe["scale"], None, True
    qk = quantize_kernel((torch.randn(k, n, generator=g, device="cuda") * 0.02).to(torch.bfloat16))
    bias = torch.randn(n, generator=g, device="cuda").to(bias_dtype) if biased else None
    return x, qk["qint8"], qk["scale"], bias, False


def w8a16_plain(x, q, scale, bias, transposed):
    return (int8_unembed_reference(x, q, scale) if transposed
            else int8_linear_reference(x, q, scale, bias))


def w8a16_close(out, ref, transposed):
    """Kernel and plain version add the same exact float32 products in
    another order: a bf16 output within one bf16 ulp of the plain value
    (2^-7 |ref|) plus 1e-4 for the order near zero; the float32 logits
    within 1e-5 |ref| + 1e-4."""
    assert torch.isfinite(out.float()).all()
    assert out.dtype == (torch.float32 if transposed else torch.bfloat16)
    err = (out.float() - ref.float()).abs()
    rel = 1e-5 if transposed else 2.0**-7
    assert bool((err <= rel * ref.float().abs() + 1e-4).all()), float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("label,rows", [(label, rows) for label in sorted(W8A16_SHAPES)
                                        for rows in (1, 7, 8, 9, 63, 64, 65, 191, 192, 193,
                                                     2048)])
def test_w8a16_kernel_matches_plain_on_card(cuda, label, rows):
    """The W8A16 kernel at the flagship's five shapes (both layouts) and
    the rows of a decode step of one slot and of 64, a k = 2 verify and a
    prefill chunk, and rows on either side of them and of a multiple of 8
    (the zero rows past M are never stored), in its regime, one launch a
    call."""
    x, q, scale, bias, transposed = w8a16_inputs(label, rows, rows)
    regime = w8a16_plan(rows, x.shape[1], q.shape[0] if transposed else q.shape[1],
                        torch.cuda.get_device_properties(cuda).multi_processor_count,
                        transposed).regime
    before = (w8a16_matmul.launches, getattr(w8a16_matmul, f"{regime}_launches"))
    out = w8a16_matmul(x, q, scale, bias, transposed=transposed)
    assert (w8a16_matmul.launches, getattr(w8a16_matmul, f"{regime}_launches")) == (
        before[0] + 1, before[1] + 1)
    w8a16_close(out, w8a16_plain(x, q, scale, bias, transposed), transposed)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3, 17, 33, 193, 300])
@pytest.mark.parametrize("bias_dtype", [torch.float32, torch.bfloat16])
def test_w8a16_ragged_rows_and_bias_types_on_card(cuda, rows, bias_dtype):
    """Row counts between the tiles (3, 17, 33: the 16-, 32- and 64-row
    tiles; 193, 300: the wgmma kernel's ragged last tile), with a float32 and
    a bf16 bias, through ``layers.linear`` as the model calls it on a layer's
    view of a stacked leaf."""
    x, q, scale, bias, _ = w8a16_inputs("wk", rows, 7 * rows, bias_dtype)
    stacked = {"qint8": torch.stack([q, q.flip(0)]), "scale": torch.stack([scale, scale * 2])}
    layer = {"qint8": stacked["qint8"][1], "scale": stacked["scale"][1]}
    out = linear(x, layer, bias)
    w8a16_close(out, int8_linear_reference(x, layer["qint8"], layer["scale"], bias), False)


@pytest.mark.cuda
@pytest.mark.parametrize("label,rows", [("gate", 64), ("wk", 1), ("down", 192), ("wq", 2048),
                                        ("lm_head", 64), ("gate", 192), ("wk", 2048),
                                        ("down", 65), ("lm_head", 193)])
def test_w8a16_kernel_repeats_bit_for_bit_and_captures_on_card(cuda, label, rows):
    """100 repeated calls equal the first bit for bit (the cluster ranks
    add in rank order and a CTA's warpgroups in warpgroup order; no
    atomics), and the call captured in a CUDA graph replays to the same
    output: every launch shape the plan takes on the main path."""
    x, q, scale, bias, transposed = w8a16_inputs(label, rows, 11)
    first = w8a16_matmul(x, q, scale, bias, transposed=transposed)
    for _ in range(100):
        assert torch.equal(w8a16_matmul(x, q, scale, bias, transposed=transposed), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        w8a16_matmul(x, q, scale, bias, transposed=transposed)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = w8a16_matmul(x, q, scale, bias, transposed=transposed)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, first)


@pytest.mark.cuda
@pytest.mark.parametrize("label,rows", [("gate", 64), ("gate", 192), ("down", 9), ("wq", 2048),
                                        ("down", 129)])
def test_w8a16_every_launch_shape_matches_plain_on_card(cuda, label, rows):
    """The kernel at launches the plan does not pick, through the wrapper's
    launch: one warpgroup a CTA; two that split the contraction (up to 128
    rows) or take 128 columns each (at the prefill tile); each over 1, 2, 3
    and 8 cluster ranks; each within the tolerance and repeated bit for
    bit."""
    from dots_ocr_tpu_torch.ops import int8_matmul as w8

    x, q, scale, bias, transposed = w8a16_inputs(label, rows, 5)
    n = q.shape[1]
    plan = w8a16_plan(rows, x.shape[1], n,
                      torch.cuda.get_device_properties(cuda).multi_processor_count, transposed)
    ref = w8a16_plain(x, q, scale, bias, transposed)
    shapes = [(1, "columns")]
    if plan.rows_tile <= w8.PREFILL_ROWS_TILE:  # the contraction split's largest tile
        shapes.append((2, "contraction"))
    if plan.rows_tile == w8.PREFILL_ROWS_TILE and n % 256 == 0:
        shapes.append((2, "columns"))
    for consumers, split in shapes:
        for cluster in (1, 2, 3, 8):
            variant = plan._replace(consumers=consumers, split=split, cluster=cluster)
            outs = []
            for _ in range(2):
                out = torch.empty(rows, n, dtype=torch.bfloat16, device=cuda)
                w8._launch(x, q, scale, bias, out, False, False, variant, cuda.index or 0)
                outs.append(out)
            w8a16_close(outs[0], ref, False)
            assert torch.equal(outs[0], outs[1]), variant


@pytest.mark.cuda
@pytest.mark.parametrize("label", sorted(W8A16_SHAPES))
def test_w8a16_decode_rows_are_batch_invariant_on_card(cuda, label):
    """A row's output is the same bit for bit in a call of any decode row
    count (1 .. 192: the decode regime's launch depends on the weight's
    shape alone), so a request's greedy tokens do not depend on whether a
    step decodes or verifies, nor on the rows beside it."""
    x, q, scale, bias, transposed = w8a16_inputs(label, 192, 13)
    full = w8a16_matmul(x, q, scale, bias, transposed=transposed)
    for rows in (1, 7, 9, 64, 65, 129):
        for start in (0, 192 - rows):
            part = w8a16_matmul(x[start:start + rows].contiguous(), q, scale, bias,
                                transposed=transposed)
            assert torch.equal(part, full[start:start + rows]), (rows, start)


@pytest.mark.cuda
def test_w8a16_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, q, scale, bias, _ = w8a16_inputs("wk", 4, 3)
    with pytest.raises(ValueError, match="bfloat16"):
        w8a16_matmul(x.float(), q, scale)
    with pytest.raises(ValueError, match="multiple of 128"):
        w8a16_matmul(x[:, :100].contiguous(), q[:100].contiguous(), scale)
    with pytest.raises(ValueError, match="multiple of 128"):
        w8a16_matmul(x, q[:, :200].contiguous(), scale[:200].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        w8a16_matmul(x, q.t().contiguous().t(), scale)
    with pytest.raises(ValueError, match="CUDA"):
        w8a16_matmul(x, q.cpu(), scale)
    with pytest.raises(ValueError):
        w8a16_matmul(x, q, scale, bias.double())
    # a launch the library does not build (a row tile it does not
    # instantiate, two 128-column warpgroups below the prefill tile) is
    # refused by the launch, not run
    from dots_ocr_tpu_torch.ops import int8_matmul as w8

    plan = w8a16_plan(4, x.shape[1], q.shape[1],
                      torch.cuda.get_device_properties(cuda).multi_processor_count)
    out = torch.empty(4, q.shape[1], dtype=torch.bfloat16, device=cuda)
    for bad in (plan._replace(rows_tile=24), plan._replace(consumers=2, split="columns"),
                plan._replace(cluster=9)):
        with pytest.raises(RuntimeError, match="w8a16_matmul"):
            w8._launch(x, q, scale, bias, out, False, False, bad, cuda.index or 0)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,vocab", [(64, 151936), (64, 256), (3, 8193), (1, 5)])
@pytest.mark.parametrize("tag", [None, 0, 1])
def test_gumbel_argmax_folds_its_keys_bit_equal_to_plain(cuda, rows, vocab, tag):
    """The draw with its rows' keys folded in its prologue (slot keys,
    positions, a tag) equals the plain version on keys folded in plain
    torch, tokens and noise bit for bit; 100 repeats bit-equal; one launch
    a draw."""
    from dots_ocr_tpu_torch.engine.sampling import prng_key, split
    from dots_ocr_tpu_torch.ops.sampling import (
        fold_keys_reference,
        gumbel_argmax,
        gumbel_argmax_reference,
        gumbel_noise,
        threefry_grid,
    )

    rng = np.random.RandomState(rows + vocab + (tag or 0))
    logits = torch.from_numpy((rng.randn(rows, vocab) * 4).astype(np.float32)).to(cuda)
    logits[:, ::5] = float("-inf")
    if rows > 1:
        logits[rows - 1] = float("-inf")  # all -inf: token 0
    temps = torch.from_numpy(rng.uniform(0.05, 1.5, rows).astype(np.float32)).to(cuda)
    keys = split(prng_key(rows), rows).to(cuda)
    pos = torch.from_numpy(rng.randint(0, 2**31, rows).astype(np.int64)).to(cuda)
    noise = torch.empty((rows, vocab), dtype=torch.float32, device=cuda)
    before = (gumbel_argmax.launches, threefry_grid.launches)
    got = gumbel_argmax(logits, keys, temps, noise_out=noise, positions=pos, tag=tag)
    assert (gumbel_argmax.launches, threefry_grid.launches) == (before[0] + 1, before[1])
    want = gumbel_argmax_reference(logits, keys, temps, positions=pos, tag=tag)
    want_noise = gumbel_noise(fold_keys_reference(keys, pos, tag), rows, vocab)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(noise.view(torch.int32), want_noise.view(torch.int32))
    if rows > 1:
        assert int(got[rows - 1]) == 0
    for _ in range(100):
        assert torch.equal(gumbel_argmax(logits, keys, temps, positions=pos, tag=tag), got)


@pytest.mark.cuda
def test_threefry_entry_bit_equal_to_plain_on_card(cuda):
    """fold_in (by a tensor and by an int), split, random_bits (one key over
    the flat index, per-row keys) and uniform are each one launch of the
    threefry entry, bit-equal to its plain version on the same card."""
    from dots_ocr_tpu_torch.engine.sampling import prng_key
    from dots_ocr_tpu_torch.ops.sampling import (
        BITS,
        UNIFORM,
        fold_in,
        random_bits,
        split,
        threefry2x32_reference,
        threefry_grid,
        threefry_grid_reference,
        uniform,
    )

    key = prng_key(2**32 + 5).to(cuda)
    keys = threefry_grid_reference(key[0], key[1], 0, 0, 64)
    pos = torch.arange(64, device=cuda) * 7919 + 2**31
    cases = [
        (lambda: fold_in(keys, pos), lambda: threefry_grid_reference(keys[:, 0], keys[:, 1], 0, pos)),
        (lambda: fold_in(keys, 1), lambda: threefry_grid_reference(keys[:, 0], keys[:, 1], 0, 1)),
        (lambda: fold_in(key, pos), lambda: threefry_grid_reference(key[0], key[1], 0, pos)),
        (lambda: split(key, 9), lambda: threefry_grid_reference(key[0], key[1], 0, 0, 9)),
        (lambda: random_bits(key, 6 * 37),
         lambda: threefry_grid_reference(key[0:1], key[1:2], 0, 0, 6 * 37, BITS)),
        (lambda: random_bits(keys, 29),
         lambda: threefry_grid_reference(keys[:, 0:1], keys[:, 1:2], 0, 0, 29, BITS)),
        (lambda: uniform(keys, 2, 1e-20),
         lambda: threefry_grid_reference(keys[:, 0:1], keys[:, 1:2], 0, 0, 2, UNIFORM, 1e-20)),
        (lambda: threefry_grid(keys[:, 0], keys[:, 1], pos, pos + 3),
         lambda: torch.stack(threefry2x32_reference(keys[:, 0], keys[:, 1], pos, pos + 3), -1)),
    ]
    for kernel_fn, plain_fn in cases:
        before = threefry_grid.launches
        got = kernel_fn()
        assert threefry_grid.launches == before + 1
        want = plain_fn()
        assert got.shape == want.shape and got.dtype == want.dtype
        if got.dtype == torch.float32:
            got, want = got.view(torch.int32), want.view(torch.int32)
        assert torch.equal(got, want)


# -- CUDA graphs of the decode chunks (engine/graphs.py) ----------------------

# A bf16 decoder at the kernels' head_dim (128), int4-aligned, over pages of
# 128: every decode and verify step goes through kernel 2 (and kernel 5 with
# int4 weights) on text-only requests.
GRAPH_SCHED = dict(num_pages=64, page_size=128, max_slots=4, max_pages_per_seq=4,
                   steps_per_sync=4, max_steps_per_sync=16, prompt_bucket_step=32,
                   repetition_min_repeats=0, pipeline_decode=False)
GRAPH_PROMPTS = ["alpha beta", "gamma delta epsilon", "zeta"]
# name: (scheduler overrides, request options)
GRAPH_MODES = {
    "decode": ({}, dict(temperature=0.0)),
    "decode_sampled_nucleus": ({}, dict(temperature=1.0, top_p=0.9, seed=3)),
    "spec": (dict(speculate_k=2, spec_min_tokens_per_iter=0.0), dict(temperature=0.0)),
    "spec_sampled": (dict(speculate_k=2, spec_min_tokens_per_iter=0.0),
                     dict(temperature=1.0, seed=5)),
    "options": ({}, dict(temperature=1.0, seed=7, logprobs=True, presence_penalty=0.5,
                         frequency_penalty=0.25, logit_bias={5: 2.0, 9: -3.0})),
    "int8_kv": (dict(kv_cache_dtype="int8", speculate_k=2, spec_min_tokens_per_iter=0.0),
                dict(temperature=0.0)),
}


def _graph_params(cuda, kind: str):
    """(config, params) of the card decoder, random from a seed; ``kind``
    "bf16", "int8" or "int4" weights."""
    import dataclasses

    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.models.quantize import (
        quantize_decoder_params,
        quantize_decoder_params_int4,
    )

    tiny = DotsOCRConfig.tiny()
    cfg = tiny.replace(decoder=dataclasses.replace(
        tiny.decoder, hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128,
        intermediate_size=512), dtype="bfloat16")
    params = init_params(cfg, cuda, torch.Generator(device=cuda).manual_seed(0))
    if kind == "int8":
        params = quantize_decoder_params(params)
    elif kind == "int4":
        params = quantize_decoder_params_int4(params)
    return cfg, params


def _graph_engine(cfg, params, cuda, graphs=True, **overrides):
    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig

    sched = SchedulerConfig(**{**GRAPH_SCHED, **overrides}, cuda_graphs=graphs)
    return ContinuousBatchingEngine(params, cfg, cuda, sched=sched, default_max_new_tokens=24)


def _live_chunk(eng, options, depth: int = 3):
    """Submit the prompts with ``options``, step once (admission, prefill,
    one chunk) and refill the chunk inputs from the live rows. Returns
    (inputs, the key of a chunk of ``depth``, a depth step() never uses)."""
    for prompt in GRAPH_PROMPTS:
        eng.submit(prompt, max_new_tokens=24, **options)
    eng.step()
    active = [i for i, r in enumerate(eng._slot_req) if r is not None and r.state == "running"]
    use_pen = bool(options.get("presence_penalty") or options.get("frequency_penalty"))
    use_spec = eng.sched.speculate_k > 0 and not options.get("logprobs") and not use_pen
    dev = eng._chunk_inputs(active, (use_spec, use_pen, bool(options.get("logit_bias"))))
    assert active and bool(dev.active.any())
    return dev, eng._chunk_key(dev, eng.sched.speculate_k if use_spec else 0, depth,
                               bool(options.get("logprobs")))


def _chunk_state(dev):
    return {f: getattr(dev, f).clone() for f in ("tokens", "positions", "budgets", "tables",
                                                 "active", "temps", "top_ps", "keys", "buf",
                                                 "gen_start", "bias_ids", "bias_vals",
                                                 "counts", "pres", "freq")
            if getattr(dev, f) is not None}


def _restore(dev, state):
    for f, value in state.items():
        getattr(dev, f).copy_(value)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(GRAPH_MODES))
def test_decode_chunk_graph_matches_eager_on_card(cuda, mode):
    """One chunk of each mode: replayed from its graph 20 times on the same
    inputs (restored before each replay), the packed result and the carry
    equal the eager program's bit for bit, and every replay adds to the
    wrappers' launch counters what the eager chunk launched."""
    from dots_ocr_tpu_torch.engine.graphs import launch_counts

    overrides, options = GRAPH_MODES[mode]
    cfg, params = _graph_params(cuda, "bf16")
    eng = _graph_engine(cfg, params, cuda, **overrides)
    dev, key = _live_chunk(eng, options)
    assert key.spec_k == (2 if "speculate_k" in overrides else 0)
    assert key.any_sampled == (options["temperature"] > 0)
    state = _chunk_state(dev)
    program = eng._chunk_program(dev, key)

    before = launch_counts()
    want = program(key.num_steps, True).clone()
    want_carry = [t.clone() for t in (dev.tokens, dev.positions, dev.budgets)]
    after = launch_counts()
    eager = {c: after[c] - before[c] for c in before if after[c] != before[c]}
    assert eager, "the eager chunk launched no kernel"

    assert key not in eng._graphs
    captures = eng._graphs.captures
    for i in range(20):
        _restore(dev, state)
        before = launch_counts()
        packed = eng._graphs.run(key, program)
        torch.cuda.synchronize()
        after = launch_counts()
        assert torch.equal(packed, want), (mode, i)
        for got, ref in zip((dev.tokens, dev.positions, dev.budgets), want_carry):
            assert torch.equal(got, ref), (mode, i)
        if i > 0:  # the first call also ran the capture's priming step
            assert {c: after[c] - before[c] for c in before if after[c] != before[c]} == eager
    assert eng._graphs.captures == captures + 1


@pytest.mark.cuda
def test_int4_activation_mode_selects_its_own_graph_on_card(cuda, monkeypatch):
    """DOTS_INT4_ACT is read at dispatch and is part of the key: a chunk
    dispatched with it set captures another graph, whose replays launch the
    W4A8 kernel; the W4A16 graph replays W4A16."""
    from dots_ocr_tpu_torch.ops.int4_matmul import int4_matmul

    cfg, params = _graph_params(cuda, "int4")
    eng = _graph_engine(cfg, params, cuda)
    monkeypatch.setenv("DOTS_INT4_ACT", "0")
    dev, key16 = _live_chunk(eng, dict(temperature=0.0))
    monkeypatch.setenv("DOTS_INT4_ACT", "1")
    key8 = eng._chunk_key(dev, 0, key16.num_steps, False)
    assert key8 != key16 and key8._replace(int4_act=False) == key16
    for key, act, counter, other in ((key8, "1", "w4a8_launches", "launches"),
                                     (key16, "0", "launches", "w4a8_launches")):
        # captured at dispatch, with the mode the key was read under
        monkeypatch.setenv("DOTS_INT4_ACT", act)
        eng._graphs.run(key, eng._chunk_program(dev, key))
        monkeypatch.setenv("DOTS_INT4_ACT", "0" if act == "1" else "1")  # a replay never reads it
        before = {c: getattr(int4_matmul, c) for c in ("launches", "w4a8_launches")}
        eng._graphs.run(key, eng._chunk_program(dev, key))
        torch.cuda.synchronize()
        assert getattr(int4_matmul, counter) > before[counter]
        assert getattr(int4_matmul, other) == before[other]
    assert key16 in eng._graphs and key8 in eng._graphs
    # int8 weights: the mode cannot change the program, so the key drops it
    cfg, params = _graph_params(cuda, "int8")
    plain = _graph_engine(cfg, params, cuda)
    assert plain._chunk_key(dev, 0, 4, False).int4_act is False


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_graphed_engine_serves_the_eager_engines_tokens_on_card(cuda, kind):
    """Two engines on one set of weights, graphs on and off, serve the same
    waves (greedy with k = 2, then seeded sampled; then a plain decode wave
    with logprobs and penalties): identical token ids, every decode and
    verify chunk of the graphed engine a replay, none captured by the
    eager one. After ``warmup_decode`` a fresh graphed engine captures
    nothing more for the no-option waves."""
    cfg, params = _graph_params(cuda, kind)
    waves = [dict(temperature=0.0), dict(temperature=1.0, seed=11),
             dict(temperature=1.0, top_p=0.8, seed=12)]

    def serve(eng, options_list, **extra):
        ids = []
        for options in options_list:
            rids = [eng.submit(p, max_new_tokens=24, **options, **extra) for p in GRAPH_PROMPTS]
            eng.run()
            ids.append([eng.finished_request(r).output_ids for r in rids])
        return ids

    engines = {}
    for graphs in (True, False):
        eng = _graph_engine(cfg, params, cuda, graphs=graphs, speculate_k=2,
                            spec_min_tokens_per_iter=0.0, pipeline_decode=True)
        engines[graphs] = (eng, serve(eng, waves), serve(eng, waves[1:2], logprobs=True,
                                                          presence_penalty=0.5))
    (g, g_spec, g_opts), (e, e_spec, e_opts) = engines[True], engines[False]
    assert g_spec == e_spec and g_opts == e_opts
    assert g.metrics["graph_replays"] == g.metrics["steps"] > 0
    assert g.metrics["graph_captures"] >= 2 and g.metrics["spec_chunks"] > 0
    assert e.metrics["graph_replays"] == e.metrics["graph_captures"] == 0

    warm = _graph_engine(cfg, params, cuda, speculate_k=2, spec_min_tokens_per_iter=0.0,
                         pipeline_decode=True)
    assert warm.warmup_decode() == len(warm.warmup_plan()) == 8
    captured = warm.metrics["graph_captures"]
    assert captured == len(warm._graphs) == 12  # 4 greedy graphs, 8 sampled
    assert warm._graphs.pool_bytes() > 0
    assert serve(warm, waves) == g_spec
    assert warm.metrics["graph_captures"] == captured
    assert warm.allocator.free_pages == GRAPH_SCHED["num_pages"] - 1


@pytest.mark.cuda
def test_snapshots_admitted_beside_graphed_chunks_on_card(cuda):
    """Greedy snapshots (image requests) submitted while graphed decode
    chunks run: each arrives once a step has returned with its chunk held on
    the device, and the next step admits it beside that chunk. The tokens
    equal an engine's that lands every chunk before it admits (the same
    arrivals at the same steps), beside admissions happen, and after
    ``warmup_decode`` no graph is captured. The engine is stepped directly,
    so that both engines see the same arrival schedule."""
    import dataclasses

    from PIL import Image

    from dots_ocr_tpu_torch.engine import scheduler

    cfg, params = _graph_params(cuda, "int8")
    vision = dataclasses.replace(cfg.vision, hidden_size=256, num_heads=2, head_dim=128,
                                 intermediate_size=512)
    cfg = cfg.replace(vision=vision)
    from dots_ocr_tpu_torch.models.init import init_params

    params["vision"] = init_params(cfg, cuda, torch.Generator(device=cuda).manual_seed(1))[
        "vision"]
    rng = np.random.RandomState(0)
    images = [Image.fromarray(rng.randint(0, 255, (28 * h, 28 * w, 3), np.uint8))
              for h, w in ((2, 3), (3, 2), (2, 2), (4, 3), (3, 3), (2, 4))]
    sched = dict(steps_per_sync=8, max_steps_per_sync=64, pipeline_decode=True,
                 speculate_k=2, spec_min_tokens_per_iter=0.0)

    def serve(eng, schedule=None):
        """Two snapshots, then one more each time a step returns with its
        chunk held (or at the recorded steps). Returns tokens and the steps."""
        ids = [eng.submit("read this", images=[im], temperature=0.0, max_new_tokens=96)
               for im in images[:2]]
        at, n = [], 0
        while eng.has_work():
            eng.step()
            n += 1
            due = (eng.held_fetch() is not None if schedule is None
                   else n in schedule)
            if due and len(ids) < len(images):
                at.append(n)
                ids.append(eng.submit("read this", images=[images[len(ids)]],
                                      temperature=0.0, max_new_tokens=96))
        return [eng.finished_request(i).output_ids for i in ids], at

    eng = _graph_engine(cfg, params, cuda, **sched)
    eng.warmup_decode()
    captured = eng.metrics["graph_captures"]
    tokens, at = serve(eng)
    assert len(at) == len(images) - 2, "no chunk was held after a step"
    assert eng.metrics["admits_beside_chunk"] > 0
    assert eng.metrics["graph_captures"] == captured
    assert eng.metrics["graph_replays"] > 0
    assert eng.allocator.free_pages == GRAPH_SCHED["num_pages"] - 1

    class Landed(scheduler.HostFetch):
        def landed(self):
            return True

    real = scheduler.HostFetch
    scheduler.HostFetch = Landed
    try:
        ref = _graph_engine(cfg, params, cuda, **sched)
        ref_tokens, ref_at = serve(ref, set(at))
    finally:
        scheduler.HostFetch = real
    assert ref_at == at and ref.metrics["admits_beside_chunk"] == 0
    assert tokens == ref_tokens


# ---------------------------------------------------------------------------
# Training on the card (no kernel: the "xla" path under autograd)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_matmul_f32_backward_on_card(cuda):
    """cuBLAS's float32-output product has no derivative of its own: its
    backward rounds the float32 cotangent to bf16 and takes bf16 products
    (float32 sums), within one bf16 ulp of the float32 reference."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(64, 256, generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
    w = torch.randn(256, 128, generator=gen, device=cuda).to(torch.bfloat16).requires_grad_()
    g = torch.randn(64, 128, generator=gen, device=cuda)
    out = matmul_f32(x, w)
    assert out.dtype == torch.float32
    (out * g).sum().backward()
    gb = g.to(torch.bfloat16).float()
    for got, want in ((x.grad, gb @ w.float().t()), (w.grad, x.float().t() @ gb)):
        assert got.dtype == torch.bfloat16
        err = (got.float() - want).abs()
        assert bool((err <= 2.0**-7 * want.abs() + 1e-3).all()), float(err.max())
    with torch.no_grad():  # the serving path: no autograd node
        assert matmul_f32(x, w).grad_fn is None


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One tiny float32 train_step (with vision) on the card and on the
    CPU from the same weights and batch: loss and grad_norm within 1e-5
    relative. A first Adam step moves an element by lr * g / (|g| + 1e-8),
    about +-lr, so an element whose gradient is near rounding noise may
    land up to 2 lr apart (the key biases, whose exact gradient is 0, all
    of them): every element within 2 lr + 1e-5 |p|, and outside the key
    biases at most 1e-3 of the elements past 1e-2 lr + 1e-5 |p| (the rule of
    chip_smoke.py phase 18 (c), which found 2.8e-6 of them at full width)."""
    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        train_step,
        tree_items,
    )

    cfg, cpu, lr = DotsOCRConfig.tiny(), torch.device("cpu"), 1e-3
    opt = make_optimizer(learning_rate=lr)
    out = {}
    for dev in (cpu, cuda):
        params = _to(init_params(cfg, cpu, torch.Generator(device=cpu).manual_seed(0)), dev)
        batch = make_dummy_batch(cfg, batch_size=2, seq_len=16, vision_tokens=4, device=dev)
        out[dev.type] = train_step(init_train_state(params, opt), batch, cfg, opt)
    (ref, m_ref), (got, m_got) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm"):
        assert abs(float(m_got[key]) - float(m_ref[key])) <= 1e-5 * abs(float(m_ref[key])), (
            key, float(m_got[key]), float(m_ref[key]))
    outliers, elements = 0, 0
    for (name, a), (_, b) in zip(tree_items(got.params), tree_items(ref.params)):
        diff, slack = (a.cpu() - b).abs(), 1e-5 * b.abs()
        assert bool((diff <= 2 * lr + slack).all()), (name, float(diff.max()))
        if not name.endswith("attn.bk"):
            outliers += int((diff > 1e-2 * lr + slack).sum())
            elements += diff.numel()
    assert outliers <= 1e-3 * elements, (outliers, elements)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
def test_bf16_train_steps_on_card(cuda):
    """The bf16 path (cuBLAS float32-output products under autograd, remat)
    trains: finite metrics, and the loss on a fixed batch falls."""
    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        train_step,
    )

    cfg = DotsOCRConfig.tiny().replace(dtype="bfloat16")
    opt = make_optimizer(learning_rate=1e-2)
    state = init_train_state(init_params(cfg, cuda, torch.Generator(device=cuda).manual_seed(0)),
                             opt)
    batch = make_dummy_batch(cfg, batch_size=2, seq_len=32, vision_tokens=4, device=cuda)
    losses = []
    for _ in range(5):
        state, m = train_step(state, batch, cfg, opt, remat=True)
        assert torch.isfinite(m["grad_norm"])
        losses.append(float(m["loss"]))
    assert state.params["decoder"]["embed"].dtype == torch.bfloat16
    assert state.opt_state.mu["decoder"]["embed"].dtype == torch.bfloat16
    assert losses[-1] < losses[0] - 0.5, losses


# -- tensor-parallel serving: the kernels at a rank's shard shapes ---------


@pytest.mark.cuda
@pytest.mark.parametrize("label,rows", [(label, rows) for label in sorted(TP_W8A16_SHAPES)
                                        for rows in (1, 64, 192, 2048)])
def test_w8a16_tp_shard_shapes_match_plain_on_card(cuda, label, rows):
    """The W8A16 kernel at a TP rank's linear shapes (N 768, 128, 4,480 and
    the padded 2,304; K 768, 4,480 and 2,304, float32 out as the
    row-parallel linears call it) and the rows of a decode step, a k = 2
    verify and a prefill chunk; 20 calls bit for bit."""
    x, q, scale, bias, transposed = w8a16_inputs(label, rows, rows + 19)
    f32 = label in TP_ROW_PARALLEL
    before = w8a16_matmul.launches
    out = w8a16_matmul(x, q, scale, bias, out_f32=f32)
    assert w8a16_matmul.launches == before + 1
    w8a16_close(out, int8_linear_reference(x, q, scale, bias, out_f32=f32), f32)
    assert all(torch.equal(w8a16_matmul(x, q, scale, bias, out_f32=f32), out)
               for _ in range(20))


@pytest.mark.cuda
@pytest.mark.parametrize("h,kv,causal", [(6, 6, False), (3, 3, False), (6, 1, True),
                                         (3, 1, True)])
def test_flash_kernel_tp_shard_heads_match_plain_on_card(cuda, h, kv, causal):
    """Kernel 1 at a rank's heads: the vision tower's 6 (TP = 2) and 3
    (TP = 4) over packed images, and the decoder's 6q/1kv and 3q/1kv over a
    causal chunk at an offset."""
    gen = torch.Generator(device=cuda).manual_seed(h * 10 + kv)
    b, tq, s = (1, 1000, 1000) if not causal else (2, 512, 1024)
    q = torch.randn(b, tq, h, 128, generator=gen, device=cuda).to(torch.bfloat16)
    k = torch.randn(b, s, kv, 128, generator=gen, device=cuda).to(torch.bfloat16)
    v = torch.randn(b, s, kv, 128, generator=gen, device=cuda).to(torch.bfloat16)
    if causal:
        q_seg = torch.zeros(b, tq, dtype=torch.int32, device=cuda)
        kv_seg = torch.zeros(b, s, dtype=torch.int32, device=cuda)
        kwargs = dict(causal=True, q_offset=s - tq)
    else:
        q_seg = kv_seg = torch.from_numpy(packed_segments(b, s, [[700, 250]])).to(cuda)
        kwargs = {}
    out = flash_attention(q, k, v, q_seg, kv_seg, **kwargs)
    ref = flash_attention_reference(q, k, v, q_seg, kv_seg, **kwargs)
    torch.cuda.synchronize()
    _bf16_close(out, ref)
    _attention_close(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("h", [6, 3])
@pytest.mark.parametrize("nq", [1, 3])
def test_paged_kernel_one_kv_head_matches_plain_on_card(cuda, nq, h, int8):
    """Kernel 2 over a rank's pool of one KV head (6 query heads at TP = 2,
    3 at TP = 4), bf16 and int8, at nq = 1 and a k = 2 verify."""
    rng = np.random.RandomState(nq * 10 + h)
    q, kp, vp, lens, table = paged_inputs(rng, INT8_LENGTHS, nq, 1, h, 128, 128, 17)
    qd = torch.from_numpy(q).to(cuda, torch.bfloat16)
    lens_t, table_t = torch.from_numpy(lens).to(cuda), torch.from_numpy(table).to(cuda)
    if int8:
        kq, vq, ks, vs = (x.to(cuda) for x in int8_pools(kp, vp))
        chunk, _ = paged_int8_split_plan(
            len(INT8_LENGTHS), 1, h * nq, 128, table.shape[1] * 128,
            torch.cuda.get_device_properties(cuda).multi_processor_count)
        out = paged_attention_multiquery_int8(qd, kq, vq, ks, vs, lens_t, table_t)
        ref = paged_attention_int8_reference(qd, kq, vq, ks, vs, lens_t, table_t, chunk=chunk,
                                             warps=int8_tile_walkers(h * nq))
    else:
        kb, vb = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in (kp, vp))
        out = paged_attention_multiquery_bf16(qd, kb, vb, lens_t, table_t)
        ref = paged_attention_multiquery_reference(qd, kb, vb, lens_t, table_t)
    torch.cuda.synchronize()
    _bf16_close(out, ref)
    _attention_close(out, ref)
    assert (out[1] == 0).all()  # length 0: exact zeros


@pytest.mark.cuda
def test_tp2_nccl_graphs_match_eager_on_two_cards(cuda, tmp_path):
    """TP = 2 over NCCL, one GPU a rank: the decode chunks are CUDA graphs
    with their all-reduces captured (every chunk a replay), and the graphed
    engine's greedy tokens equal the eager engine's on the same shard."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs: NCCL refuses two ranks on one device")
    import multiprocessing
    import pickle

    import tp_ranks

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_ranks.run_nccl_rank, args=(rank, 2, str(tmp_path)))
             for rank in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    results = []
    for rank in range(2):
        with open(tmp_path / f"nccl{rank}.pkl", "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res["error"]
        results.append(res)
    for res in results:
        assert res["graphed"] == res["eager"] == results[0]["graphed"]
        assert res["metrics"]["graph_replays"] >= res["metrics"]["steps"] >= 1
        assert res["reduces"] > 0


# -- tensor parallelism: kernel 3's route, and training ---------------------


def _spawn_ranks(target, world, tmp_path, prefix, *args):
    import multiprocessing
    import pickle

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(rank, world, str(tmp_path), *args))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=600)
    results = []
    for rank in range(world):
        path = tmp_path / f"{prefix}{rank}.pkl"
        assert path.exists(), f"rank {rank} wrote nothing (exit {procs[rank].exitcode})"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, res["error"]
        results.append(res)
    return results


@pytest.mark.cuda
def test_tp2_decodes_through_kernel3_at_int8_page64_on_card(cuda, tmp_path):
    """TP = 2 over gloo on one card where decode takes kernel 3's route
    (int8 KV at page 64): each rank's pool holds one KV head, its decode
    step launches kernel 3 on it and its verify step runs the plain
    reference; the logits of a 40-token prompt's verify and decode steps
    are within chip_smoke.py's phase 19 tolerance (0.5 std) of TP = 1, and
    a served greedy request launches kernel 3 on both ranks."""
    import tp_ranks
    from dots_ocr_tpu_torch.models.init import init_params

    full = init_params(tp_ranks.card_route_config(), cuda,
                       torch.Generator(device=cuda).manual_seed(0), scale=0.3)
    ref = tp_ranks.card_route_logits(full, None, cuda)
    assert ref["kernel3"] == 2 and ref["kv_width"] == 2
    ranks = _spawn_ranks(tp_ranks.run_card_route_rank, 2, tmp_path, "route")
    std = float(ref["logits"].std())
    for res in ranks:
        assert res["kv_width"] == 1 and res["kernel3"] == 2
        assert float(np.abs(res["logits"] - ref["logits"]).max()) <= 0.5 * std
        assert res["served_kernel3"] > 0
    assert ranks[0]["tokens"] == ranks[1]["tokens"]


def _train_ranks_hold(ranks, cuda):
    """The card's one-process step on the same weights and batch, and
    ``test_train_step_on_card_matches_cpu``'s rule against rank 0's
    gathered step."""
    import train_ranks
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        train_step,
        tree_items,
    )

    cfg, lr = train_ranks.CFG, 1e-3
    opt = make_optimizer(learning_rate=lr)
    params = _to(init_params(cfg, torch.device("cpu"), torch.Generator().manual_seed(0)), cuda)
    batch = make_dummy_batch(cfg, batch_size=2, seq_len=train_ranks.SEQ,
                             vision_tokens=train_ranks.VISION_TOKENS, seed=0, device=cuda)
    ref, m_ref = train_step(init_train_state(params, opt), batch, cfg, opt)
    for res in ranks:
        assert res["metrics"] == ranks[0]["metrics"]
    got = ranks[0]
    for key in ("loss", "grad_norm"):
        assert abs(got["metrics"][key] - float(m_ref[key])) <= 1e-5 * abs(float(m_ref[key])), key
    outliers, elements = 0, 0
    for name, b in tree_items(ref.params):
        a = torch.from_numpy(got["state"]["params"][name])
        diff, slack = (a - b.cpu()).abs(), 1e-5 * b.cpu().abs()
        assert bool((diff <= 2 * lr + slack).all()), (name, float(diff.max()))
        if not name.endswith("attn.bk"):
            outliers += int((diff > 1e-2 * lr + slack).sum())
            elements += diff.numel()
    assert outliers <= 1e-3 * elements, (outliers, elements)


@pytest.mark.cuda
def test_tp2_train_step_over_gloo_matches_one_process_on_card(cuda, tmp_path):
    """TP = 2 training over gloo, both ranks on this card, the tiny config
    in float32 (2 + 2 layers, vision in): the gathered step equals the
    card's one-process step within test_train_step_on_card_matches_cpu's
    tolerances."""
    import train_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = _spawn_ranks(train_ranks.run_card_train_rank, 2, tmp_path, "card", "gloo")
    _train_ranks_hold(ranks, cuda)


@pytest.mark.cuda
def test_tp2_train_step_over_nccl_matches_one_process_on_two_cards(cuda, tmp_path):
    """The same step over NCCL, a GPU a rank."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 GPUs: NCCL refuses two ranks on one device")
    import train_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    ranks = _spawn_ranks(train_ranks.run_card_train_rank, 2, tmp_path, "card", "nccl")
    _train_ranks_hold(ranks, cuda)


def _latent_inputs(lengths, heads, rank, rope, page_size, width, seed=0):
    """A latent pool of random rows (unreferenced ones too) with shuffled
    pages, bf16 queries, and each slot's table and length."""
    g = torch.Generator().manual_seed(seed)
    n_pages = len(lengths) * width + 1
    pool = torch.randn(1, n_pages * page_size, rank + rope, generator=g).bfloat16()
    tables = (torch.randperm(n_pages - 1, generator=g)[:len(lengths) * width] + 1).view(
        len(lengths), width).int()
    q = torch.randn(len(lengths), heads, rank + rope, generator=g).bfloat16()
    return q, pool, tables, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths,page_size,width", [
    ([1, 0, 300, 4096], 128, 32),            # an empty slot, page edges, one split and many
    ([8191, 2, 129, 3400] * 16, 128, 64),    # the cell's 64 slots at its 64-page tables
    ([17, 5, 64], 16, 8),                    # small pages
])
def test_latent_kernel_matches_plain_on_card(cuda, lengths, page_size, width):
    """The paged latent kernel and its merge (128 heads, 512 + 64 values a
    row) against the plain version on the same bf16 inputs, within
    _attention_close's bound; an empty slot gives exact zeros; 20 calls
    give the same bits; a CUDA graph replays it over new lengths."""
    from dots_ocr_tpu_torch.ops.mla_attention import mla_decode_reference, mla_paged_decode

    q, pool, tables, lens = (t.to(cuda) for t in _latent_inputs(lengths, 128, 512, 64,
                                                                page_size, width))
    scale = 192 ** -0.5 * 1.3689 ** 2
    out = mla_paged_decode(q, pool, tables, lens, page_size, 512, scale)
    ref = mla_decode_reference(q, pool, tables, lens, page_size, 512, scale)
    live = lens > 0
    _attention_close(out[live], ref[live])
    assert not out[~live].any()
    for _ in range(20):
        assert torch.equal(mla_paged_decode(q, pool, tables, lens, page_size, 512, scale), out)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = mla_paged_decode(q, pool, tables, lens, page_size, 512, scale)
    lens.copy_(torch.flip(lens, [0]))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, mla_paged_decode(q, pool, tables, lens, page_size, 512, scale))


@pytest.mark.cuda
def test_held_experts_grouped_product_matches_plain_on_card(cuda):
    """The MoE block's grouped expert products (torch._grouped_mm over the
    held experts, sorted on the device) against one product an expert in
    float32, on bf16 inputs at the published widths, and under a graph."""
    from dots_ocr_tpu_torch.models.moe import held_experts

    g = torch.Generator().manual_seed(1)
    t, k, n_held, d, inter = 64, 8, 8, 7168, 2048
    x = (torch.randn(t, d, generator=g)).bfloat16().to(cuda)
    local = torch.randint(-4, 12, (t, k), generator=g).to(cuda)
    held = (local >= 0) & (local < n_held)
    weight = torch.rand(t, k, generator=g).to(cuda)
    gate, up = ((torch.randn(n_held, d, inter, generator=g) * 0.02).bfloat16().to(cuda)
                for _ in range(2))
    down = (torch.randn(n_held, inter, d, generator=g) * 0.02).bfloat16().to(cuda)
    got, per_expert = held_experts(x, local, weight, held, gate, up, down)
    want = torch.zeros(t, d, device=cuda)
    for e in range(n_held):
        tok, slot = torch.nonzero(held & (local == e), as_tuple=True)
        xe = x[tok].float()
        h = torch.nn.functional.silu(xe @ gate[e].float()) * (xe @ up[e].float())
        want.index_add_(0, tok, (h @ down[e].float()) * weight[tok, slot, None])
        assert int(per_expert[e]) == tok.numel()
    err = (got - want).abs()
    assert float(err.norm()) <= 1e-2 * float(want.norm()), float(err.norm() / want.norm())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured, _ = held_experts(x, local, weight, held, gate, up, down)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, got)


@pytest.mark.cuda
def test_deepseek_engine_graphed_equals_eager_on_card(cuda):
    """DeepSeek-V3's decoder (MLA over the latent pages, MoE holding 4 of 16
    experts) through the continuous engine at a small size in bf16: the
    engine whose decode chunks are CUDA graph replays serves the same tokens
    as the eager one, through the latent kernel and the grouped products."""
    from PIL import Image

    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
    from dots_ocr_tpu_torch.models.config import (
        DecoderConfig,
        DeepseekConfig,
        DeepseekDecoderConfig,
        DotsOCRConfig,
        VisionConfig,
        YarnRope,
    )
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.ops.mla_attention import mla_paged_decode

    base = DotsOCRConfig.tiny()
    fields = {f: getattr(base.decoder, f) for f in DecoderConfig.__dataclass_fields__}
    decoder = DeepseekDecoderConfig(**dict(
        fields, hidden_size=128, num_heads=32, num_kv_heads=32, intermediate_size=256,
        qkv_bias=False, tie_word_embeddings=False, rope_theta=10000.0,
        deepseek=DeepseekConfig(
            q_lora_rank=64, kv_lora_rank=64, qk_nope_head_dim=32, qk_rope_head_dim=16,
            v_head_dim=32, first_k_dense_replace=1, moe_intermediate_size=64,
            n_routed_experts=16, experts_held=(4, 4), num_experts_per_tok=4, n_group=4,
            topk_group=2, rope_scaling=YarnRope(original_max_position_embeddings=64))))
    vision = VisionConfig(hidden_size=128, num_layers=2, num_heads=2, head_dim=64,
                          intermediate_size=256)  # kernel 1 takes head dim 64 or 128
    cfg = base.replace(vision=vision, decoder=decoder, dtype="bfloat16")
    params = init_params(cfg, cuda, torch.Generator(device=cuda).manual_seed(0), scale=0.1)
    page = Image.fromarray(np.random.RandomState(0).randint(0, 256, (56, 84, 3), np.uint8))
    outs, metrics = [], []
    for graphs in (False, True):
        engine = ContinuousBatchingEngine(params, cfg, cuda, sched=SchedulerConfig(
            num_pages=256, page_size=16, max_slots=4, max_pages_per_seq=32, steps_per_sync=4,
            prefill_chunk_tokens=64, cuda_graphs=graphs))
        if graphs:
            engine.warmup_decode()
        launches = mla_paged_decode.launches
        outs.append(engine.generate_batch(["hi", "a much longer prompt " * 8], [[page], []],
                                          temperature=0.0, max_new_tokens=24))
        metrics.append(dict(engine.metrics, latent_launches=mla_paged_decode.launches - launches))
    assert outs[0] == outs[1]
    assert metrics[1]["graph_replays"] > 0 and metrics[1]["latent_launches"] > 0
    assert metrics[0]["moe_routed_here"] == metrics[1]["moe_routed_here"] > 0
