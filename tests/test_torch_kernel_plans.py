"""The Python around the redesigned kernels 1, 2 (both modes), 3 and 5, on the CPU.

Kernel 1's tile list (``flash_tile_plan``) against the dense mask of the
function it computes; kernel 2's split of the token axis
(``paged_split_plan``) and its log-sum-exp merge of per-split partials
(``paged_split_partials`` + ``merge_split_partials``) against the plain
version and the JAX package's reference; the int8 mode's plain version
with the kernel's split and warps (``paged_int8_split_partials``) against
its unsplit self; kernel 3's split plan (``paged_v1_split_plan``); kernel 5's
W4A16 regime rule and split plan (``int4_regime``, ``int4_split_plan``)
and its W4A8 plan (``int4_w4a8_plan``: the ordered cluster split's ranges,
cluster sizes, grid and shared memory).
Float32, numpy-seeded inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.ops.paged_attention import (
    paged_attention_multiquery_reference as jax_paged_reference,
)
from dots_ocr_tpu_torch.ops.flash_attention import (
    BLOCK_K,
    BLOCK_Q,
    TILE_MASKED,
    TILE_SKIP,
    TILE_UNMASKED,
    flash_tile_plan,
)
from dots_ocr_tpu_torch.ops.paged_attention import (
    INT8_TILE,
    SPLIT_ALIGN,
    SPLIT_SCRATCH_BYTES,
    int8_tile_walkers,
    merge_split_partials,
    paged_attention_int8_reference,
    paged_attention_multiquery_reference,
    paged_int8_split_partials,
    paged_int8_split_plan,
    paged_split_partials,
    paged_split_plan,
)
from dots_ocr_tpu_torch.ops.int4_matmul import (
    GROUP,
    SPLIT_ROWS,
    SPLIT_TILE_COLS,
    SPLIT_TILE_ROWS,
    SPLIT_UNIT,
    W4A8_MAX_CLUSTER,
    W4A8_SMEM_LIMIT,
    W4A8_TILE_ROWS,
    int4_regime,
    int4_split_plan,
    int4_w4a8_plan,
    W4A8_PREFILL_ROWS,
    w4a8_candidates,
    w4a8_ranges,
    w4a8_smem,
)
from dots_ocr_tpu_torch.ops.paged_attention import V1_STEP, paged_v1_split_plan
from test_torch_cuda import int8_pools, paged_inputs


def _runs(rng, length, kind):
    """Segment ids of ``length`` tokens: "packed" (sorted ids, -1 tail),
    "windowed" (256-token windows), "shuffled" (runs of ids in random order,
    ids repeating, -1 runs between them)."""
    if kind == "windowed":
        ids = np.arange(length) // 256
        ids[length - rng.randint(1, 200):] = -1
        return ids.astype(np.int32)
    ids, pos, nxt = np.full(length, -1, np.int32), 0, 0
    while pos < length:
        n = rng.randint(1, 300)
        if kind == "shuffled":
            ids[pos:pos + n] = rng.randint(-1, 5)
        elif pos < length * 0.9:
            ids[pos:pos + n] = nxt
            nxt += 1
        pos += n
    return ids


def _dense_mask(q_seg, kv_seg, causal, q_offset):
    mask = (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] >= 0)
    if causal:
        rows = np.arange(q_seg.shape[1])[:, None] + q_offset
        mask &= np.arange(kv_seg.shape[1])[None, :] <= rows
    return mask


@pytest.mark.parametrize("kind,causal,q_offset", [
    ("packed", False, 0), ("windowed", False, 0), ("shuffled", False, 0),
    ("packed", True, 0), ("shuffled", True, 77), ("packed", True, 2048)])
def test_flash_tile_plan_matches_the_dense_mask(kind, causal, q_offset):
    """A skipped tile holds no valid (query, key) pair; an unmasked tile
    holds only valid pairs (and no position past Tq or S); every class the
    rule can give occurs somewhere over the seeds."""
    seen = set()
    for seed in range(8):
        rng = np.random.RandomState(seed)
        tq = rng.randint(1, 1200)
        if causal:  # a prompt's keys; its queries are the tail past q_offset
            kv_seg = _runs(rng, tq + q_offset, kind)[None]
            q_seg = kv_seg[:, q_offset:].copy()
        else:  # self-attention (packed vision) on even seeds
            q_seg = _runs(rng, tq, kind)[None]
            kv_seg = q_seg if seed % 2 == 0 else _runs(rng, rng.randint(1, 1500), kind)[None]
        plan = flash_tile_plan(torch.from_numpy(q_seg), torch.from_numpy(kv_seg), causal,
                               q_offset).numpy()
        n_qb, n_kt = -(-q_seg.shape[1] // BLOCK_Q), -(-kv_seg.shape[1] // BLOCK_K)
        assert plan.shape == (1, n_qb, n_kt)
        mask = np.zeros((n_qb * BLOCK_Q, n_kt * BLOCK_K), bool)
        mask[:q_seg.shape[1], :kv_seg.shape[1]] = _dense_mask(q_seg, kv_seg, causal,
                                                              q_offset)[0]
        tiles = mask.reshape(n_qb, BLOCK_Q, n_kt, BLOCK_K).transpose(0, 2, 1, 3)
        any_pair, all_pairs = tiles.any(axis=(2, 3)), tiles.all(axis=(2, 3))
        assert not any_pair[plan[0] == TILE_SKIP].any()
        assert all_pairs[plan[0] == TILE_UNMASKED].all()
        assert (plan[0][any_pair] != TILE_SKIP).all()  # nothing valid is skipped
        seen |= set(np.unique(plan).tolist())
    assert TILE_MASKED in seen and TILE_SKIP in seen
    if kind in ("packed", "windowed"):
        assert TILE_UNMASKED in seen


@pytest.mark.parametrize("batch,kv_heads,rows,head_dim,max_tokens,num_sms", [
    (64, 2, 18, 128, 320 * 128, 132),  # shipping.env, verify steps (nq = 3)
    (64, 2, 6, 128, 320 * 128, 132),   # shipping.env, decode steps
    (8, 2, 6, 64, 4096, 132),
    (1, 1, 24, 128, 16, 132),
    (3, 4, 8, 128, 1000 * 16, 78),
    (256, 8, 24, 128, 2 ** 20, 132),
])
def test_paged_split_plan_covers_every_position_once(batch, kv_heads, rows, head_dim,
                                                     max_tokens, num_sms):
    chunk, n_split = paged_split_plan(batch, kv_heads, rows, head_dim, max_tokens, num_sms)
    assert chunk % SPLIT_ALIGN == 0 and n_split >= 1
    covered = np.zeros(max_tokens, np.int64)
    for split in range(n_split):
        covered[split * chunk:(split + 1) * chunk] += 1
    assert (covered == 1).all()  # every position in exactly one split, none left over
    assert (n_split - 1) * chunk < max_tokens  # no split starts past the table
    scratch = batch * kv_heads * n_split * rows * (head_dim + 2) * 4
    if n_split > 1:
        assert scratch <= SPLIT_SCRATCH_BYTES


def test_paged_split_plan_at_the_shipping_geometry():
    """64 slots, 2 KV heads, 12 heads, table width 320 x page 128: the
    verify step's scratch fits the 32 MiB budget in 28 splits of 1,472
    tokens; a decode step takes the same 28 (the grid's cap of 28 blocks
    per SM on 132 SMs)."""
    assert paged_split_plan(64, 2, 18, 128, 40960, 132) == (1472, 28)
    assert 64 * 2 * 28 * 18 * 130 * 4 <= SPLIT_SCRATCH_BYTES
    assert paged_split_plan(64, 2, 6, 128, 40960, 132) == (1472, 28)


@pytest.mark.parametrize("nq,page_size,chunk", [(1, 16, 64), (3, 16, 128), (3, 32, 192),
                                                (1, 64, 1024)])
def test_split_partials_merge_to_the_reference(nq, page_size, chunk):
    """Per-split partials merged by log-sum-exp equal the plain version and
    the JAX package's reference within 1e-6 in float32, with splits that
    hold no visible token (rows shorter than a split, the table's tail) and
    a length-0 row (exact zeros)."""
    rng = np.random.RandomState(nq * page_size + chunk)
    lengths = [0, 1, chunk - nq + 1, chunk, 2 * chunk + 5, 3 * page_size - nq]
    max_pages = -(-(3 * chunk + 8) // page_size)
    q, kp, vp, lens, table = paged_inputs(rng, lengths, nq, 2, 6, 32, page_size, max_pages)
    args = [torch.from_numpy(x) for x in (q, kp, vp, lens, table)]
    m, l, o = paged_split_partials(*args, chunk=chunk)
    assert m.shape[1] == -(-max_pages * page_size // chunk)
    assert torch.isinf(m).any()  # some splits saw nothing
    merged = merge_split_partials(m, l, o)
    plain = paged_attention_multiquery_reference(*args)
    assert float((merged - plain).abs().max()) <= 1e-6
    jax_out = np.asarray(jax_paged_reference(*(jnp.asarray(x) for x in (q, kp, vp, lens, table))))
    assert float(np.abs(merged.numpy() - jax_out).max()) <= 1e-6
    assert (merged[0] == 0).all()


INT8_CAP = 7 * INT8_TILE  # the table's capacity in the int8 split tests (28 pages of 16)


@pytest.mark.parametrize("nq", [1, 3])
@pytest.mark.parametrize("chunk,warps", [
    (INT8_CAP, 1), (INT8_CAP, 4), (256, 1), (256, 2), (192, None), (128, None), (INT8_TILE, 1),
    (INT8_TILE, None)])
def test_int8_split_plain_matches_unsplit(nq, chunk, warps):
    """The int8 plain version with the kernel's split: 1 split walked by 1
    walker is the unsplit function bit for bit; 2 to 7 splits, and 2 or 4
    walkers taking the tiles in turn (None: the kernel's count for these
    rows, 4 at nq = 1 and 2 at nq = 3), agree with it within 1e-6 in float32 (the
    tiles P is re-quantized over are the same; only the running max the
    exponentials are taken against, and so the order of the float32
    rescales, differs). Its partials merged by the plain merge are its own
    output bit for bit. Rows of length 0, a tile less one, a tile, a tile
    and one, a page boundary, and one that ends at the table's cap."""
    rng = np.random.RandomState(nq)
    lengths = [0, INT8_TILE - 1, INT8_TILE, INT8_TILE + 1, 5 * 16, INT8_CAP - nq + 1, 300, 129]
    q, kp, vp, lens, table = paged_inputs(rng, lengths, nq, 2, 6, 64, 16, INT8_CAP // 16)
    kq, vq, ks, vs = int8_pools(kp, vp)
    args = (torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(lens), torch.from_numpy(table))
    unsplit = paged_attention_int8_reference(*args)
    if warps is None:
        warps = int8_tile_walkers(6 * nq)
        assert warps == (4 if nq == 1 else 2)
    split = paged_attention_int8_reference(*args, chunk=chunk, warps=warps)
    if chunk == INT8_CAP and warps == 1:
        assert torch.equal(split, unsplit)
    else:
        assert float((split - unsplit).abs().max()) <= 1e-6
    m, l, o = paged_int8_split_partials(*args, chunk=chunk, warps=warps)
    n_split = -(-INT8_CAP // chunk)
    assert m.shape == (len(lengths), n_split, nq, 6) and o.shape == (*m.shape, 64)
    assert torch.equal(merge_split_partials(m, l, o, base2=False), split)
    assert (split[0] == 0).all() and torch.isfinite(split).all()
    assert torch.isinf(m[0]).all()  # the empty row: every split is dead
    if n_split > 1:  # a split that starts at or past a row's n_tok is dead for it
        dead = -(-(INT8_TILE - 1 + nq - 1) // chunk)
        assert torch.isinf(m[1, dead:]).all() and (l[1, dead:] == 0).all()
        assert (o[1, dead:] == 0).all() and torch.isfinite(m[1, :dead]).all()
        assert torch.isfinite(m[5]).all()  # the row at the cap reaches every split


def test_int8_split_rejects_a_chunk_that_cuts_a_tile():
    rng = np.random.RandomState(0)
    q, kp, vp, lens, table = paged_inputs(rng, [70], 1, 1, 2, 64, 16, 8)
    kq, vq, ks, vs = int8_pools(kp, vp)
    with pytest.raises(ValueError, match="multiple of the tile"):
        paged_int8_split_partials(torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(lens),
                                  torch.from_numpy(table), chunk=96)


def test_int8_split_plan_at_the_shipping_geometry():
    """The int8 mode takes the bf16 mode's plan with its own cap on the
    grid (28 blocks per SM for a decode step's 4 one-warp groups, 16 for a
    verify step's 2 groups of three warps); splits start on tile
    boundaries."""
    assert paged_int8_split_plan(64, 2, 6, 128, 40960, 132) == (1472, 28)
    assert paged_int8_split_plan(64, 2, 18, 128, 40960, 132) == (2432, 17)
    for rows in (6, 18):
        chunk, n_split = paged_int8_split_plan(64, 2, rows, 128, 40960, 132)
        assert chunk % INT8_TILE == 0 and n_split * chunk >= 40960
        assert 64 * 2 * n_split * rows * 130 * 4 <= SPLIT_SCRATCH_BYTES


@pytest.mark.parametrize("batch,kv_heads,group,head_dim,width,page_size,num_sms", [
    (64, 2, 6, 128, 640, 64, 132),   # phase 10's served table: 640 pages of 64
    (64, 2, 6, 128, 32, 64, 132),    # 64 slots x 2,048 tokens, page 64
    (64, 2, 6, 128, 16, 128, 132),   # the same rows at page 128
    (3, 1, 8, 64, 40, 16, 78),
    (5, 2, 4, 128, 7, 48, 132),      # a page that is not a power of two
    (1, 1, 1, 64, 3, 1024, 132),
    (256, 8, 8, 128, 100, 256, 132),
])
def test_paged_v1_split_plan_covers_every_page_once(batch, kv_heads, group, head_dim, width,
                                                    page_size, num_sms):
    """Kernel 3's splits are whole pages and whole 64-token steps, every
    page of every row lies in exactly one split, no split starts past the
    table, and more than one split fits the scratch budget."""
    max_tokens = width * page_size
    chunk, n_split = paged_v1_split_plan(batch, kv_heads, group, head_dim, max_tokens,
                                         page_size, num_sms)
    assert chunk % V1_STEP == 0 and chunk % page_size == 0 and n_split >= 1
    covered = np.zeros(width, np.int64)
    for split in range(n_split):
        covered[split * chunk // page_size:(split + 1) * chunk // page_size] += 1
    assert (covered == 1).all()
    assert (n_split - 1) * chunk < max_tokens
    if n_split > 1:
        assert batch * kv_heads * n_split * group * (head_dim + 2) * 4 <= SPLIT_SCRATCH_BYTES


def test_paged_v1_split_plan_at_the_served_shapes():
    """Phase 10's served table (64 slots, 640 pages of 64): 64 splits of
    640 tokens, so its ~2.2k-token row runs in 4 splits (a plan sized by
    kernel 2's cap of 28 blocks an SM would give it 2 of 1,472); 64 x 2,048:
    4 splits of 512 at page 64 and 128."""
    assert paged_v1_split_plan(64, 2, 6, 128, 40960, 64, 132) == (640, 64)
    assert -(-2200 // 640) == 4
    assert paged_v1_split_plan(64, 2, 6, 128, 2048, 64, 132) == (512, 4)
    assert paged_v1_split_plan(64, 2, 6, 128, 2048, 128, 132) == (512, 4)


def test_int4_regime_rule():
    """W4A16 splits the contraction up to SPLIT_ROWS rows (a 64-slot k = 2
    verify step) and runs the wgmma kernel above (prefill chunks)."""
    assert SPLIT_ROWS == 192
    assert [int4_regime(m) for m in (1, 64, 192, 193, 2048, 4096)] == [
        "split", "split", "split", "wgmma", "wgmma", "wgmma"]


@pytest.mark.parametrize("rows", [1, 64, 192])
@pytest.mark.parametrize("in_dim,out_dim", [(1536, 1536), (1536, 256), (1536, 8960),
                                            (8960, 1536)])
def test_int4_split_plan_covers_every_unit_once(in_dim, out_dim, rows):
    """Every unit of SPLIT_UNIT packed rows in exactly one split, no split
    empty, and at least two blocks an SM where the units allow it."""
    per_split, n_split = int4_split_plan(rows, in_dim, out_dim, 132)
    units = in_dim // 2 // SPLIT_UNIT
    covered = np.zeros(units, np.int64)
    for split in range(n_split):
        covered[split * per_split:(split + 1) * per_split] += 1
    assert (covered == 1).all() and (n_split - 1) * per_split < units
    tiles = -(-rows // SPLIT_TILE_ROWS) * (out_dim // SPLIT_TILE_COLS)
    assert tiles * n_split >= min(2 * 132, tiles * units) * 0.75


DECODER_SHAPES = [(1536, 1536), (1536, 256), (1536, 8960), (8960, 1536)]


def w4a8_grid(rows, out_dim, plan):
    """The grid dots_int4_matmul_w4a8 launches for ``plan``: (cluster ranks,
    column tiles, row tiles) with clusters of (cluster, 1, 1) in the split
    regime; (column tiles, row tiles, 1) for wgmma."""
    if plan.regime == "wgmma":
        return (out_dim // plan.cols, -(-rows // W4A8_PREFILL_ROWS), 1)
    return (plan.cluster, out_dim // plan.cols, -(-rows // W4A8_TILE_ROWS))


def test_w4a8_regime_boundary():
    """W4A8 runs the ordered cluster split up to 192 rows (a 64-slot k = 2
    verify step) and the s8 wgmma kernel above, as W4A16 switches."""
    for in_dim, out_dim in DECODER_SHAPES:
        regimes = [int4_w4a8_plan(m, in_dim, out_dim, 132).regime
                   for m in (1, 64, 191, 192, 193, 2048, 4096)]
        assert regimes == ["split"] * 4 + ["wgmma"] * 3
        assert regimes == [int4_regime(m) for m in (1, 64, 191, 192, 193, 2048, 4096)]


@pytest.mark.parametrize("rows", [1, 64, 65, 192])
@pytest.mark.parametrize("in_dim,out_dim", DECODER_SHAPES + [(8960, 8960), (2560, 384)])
def test_w4a8_plan_ranges_cluster_and_smem(in_dim, out_dim, rows):
    """The plan's cluster: at most 8 ranks, dividing the grid's cluster
    dimension; every group (low group kb and high group blocks + kb of
    packed-row block kb) in exactly one rank, the ranges contiguous and in
    rank order, none empty; the column width divides N; shared memory (ring
    + B tiles + terms) under 227 KB, for the plan and every candidate."""
    plan = int4_w4a8_plan(rows, in_dim, out_dim, 132)
    assert plan.regime == "split"
    assert 1 <= plan.cluster <= W4A8_MAX_CLUSTER and out_dim % plan.cols == 0
    grid = w4a8_grid(rows, out_dim, plan)
    assert grid == (plan.cluster, out_dim // plan.cols, -(-rows // W4A8_TILE_ROWS))
    assert grid[0] % plan.cluster == 0
    blocks = in_dim // 2 // GROUP
    ranges = w4a8_ranges(in_dim, plan.cluster)
    assert ranges[0][0] == 0 and ranges[-1][1] == blocks
    assert all(a < b for a, b in ranges)
    assert all(ranges[r][1] == ranges[r + 1][0] for r in range(len(ranges) - 1))
    owner = np.zeros(2 * blocks, np.int64)
    for start, end in ranges:
        owner[start:end] += 1
        owner[blocks + start:blocks + end] += 1
    assert (owner == 1).all()
    assert w4a8_smem(plan.cols, plan.cluster, in_dim) <= W4A8_SMEM_LIMIT
    for cols, cluster in w4a8_candidates(rows, in_dim, out_dim):
        assert w4a8_smem(cols, cluster, in_dim) <= W4A8_SMEM_LIMIT
        assert out_dim % cols == 0 and cluster <= min(W4A8_MAX_CLUSTER, blocks)


def test_w4a8_plan_at_the_decoder_shapes():
    """At M = 64 on 132 SMs the decode regime fills the card where the old
    one-block-a-tile kernel did not: down reaches >= 96 CTAs (24 before),
    wk/wv >= 32 (4 before); the wgmma regime's grid is 128 x 128 tiles
    where those fill the card, 128 x 64 where they would not."""
    def ctas(in_dim, out_dim):
        return int(np.prod(w4a8_grid(64, out_dim, int4_w4a8_plan(64, in_dim, out_dim, 132))))
    assert ctas(8960, 1536) >= 96 and ctas(1536, 256) >= 32
    plan = int4_w4a8_plan(4096, 1536, 8960, 132)
    assert plan.cluster == 0 and w4a8_grid(4096, 8960, plan) == (70, 32, 1)
    # wk/wv (N = 256) takes 64-column wgmma tiles: 128-column ones would
    # leave most SMs idle at 2,048 rows
    assert int4_w4a8_plan(2048, 1536, 256, 132).cols == 64
    # a contraction whose terms fit no cluster's shared memory takes wgmma
    assert not w4a8_candidates(64, 32768, 1536)
    assert int4_w4a8_plan(64, 32768, 1536, 132).regime == "wgmma"
    assert w4a8_grid(2048, 256, int4_w4a8_plan(2048, 1536, 256, 132)) == (4, 16, 1)
