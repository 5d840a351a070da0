"""The Python around the redesigned kernels 1 and 2, on the CPU.

Kernel 1's tile list (``flash_tile_plan``) against the dense mask of the
function it computes; kernel 2's split of the token axis
(``paged_split_plan``) and its log-sum-exp merge of per-split partials
(``paged_split_partials`` + ``merge_split_partials``) against the plain
version and the JAX package's reference. Float32, numpy-seeded inputs.
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
    SPLIT_ALIGN,
    SPLIT_SCRATCH_BYTES,
    merge_split_partials,
    paged_attention_multiquery_reference,
    paged_split_partials,
    paged_split_plan,
)
from test_torch_cuda import paged_inputs


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
