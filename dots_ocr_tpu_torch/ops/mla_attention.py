"""Paged latent decode: MLA's absorbed decode attention over a paged latent
cache, a CUDA kernel pair for the card (``csrc/mla_attention.cu``) and its
plain PyTorch version.

It replaces no kernel of the JAX package (which runs dots.ocr's GQA decoder
only); it was added for DeepSeek-V3's latent attention (MLA), which the port
runs for dots.vlm1. Each token of the cache holds one row of ``kv_rank +
rope_dim`` values (576: the RMS-normed latent and the rope key), shared by
every head. In the absorbed decode each head's query is already multiplied
into the latent space (``q_nope W_UK``, 512 wide) and carries its rope part
(64): the score of head h against token t is ``q[h] . row[t]`` over all
576 values, and the head's output is the softmax-weighted sum of the rows'
first ``kv_rank`` values (``W_UV`` is applied afterwards, outside).

Layouts:
  q:            [S, H, kv_rank + rope_dim] bf16 (one query row a slot)
  pool:         [1, num_pages * page_size, kv_rank + rope_dim] bf16 (one layer)
  page_tables:  [S, max_pages] int32, the null page 0 past each table's end
  seq_lens:     [S] int32 tokens each slot attends (0: exact zeros)
  out:          [S, H, kv_rank] in q's dtype

What bounds it on the H100, and the kernel's design (64 heads a block over
one split of a slot's context, both products on the tensor cores, float32
partials merged by ``mla_latent_merge_kernel``): the note at the top of
``csrc/mla_attention.cu``. The split plan (:func:`mla_split_plan`) comes
from static shapes alone, so a decode step never syncs and is captured in
CUDA graphs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from dots_ocr_tpu_torch.ops import kernel_lib

BLOCK_H = 64  # heads a block of the kernel
# The split plan: about SPLIT_WAVES blocks per SM, each split at least
# MIN_SPLIT_TOKENS long and a whole number of CHUNK_ALIGN tokens (a multiple
# of the kernel's 64-token tile). On the cell's shapes (64 slots, 128 heads,
# 64-page tables of 128) that is 16 splits of 512 tokens.
SPLIT_WAVES = 16
MIN_SPLIT_TOKENS = 256
CHUNK_ALIGN = 64
SHAPES = ((512, 64), (64, 16))  # (kv_rank, rope_dim) the kernel is built for


def mla_decode_reference(q: torch.Tensor, pool: torch.Tensor, page_tables: torch.Tensor,
                         seq_lens: torch.Tensor, page_size: int, kv_rank: int,
                         sm_scale: float) -> torch.Tensor:
    """Plain version: gather every table entry's rows, masked softmax over
    all ``kv_rank + rope_dim`` values in float32, the weighted sum of the
    first ``kv_rank``. Returns [S, H, kv_rank] in q's dtype."""
    s, _, width = q.shape
    s_max = page_tables.shape[1] * page_size
    pos = torch.arange(s_max, device=q.device)
    slots = page_tables[:, pos // page_size].long() * page_size + pos % page_size
    rows = pool.reshape(-1, width)[slots].to(torch.float32)  # [S, s_max, width]
    scores = torch.einsum("shd,std->sht", q.to(torch.float32), rows) * sm_scale
    seen = pos[None, :] < seq_lens.long()[:, None]  # [S, s_max]
    scores = scores.masked_fill(~seen[:, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1).nan_to_num(0.0)  # a row with no token: zeros
    return torch.einsum("sht,std->shd", probs, rows[..., :kv_rank]).to(q.dtype)


def mla_split_plan(slots: int, heads: int, max_tokens: int, num_sms: int) -> Tuple[int, int]:
    """(chunk, n_split) of the context axis from static shapes: split j
    covers tokens [j chunk, (j + 1) chunk) of every slot; about SPLIT_WAVES
    blocks an SM over (head blocks x splits x slots)."""
    base = slots * -(-heads // BLOCK_H)
    n_split = max(1, min(-(-SPLIT_WAVES * num_sms // base), -(-max_tokens // MIN_SPLIT_TOKENS)))
    chunk = -(-max(1, -(-max_tokens // n_split)) // CHUNK_ALIGN) * CHUNK_ALIGN
    return chunk, -(-max_tokens // chunk)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def mla_paged_decode(q: torch.Tensor, pool: torch.Tensor, page_tables: torch.Tensor,
                     seq_lens: torch.Tensor, page_size: int, kv_rank: int,
                     sm_scale: float) -> torch.Tensor:
    """Latent decode attention (layouts in the module docstring). CPU
    tensors take :func:`mla_decode_reference`; CUDA tensors launch the split
    kernel and its merge over :func:`mla_split_plan`'s splits, with float32
    scratch for the partials, or raise."""
    if q.device.type == "cpu":
        return mla_decode_reference(q, pool, page_tables, seq_lens, page_size, kv_rank, sm_scale)
    s, heads, width = q.shape
    rope = width - kv_rank
    _require(q.dtype == pool.dtype == torch.bfloat16, "q and pool must be bfloat16")
    _require(page_tables.dtype == seq_lens.dtype == torch.int32,
             "page tables and lengths must be int32")
    _require(pool.shape[-1] == width and pool.is_contiguous() and q.is_contiguous(),
             "pool [1, N, width] and q must be contiguous")
    _require(page_tables.is_contiguous() and seq_lens.is_contiguous(),
             "page tables and lengths must be contiguous")
    _require((kv_rank, rope) in SHAPES, f"(kv_rank, rope_dim) must be one of {SHAPES}")
    max_pages = page_tables.shape[1]
    chunk, n_split = mla_split_plan(s, heads, max_pages * page_size,
                                    _num_sms(q.device.index or 0))
    part_o = torch.empty((s, n_split, heads, kv_rank), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((s, n_split, heads, 2), dtype=torch.float32, device=q.device)
    out = torch.empty((s, heads, kv_rank), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = kernel_lib.load().dots_mla_latent_decode_bf16(
            q.data_ptr(), pool.data_ptr(), seq_lens.data_ptr(), page_tables.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(), s, heads, kv_rank, rope,
            page_size, max_pages, chunk, n_split, ctypes.c_float(sm_scale),
            torch.cuda.current_stream().cuda_stream)
    kernel_lib.check(err, "mla_paged_decode")
    mla_paged_decode.launches += 1
    return out


mla_paged_decode.launches = 0


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"mla_paged_decode: {message}")
