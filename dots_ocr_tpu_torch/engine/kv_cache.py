"""Paged KV cache: device pools and the host-side page allocator (port of
``dots_ocr_tpu.engine.kv_cache``, bf16 and int8 modes).

K and V for every live sequence share one pool of fixed-size pages per
layer; each sequence owns a page table. Pools are per-layer
[KV, num_pages * page_size, D] tensors updated in place (the JAX package
keeps per-layer tuples so XLA can alias buffers through its loops; eager
PyTorch writes where the pool lies). Page 0 is the null page: padded table
entries and inactive rows point at it.

int8 mode (``--kv-cache-dtype int8``): int8 pools plus one flat float32
scale vector [KV * num_pages * page_size] per layer and tensor, indexed
``head * N + slot``; each token row is quantized on its own
(:func:`quantize_kv`). The paged kernel reads the vector as a
[KV, num_pages, page_size] view.

DeepSeek's decoder (MLA, ``DecoderConfig.deepseek``) keeps one latent pool
a layer instead: [1, num_pages * page_size, kv_lora_rank + qk_rope_head_dim]
(576 values a token) in ``k``, shared by every head, and ``v`` is None. The
allocator and its pages are the same; bf16 only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from dots_ocr_tpu_torch.models.config import DecoderConfig


@dataclass
class PagedKV:
    """Per-layer K and V pools, each [KV, num_pages * page_size, D], and in
    int8 mode per-layer flat float32 scales [KV * num_pages * page_size];
    for MLA per-layer latent pools in ``k`` and no ``v``."""

    k: List[torch.Tensor]
    v: Optional[List[torch.Tensor]]
    k_scale: Optional[List[torch.Tensor]] = None
    v_scale: Optional[List[torch.Tensor]] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(cfg: DecoderConfig, num_pages: int, page_size: int,
               dtype: torch.dtype, device: torch.device,
               quantized: bool = False, kv_replication: int = 1,
               world: int = 1) -> "PagedKV":
        """Zeroed pools. Under tensor-parallel serving with the KV heads
        split over ``world`` ranks, a rank's pools hold its
        ``num_kv_heads * kv_replication / world`` heads: with more ranks
        than KV heads each head is repeated on ``kv_replication``
        contiguous ranks (Megatron GQA replication, as the JAX package pads
        its pool), so a rank holds one. MLA: the latent pools."""
        if cfg.deepseek is not None:
            if quantized or world != 1:
                raise ValueError("MLA's latent cache is bf16 on one device: int8 KV and "
                                 "tensor parallelism are not supported with it")
            shape = (1, num_pages * page_size, cfg.deepseek.latent_dim)
            return PagedKV([torch.zeros(shape, dtype=dtype, device=device)
                            for _ in range(cfg.num_layers)], None)
        heads = cfg.num_kv_heads * kv_replication
        if heads % world:
            raise ValueError(f"{heads} KV heads (x{kv_replication} replicas) do not split "
                             f"over {world} ranks")
        heads //= world
        shape = (heads, num_pages * page_size, cfg.head_dim)

        def zeros(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(cfg.num_layers)]

        if quantized:
            flat = (heads * num_pages * page_size,)
            return PagedKV(zeros(shape, torch.int8), zeros(shape, torch.int8),
                           zeros(flat, torch.float32), zeros(flat, torch.float32))
        return PagedKV(zeros(shape, dtype), zeros(shape, dtype))

    def layer_scales(self, layer: int, page_size: int):
        """(k_scales, v_scales) of one layer as [KV, num_pages, page_size]
        views, or (None, None) in bf16 mode."""
        if not self.quantized:
            return None, None
        kv = self.k[layer].shape[0]
        return (self.k_scale[layer].view(kv, -1, page_size),
                self.v_scale[layer].view(kv, -1, page_size))


def quantize_kv(x: torch.Tensor):
    """Per-vector symmetric int8 over the last (head_dim) axis:
    x [..., D] -> (int8 [..., D], f32 scale [...]) with x ~= int8 * scale.
    amax / 127, 1.0 for an all-zero row, round half to even, clip +-127."""
    xf = x.to(torch.float32)
    absmax = xf.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def scatter_kv_rows(pool: torch.Tensor, slots: torch.Tensor, updates: torch.Tensor) -> None:
    """Write per-token K/V rows into a [KV, N, D] pool IN PLACE.

    ``index_copy_`` on the flat [KV*N, D] row view: the pool is updated
    where it lies instead of being rebuilt (the JAX package returns a new
    array and relies on XLA buffer donation for the same effect).
    slots: [T] flat slot ids; updates: [T, KV, D].
    """
    kv, n, d = pool.shape
    rows = _flat_rows(kv, n, slots)
    upd = updates.transpose(0, 1).reshape(-1, d).to(pool.dtype)
    pool.view(kv * n, d).index_copy_(0, rows, upd)


def _flat_rows(kv: int, n: int, slots: torch.Tensor) -> torch.Tensor:
    """head * n + slot for every (head, slot), head-major: [KV * T]."""
    return (torch.arange(kv, device=slots.device, dtype=torch.int64)[:, None] * n
            + slots.to(torch.int64)[None, :]).reshape(-1)


def write_kv_rows(paged: PagedKV, layer: int, slots: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> None:
    """Write one layer's per-token K/V [T, KV, D] at flat slots [T], in
    place; in int8 mode quantize each row and write its scale too. A latent
    pool (no V) takes ``k`` alone."""
    if paged.quantized:
        kv, n = paged.k[layer].shape[:2]
        rows = _flat_rows(kv, n, slots)
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
        paged.k_scale[layer].index_copy_(0, rows, k_s.t().reshape(-1))
        paged.v_scale[layer].index_copy_(0, rows, v_s.t().reshape(-1))
    scatter_kv_rows(paged.k[layer], slots, k)
    if v is not None:
        scatter_kv_rows(paged.v[layer], slots, v)


def write_prefill_kv(paged: PagedKV, k_new: torch.Tensor, v_new: torch.Tensor,
                     slot_mapping: torch.Tensor) -> None:
    """Scatter prefill K/V into the pages in place (quantizing in int8
    mode). k_new/v_new [L, B, T, KV, D] (v_new None: latent rows in k_new);
    slot_mapping [B*T] int32 physical slots, -1 for padding tokens (written
    to the null page's slot 0)."""
    num_layers, batch, t, kv_heads, head_dim = k_new.shape
    slots = slot_mapping.clamp_min(0)
    for layer in range(num_layers):
        write_kv_rows(paged, layer, slots,
                      k_new[layer].reshape(batch * t, kv_heads, head_dim),
                      None if v_new is None else
                      v_new[layer].reshape(batch * t, kv_heads, head_dim))


class OutOfPages(RuntimeError):
    """No free pages for an admission or a sequence's growth."""


@dataclass
class PageAllocator:
    """Host-side page bookkeeping (the JAX package's allocator, copied:
    its module imports jax). Page 0 is reserved as the null page."""

    num_pages: int
    page_size: int
    max_pages_per_seq: int
    _free: List[int] = field(default_factory=list)
    _tables: Dict[int, List[int]] = field(default_factory=dict)
    _lengths: Dict[int, int] = field(default_factory=dict)

    def __post_init__(self):
        self._free = list(range(self.num_pages - 1, 0, -1))  # page 0 reserved

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def pages_needed(self, num_tokens: int) -> int:
        return -(-num_tokens // self.page_size)

    def allocate(self, seq_id: int, num_tokens: int) -> List[int]:
        """Create a sequence with capacity for num_tokens."""
        if seq_id in self._tables:
            raise ValueError(f"seq {seq_id} already allocated")
        need = self.pages_needed(num_tokens)
        if need > self.max_pages_per_seq:
            raise OutOfPages(
                f"sequence needs {need} pages > max_pages_per_seq {self.max_pages_per_seq}"
            )
        if need > len(self._free):
            raise OutOfPages(f"need {need} pages, {len(self._free)} free")
        pages = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = pages
        self._lengths[seq_id] = num_tokens
        return pages

    def extend(self, seq_id: int, new_length: int) -> None:
        """Grow a sequence to new_length tokens, appending pages as needed."""
        table = self._tables[seq_id]
        need = self.pages_needed(new_length)
        if need > self.max_pages_per_seq:
            raise OutOfPages(f"sequence exceeds max_pages_per_seq at {new_length}")
        while len(table) < need:
            if not self._free:
                raise OutOfPages("no free pages to extend sequence")
            table.append(self._free.pop())
        self._lengths[seq_id] = new_length

    def trim(self, seq_id: int, new_length: int) -> None:
        """Release reserved tail pages beyond new_length tokens. Shrink-only;
        new_length must not fall below the tokens actually written."""
        table = self._tables.get(seq_id)
        if table is None:
            return
        need = max(1, self.pages_needed(new_length))
        if need >= len(table):
            return
        while len(table) > need:
            self._free.append(table.pop())
        self._lengths[seq_id] = new_length

    def free(self, seq_id: int) -> None:
        pages = self._tables.pop(seq_id, [])
        self._lengths.pop(seq_id, None)
        self._free.extend(reversed(pages))

    def padded_table(self, seq_id: int) -> np.ndarray:
        """Page table padded to max_pages_per_seq with the null page."""
        out = np.zeros(self.max_pages_per_seq, np.int32)
        table = self._tables[seq_id]
        out[: len(table)] = table
        return out

    def slot_mapping(self, seq_id: int, start: int, count: int) -> np.ndarray:
        """Physical flat slots for logical positions [start, start+count)."""
        table = self._tables[seq_id]
        pos = np.arange(start, start + count)
        return (
            np.asarray(table, np.int64)[pos // self.page_size] * self.page_size
            + pos % self.page_size
        ).astype(np.int32)
