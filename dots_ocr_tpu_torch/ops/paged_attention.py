"""Paged decode attention: the hand-written Hopper kernels
(``csrc/paged_attention.cu``, ``csrc/paged_attention_v1.cu``) and their
plain PyTorch versions.

Port of the Pallas kernel ``dots_ocr_tpu.ops.paged_attention.
paged_attention_multiquery`` (body ``_multipage_kernel``, kernel 2) in both
of its modes: bf16 K/V, and int8 K/V with per-token float32 scales. The JAX
package's nq = 1 wrapper ``paged_attention_multipage`` is a call of this
one with ``q[:, None]``. And of the v1 kernel ``paged_attention_stacked``
(body ``_paged_kernel``, kernel 3) with its single-layer wrapper
``paged_attention``: one query per row over a layer-stacked cache, a
page-by-page online softmax whose int8 mode dequantizes K and V (it does
not re-quantize P as kernel 2 does).

``paged_attention_multiquery`` dispatches as the JAX package does
(:func:`choose_paged_kernel`) for CUDA tensors: head_dim not a multiple of
128, or int8 K/V with page_size not a multiple of 128, send nq = 1 to
kernel 3 and nq > 1 to the twin of the XLA reference; everything else goes
to kernel 2. CPU tensors keep kernel 2's plain versions at every shape.

Layouts (as in the JAX package):
  q:            [B, nq, H, D]   (nq tokens per sequence)
  k/v pages:    [KV, num_pages, page_size, D], bf16 or int8
  k/v scales:   [KV, num_pages, page_size] float32 (int8 mode only)
  page_indices: [B, max_pages] int32, null page 0 past each table's end
  lengths:      [B] int32 base lengths: query j of row b attends tokens
                < lengths[b] + j; length 0 gives exact zeros.

The int8 mode computes what the Pallas body does (paged_attention.py
:400-509): each query row is quantized to int8 once (scale amax / 127),
scores are int32 Q.K products times both scales, and each tile's
probabilities are multiplied by V's scales, re-quantized to int8 per row
and multiplied by int8 V. That re-quantization depends on the tile it is
taken over, so the plain version takes the tile length: INT8_TILE, the
CUDA kernel's, by default; the Pallas kernel's is ``pages_per_block *
page_size`` (512 tokens capped by the table width).

The wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import Optional

import torch

from dots_ocr_tpu_torch.ops import kernel_lib
from dots_ocr_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE

logger = logging.getLogger(__name__)

MAX_QUERY_ROWS = 24  # (H / KV) * nq rows one kernel block serves
INT8_TILE = 64  # tokens per tile of the int8 CUDA kernel
# The bf16 kernel's split-K plan (paged_split_plan): splits are whole
# multiples of SPLIT_ALIGN tokens and at least MIN_SPLIT_TOKENS long, their
# float32 partials fit SPLIT_SCRATCH_BYTES, and the grid holds at most
# SPLIT_BLOCKS_PER_SM blocks per SM. That is the grid's size, not blocks
# resident at once (two fit on an SM): a block past its row's end exits at
# once, and with rows of mixed lengths most do. kernel_ab.py's sweep on an
# H100 at the shipping geometry (64 slots, lengths 0..12k, 320 pages of
# 128) set it: 28 splits were fastest at nq = 1 and 3, 16-32 within 8%,
# 40-48 8-13% slower, 64-80 20-37% slower (more partials to merge, shorter
# splits) and 8 splits 25-30% slower (too few blocks for the long rows).
SPLIT_ALIGN = 64
MIN_SPLIT_TOKENS = 256
SPLIT_SCRATCH_BYTES = 32 * 2**20
SPLIT_BLOCKS_PER_SM = 28
LOG2E = 1.4426950408889634


def paged_attention_multiquery_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of the bf16 mode: gather every table entry's page into
    contiguous K/V ([KV, B, max_pages * page_size, D]), then masked dense
    attention. Twin of ``paged_attention_multiquery_reference`` in the JAX
    package (at nq = 1, of its ``paged_attention_reference``), including its
    int8 mode, which dequantizes K/V to bf16 and
    runs the same float attention (not the int8 kernel's arithmetic: that
    is :func:`paged_attention_int8_reference`)."""
    kv_heads, _, page_size, head_dim = k_pages.shape
    batch, nq, num_heads, _ = q.shape
    s_max = page_indices.shape[1] * page_size
    scale = sm_scale if sm_scale is not None else head_dim**-0.5

    pos = torch.arange(s_max, device=q.device)
    slots = page_indices[:, pos // page_size].long() * page_size + pos % page_size
    k = k_pages.reshape(kv_heads, -1, head_dim)[:, slots]
    v = v_pages.reshape(kv_heads, -1, head_dim)[:, slots]
    if k_scales is not None:
        k = (k.to(torch.float32) * k_scales.reshape(kv_heads, -1)[:, slots][..., None]).to(torch.bfloat16)
        v = (v.to(torch.float32) * v_scales.reshape(kv_heads, -1)[:, slots][..., None]).to(torch.bfloat16)
    k = k.to(torch.float32)

    group = num_heads // kv_heads
    qg = q.reshape(batch, nq, kv_heads, group, head_dim).to(torch.float32)
    scores = torch.einsum("bjkgd,kbsd->bjkgs", qg, k) * scale
    j = torch.arange(nq, device=q.device)
    lens = lengths.long()
    mask = (pos[None, None, :] < lens[:, None, None] + j[None, :, None]) & (
        lens[:, None, None] > 0
    )
    mask = mask[:, :, None, None, :]  # [B, nq, 1, 1, S]
    probs = torch.softmax(scores.masked_fill(~mask, DEFAULT_MASK_VALUE), dim=-1)
    probs = probs * mask
    out = torch.einsum(
        "bjkgs,kbsd->bjkgd", probs.to(v.dtype).to(torch.float32), v.to(torch.float32)
    )
    return out.reshape(batch, nq, num_heads, head_dim).to(q.dtype)


def paged_split_plan(batch: int, kv_heads: int, rows: int, head_dim: int, max_tokens: int,
                     num_sms: int) -> tuple:
    """The bf16 kernel's split of the token axis, from static shapes only
    (no device value, so a decode step never syncs): ``(chunk, n_split)``,
    split s covering tokens [s * chunk, (s + 1) * chunk) of every row, with
    ``n_split * chunk >= max_tokens`` (the table's max_pages * page_size)
    and ``rows`` = (H / KV) * nq query rows per (slot, KV head). As many
    splits as the three limits allow: MIN_SPLIT_TOKENS per split, float32
    partials (O and m, l: ``rows * (head_dim + 2)`` floats per slot, KV head
    and split) within SPLIT_SCRATCH_BYTES, SPLIT_BLOCKS_PER_SM blocks per SM."""
    per_split = batch * kv_heads * rows * (head_dim + 2) * 4
    n_split = max(1, min(SPLIT_SCRATCH_BYTES // per_split,
                         -(-max_tokens // MIN_SPLIT_TOKENS),
                         -(-SPLIT_BLOCKS_PER_SM * num_sms // (batch * kv_heads))))
    chunk = -(-max(1, -(-max_tokens // n_split)) // SPLIT_ALIGN) * SPLIT_ALIGN
    return chunk, max(1, -(-max_tokens // chunk))


def paged_split_partials(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    chunk: int,
    sm_scale: Optional[float] = None,
):
    """Plain version of the bf16 kernel's first pass: per split of ``chunk``
    tokens, the float32 partials (m, l in the base-2 domain, unnormalized
    O) of each query row over the split's visible tokens. Returns m, l
    [B, n_split, nq, H] and o [B, n_split, nq, H, D]; a split with no
    visible token has m = -inf, l = 0, o = 0."""
    kv_heads, _, page_size, head_dim = k_pages.shape
    batch, nq, num_heads, _ = q.shape
    s_max = page_indices.shape[1] * page_size
    n_split = -(-s_max // chunk)
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    pos = torch.arange(s_max, device=q.device)
    slots = page_indices[:, pos // page_size].long() * page_size + pos % page_size
    k = k_pages.reshape(kv_heads, -1, head_dim)[:, slots].to(torch.float32)
    v = v_pages.reshape(kv_heads, -1, head_dim)[:, slots].to(torch.float32)
    group = num_heads // kv_heads
    qg = q.reshape(batch, nq, kv_heads, group, head_dim).to(torch.float32)
    scores = torch.einsum("bjkgd,kbsd->bjkgs", qg, k) * (scale * LOG2E)
    lens = lengths.long()
    j = torch.arange(nq, device=q.device)
    seen = (pos[None, None, :] < lens[:, None, None] + j[None, :, None]) & (lens[:, None, None] > 0)
    seen = seen[:, :, None, None, :]  # [B, nq, 1, 1, S]
    ms, ls, os_ = [], [], []
    for s0 in range(0, s_max, chunk):
        sc, ok = scores[..., s0:s0 + chunk], seen[..., s0:s0 + chunk]
        m = torch.where(ok, sc, float("-inf")).amax(dim=-1, keepdim=True)
        p = torch.where(ok, torch.exp2(sc - torch.where(torch.isinf(m), 0.0, m)), 0.0)
        ms.append(m[..., 0])
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bjkgs,kbsd->bjkgd", p, v[:, :, s0:s0 + chunk]))
    shape = (batch, n_split, nq, num_heads)
    return (torch.stack(ms, 1).reshape(shape), torch.stack(ls, 1).reshape(shape),
            torch.stack(os_, 1).reshape(*shape, head_dim))


def merge_split_partials(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Plain version of the bf16 kernel's merge: the log-sum-exp combination
    of per-split partials (m, l [B, n_split, nq, H] base 2; o [..., D])
    over the split axis, exact zeros where no split saw a token. Returns
    float32 [B, nq, H, D]."""
    m_all = m.amax(dim=1, keepdim=True)
    w = torch.where(torch.isinf(m), 0.0, torch.exp2(m - torch.where(torch.isinf(m_all), 0.0,
                                                                     m_all)))
    l_all = (l * w).sum(dim=1)
    o_all = (o * w[..., None]).sum(dim=1)
    return torch.where(l_all[..., None] > 0, o_all / l_all.clamp_min(1e-30)[..., None], 0.0)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _round_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """round(x / scale) as float32 integers (half to even, as the kernel's
    ``__float2int_rn`` and ``jnp.round``)."""
    return torch.round(x / scale)


def _amax_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-row int8 scale over the last axis: amax / 127, 1 for an all-zero row."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    # A tensor divisor: PyTorch's CUDA division by a Python scalar multiplies
    # by its reciprocal, one rounding away from the kernel's true division.
    return torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))


def paged_attention_int8_reference(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
    tile: int = INT8_TILE,
) -> torch.Tensor:
    """Plain version of the int8 mode: the Pallas body's arithmetic as a
    tiled online softmax over ``tile``-token tiles. The integer products
    run in float32, where they are exact (|sum| <= 127^2 * D < 2^24 for
    D <= 128), and every other step takes the kernel's order of
    operations, so on one device kernel and plain differ by the summation
    order of the softmax denominator. Tokens past each row's last visible
    position are zero-filled (K, V and both scales), as the kernel does.

    This is NOT the JAX package's ``paged_attention_multiquery_reference``
    in int8 mode, which dequantizes K/V to bf16 and runs float attention
    (ROADMAP queue C, item 2); it agrees with that within 3e-2.
    """
    kv_heads, _, page_size, head_dim = k_pages.shape
    batch, nq, num_heads, _ = q.shape
    group = num_heads // kv_heads
    max_pages = page_indices.shape[1]
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    dev = q.device

    lens = lengths.long()
    n_tok = torch.where(lens > 0, (lens + nq - 1).clamp_max(max_pages * page_size), 0)
    span = -(-int(n_tok.max()) // tile) * tile  # host sync: plain version only
    pos = torch.arange(span, device=dev)
    page_col = (pos // page_size).clamp_max(max_pages - 1)
    slots = page_indices[:, page_col].long() * page_size + pos % page_size  # [B, S]
    live = pos[None, :] < n_tok[:, None]  # [B, S]

    def gather(pages, scales):
        rows = pages.reshape(kv_heads, -1, head_dim)[:, slots].to(torch.float32)
        sc = scales.reshape(kv_heads, -1)[:, slots]
        return rows * live[None, :, :, None], torch.where(live[None], sc, 0.0)

    k, ks = gather(k_pages, k_scales)  # [KV, B, S, D], [KV, B, S]
    v, vs = gather(v_pages, v_scales)

    qf = q.to(torch.float32).reshape(batch, nq, kv_heads, group, head_dim)
    qs = _amax_scale(qf)  # [B, nq, KV, G, 1]
    s = torch.einsum("bjkgd,kbsd->bjkgs", _round_int8(qf, qs), k)  # exact
    s = s * qs * ks.permute(1, 0, 2)[:, None, :, None, :] * scale
    j = torch.arange(nq, device=dev)
    valid = (pos[None, None, :] < lens[:, None, None] + j[None, :, None]) & live[:, None, :]
    valid = valid[:, :, None, None, :]  # [B, nq, 1, 1, S]
    s = torch.where(valid, s, DEFAULT_MASK_VALUE)
    vs = vs.permute(1, 0, 2)[:, None, :, None, :]  # [B, 1, KV, 1, S]

    m = torch.full((batch, nq, kv_heads, group, 1), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, nq, kv_heads, group, head_dim), device=dev)
    for t0 in range(0, span, tile):
        st, ok = s[..., t0:t0 + tile], valid[..., t0:t0 + tile]
        m_next = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        p = torch.where(ok, torch.exp(st - m_next), 0.0)
        alpha = torch.exp(m - m_next)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        pp = torch.where(ok, p * vs[..., t0:t0 + tile], 0.0)
        pscale = _amax_scale(pp)
        pv = torch.einsum("bjkgs,kbsd->bjkgd", _round_int8(pp, pscale),
                          v[:, :, t0:t0 + tile])  # exact
        acc = acc * alpha + pv * pscale
        m = m_next
    l_inv = torch.where(l == 0, 0.0, 1.0 / l)
    return (acc * l_inv).reshape(batch, nq, num_heads, head_dim).to(q.dtype)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"paged_attention_multiquery: {message}")


def _check_common(q, k_pages, v_pages, lengths, page_indices, tensors) -> None:
    batch, nq, num_heads, head_dim = q.shape
    kv_heads, _, page_size, _ = k_pages.shape
    max_pages = page_indices.shape[1]
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "all inputs must be on q's CUDA device")
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _require(q.dtype == torch.bfloat16, "q must be bfloat16")
    _require(lengths.dtype == page_indices.dtype == torch.int32,
             "lengths and page_indices must be int32")
    _require(head_dim in (64, 128), f"head_dim {head_dim} not in (64, 128)")
    _require(page_size % 16 == 0, f"page_size {page_size} not a multiple of 16")
    _require(v_pages.shape == k_pages.shape and k_pages.shape[3] == head_dim,
             f"pages {tuple(k_pages.shape)}/{tuple(v_pages.shape)} vs q {tuple(q.shape)}")
    _require(lengths.shape == (batch,) and page_indices.shape == (batch, max_pages),
             "lengths / page_indices shapes")
    _require(num_heads % kv_heads == 0, f"{num_heads} heads vs {kv_heads} KV heads")
    _require((num_heads // kv_heads) * nq <= MAX_QUERY_ROWS,
             f"(H / KV) * nq = {(num_heads // kv_heads) * nq} > {MAX_QUERY_ROWS}")


def choose_paged_kernel(head_dim: int, page_size: int, quantized: bool, nq: int) -> str:
    """Which function a multi-query paged call computes, by the JAX
    package's rule (``paged_attention_multiquery``, paged_attention.py
    :589-606): "multiquery" (kernel 2), "v1" (kernel 3, nq = 1) or "xla"
    (the XLA reference, nq > 1). The Pallas kernel 2 needs head_dim and, in
    int8 mode, page_size to be multiples of 128; the port keeps the rule so
    that it computes the JAX package's function at every shape."""
    if head_dim % 128 != 0 or (quantized and page_size % 128 != 0):
        return "v1" if nq == 1 else "xla"
    return "multiquery"


def _log_route(route: str, head_dim: int, page_size: int, quantized: bool) -> None:
    key = (route, head_dim, page_size, quantized)
    if key not in _LOGGED:
        _LOGGED.add(key)
        logger.info("paged attention at head_dim %d, page_size %d, %s K/V: %s, as the JAX "
                    "package computes it there", head_dim, page_size,
                    "int8" if quantized else "bf16",
                    "kernel 3 (v1) for nq = 1" if route == "v1" else
                    "the XLA reference for nq > 1")


def paged_attention_multiquery(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-query paged decode attention (module notes give the layouts).
    Returns [B, nq, H, D]. On CUDA the call goes where
    :func:`choose_paged_kernel` says: kernel 2 (:func:`paged_attention_multiquery_bf16`
    or, for an int8 pool with its scales, :func:`paged_attention_multiquery_int8`),
    kernel 3 (:func:`paged_attention`) or the XLA reference's twin. On the
    CPU it runs kernel 2's plain versions."""
    quantized = k_pages.dtype == torch.int8
    if q.is_cuda:
        route = choose_paged_kernel(q.shape[-1], k_pages.shape[2], quantized, q.shape[1])
        if route != "multiquery":
            _log_route(route, q.shape[-1], k_pages.shape[2], quantized)
        if route == "v1":
            return paged_attention(q[:, 0], k_pages, v_pages, lengths, page_indices,
                                   sm_scale, k_scales, v_scales)[:, None]
        if route == "xla":
            return paged_attention_multiquery_reference(
                q, k_pages, v_pages, lengths, page_indices, sm_scale, k_scales, v_scales)
    if quantized:
        return paged_attention_multiquery_int8(
            q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, sm_scale)
    return paged_attention_multiquery_bf16(q, k_pages, v_pages, lengths, page_indices, sm_scale)


def paged_attention_multiquery_bf16(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel 2's bf16 mode at any shape it takes. On CUDA: bf16 q and
    pages, int32 lengths and table, all contiguous; D in {64, 128};
    page_size a multiple of 16; (H / KV) * nq <= 24. On CUDA the call
    launches the split-K kernel and its merge (``csrc/paged_attention.cu``)
    over :func:`paged_split_plan`'s splits, with float32 scratch for the
    partials."""
    if q.device.type == "cpu":
        return paged_attention_multiquery_reference(
            q, k_pages, v_pages, lengths, page_indices, sm_scale
        )
    batch, nq, num_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    max_pages = page_indices.shape[1]
    _check_common(q, k_pages, v_pages, lengths, page_indices,
                  (q, k_pages, v_pages, lengths, page_indices))
    _require(k_pages.dtype == v_pages.dtype == torch.bfloat16,
             "pages must be bfloat16 or int8")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5

    rows = num_heads // kv_heads * nq
    chunk, n_split = paged_split_plan(batch, kv_heads, rows, head_dim, max_pages * page_size,
                                      _num_sms(q.device.index or 0))
    part_o = torch.empty((batch, kv_heads, n_split, rows, head_dim), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((batch, kv_heads, n_split, rows, 2), dtype=torch.float32,
                          device=q.device)
    return _paged_bf16_launch(q, k_pages, v_pages, lengths, page_indices, part_o, part_ml, chunk,
                              n_split, scale)


def _paged_bf16_launch(q, k_pages, v_pages, lengths, page_indices, part_o, part_ml, chunk,
                       n_split, scale) -> torch.Tensor:
    """Launch the split kernel and its merge on checked CUDA inputs, split
    s covering tokens [s * chunk, (s + 1) * chunk), with the caller's
    float32 scratch: part_o [B, KV, n_split, R, D] and part_ml [B, KV,
    n_split, R, 2] (R = (H / KV) * nq, row r = g * nq + j serving query
    head kv_head * (H / KV) + g at query j). Afterwards each live split
    (one that starts before its row's n_tok) holds its unnormalized O and
    (m, l) in the base-2 domain (l = 0 and O = 0 for a query row that saw
    no token of it); the other splits are left unwritten."""
    batch, nq, num_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    max_pages = page_indices.shape[1]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kernel_lib.load().dots_paged_attention_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
            page_indices.data_ptr(), part_o.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            batch, nq, num_heads, kv_heads, head_dim, num_pages, page_size, max_pages, chunk,
            n_split, ctypes.c_float(scale), torch.cuda.current_stream().cuda_stream,
        )
    kernel_lib.check(err, "paged_attention_multiquery_bf16")
    paged_attention_multiquery_bf16.launches += 1
    if nq > 1:  # speculative verify steps
        paged_attention_multiquery_bf16.verify_launches += 1
    return out


def paged_attention_multiquery_int8(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    k_scales: torch.Tensor,
    v_scales: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel 2's int8 mode (module notes) at any shape it takes: int8
    pools with float32 scales [KV, num_pages, page_size]. On CUDA it
    launches the int8 kernel of ``csrc/paged_attention.cu`` (tile
    INT8_TILE) or raises; the same limits as the bf16 mode apply, and q
    stays bf16."""
    _require(k_scales is not None and v_scales is not None,
             "an int8 pool needs k_scales and v_scales")
    if q.device.type == "cpu":
        return paged_attention_int8_reference(
            q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, sm_scale)
    batch, nq, num_heads, head_dim = q.shape
    kv_heads, num_pages, page_size, _ = k_pages.shape
    max_pages = page_indices.shape[1]
    tensors = (q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices)
    _check_common(q, k_pages, v_pages, lengths, page_indices, tensors)
    _require(k_pages.dtype == v_pages.dtype == torch.int8, "pages must both be int8")
    _require(k_scales.dtype == v_scales.dtype == torch.float32, "scales must be float32")
    _require(k_scales.shape == v_scales.shape == (kv_heads, num_pages, page_size),
             f"scales {tuple(k_scales.shape)} vs pages {tuple(k_pages.shape)}")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kernel_lib.load().dots_paged_attention_int8(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), k_scales.data_ptr(),
            v_scales.data_ptr(), lengths.data_ptr(), page_indices.data_ptr(),
            out.data_ptr(), batch, nq, num_heads, kv_heads, head_dim, num_pages,
            page_size, max_pages, ctypes.c_float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    kernel_lib.check(err, "paged_attention_multiquery_int8")
    paged_attention_multiquery_int8.launches += 1
    return out


paged_attention_multiquery_bf16.launches = 0
paged_attention_multiquery_bf16.verify_launches = 0
paged_attention_multiquery_int8.launches = 0


def paged_attention_v1_reference(
    q: torch.Tensor,
    k_pages_all: torch.Tensor,
    v_pages_all: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    page_size: int,
    k_scales_all: Optional[torch.Tensor] = None,
    v_scales_all: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version of kernel 3 (:func:`paged_attention_stacked`): the
    Pallas body's online softmax over ``page_size``-token tiles, in its
    order of rounding. q in float32; bf16 K promoted to float32 (int8: K
    times its scale, kept in float32) and V in the pool's dtype (int8: V
    times its scale, rounded to bf16); p rounded to V's dtype before P @ V;
    the NaN guard on alpha; a row of length 0 gives exact zeros. Returns
    [B, H, D]."""
    _, kv_heads, _, head_dim = k_pages_all.shape
    batch, num_heads, _ = q.shape
    group = num_heads // kv_heads
    scale = sm_scale if sm_scale is not None else head_dim**-0.5
    dev = q.device
    k_layer, v_layer = k_pages_all[layer], v_pages_all[layer]  # [KV, N, D]
    quantized = k_scales_all is not None

    lens = lengths.long()
    n_pages = min(-(-int(lens.max()) // page_size), page_indices.shape[1]) if batch else 0
    qf = q.to(torch.float32).reshape(batch, kv_heads, group, head_dim)
    m = torch.full((batch, kv_heads, group, 1), float("-inf"), device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, kv_heads, group, head_dim), device=dev)
    offs = torch.arange(page_size, device=dev)
    for i in range(n_pages):  # host sync above: plain version only
        slots = page_indices[:, i].long()[:, None] * page_size + offs  # [B, ps]
        k = k_layer[:, slots].to(torch.float32)  # [KV, B, ps, D]
        v = v_layer[:, slots]
        if quantized:
            k = k * k_scales_all[layer][:, slots][..., None]
            v = (v.to(torch.float32) * v_scales_all[layer][:, slots][..., None]).to(torch.bfloat16)
        valid = ((i * page_size + offs)[None, :] < lens[:, None])[:, None, None, :]
        s = torch.einsum("bkgd,kbsd->bkgs", qf, k) * scale
        s = torch.where(valid, s, DEFAULT_MASK_VALUE)
        m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(valid, torch.exp(s - m_next), 0.0)
        alpha = torch.exp(m - m_next)
        alpha = torch.where(torch.isnan(alpha), 0.0, alpha)
        pv = torch.einsum("bkgs,kbsd->bkgd", p.to(v.dtype).to(torch.float32),
                          v.to(torch.float32))
        run = (i * page_size < lens)[:, None, None, None]  # rows this page runs for
        l = torch.where(run, alpha * l + p.sum(dim=-1, keepdim=True), l)
        acc = torch.where(run, acc * alpha + pv, acc)
        m = torch.where(run, m_next, m)
    l_inv = torch.where(l == 0, 0.0, 1.0 / l)
    return (acc * l_inv).reshape(batch, num_heads, head_dim).to(q.dtype)


MAX_V1_GROUP = 8  # H / KV query rows one kernel-3 block serves
MAX_V1_PAGE = 1024  # tokens per page kernel 3's score buffer holds


def paged_attention_stacked(
    q: torch.Tensor,
    k_pages_all: torch.Tensor,
    v_pages_all: torch.Tensor,
    layer: int,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    page_size: int,
    k_scales_all: Optional[torch.Tensor] = None,
    v_scales_all: Optional[torch.Tensor] = None,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Kernel 3: paged decode attention of one query per row, reading
    layer ``layer`` of a layer-stacked cache. q [B, H, D]; k/v_pages_all
    [L, KV, N_slots, D] (N_slots = num_pages * page_size), bf16 or int8
    with float32 scales [L, KV, N_slots]; lengths [B] int32 (tokens valid,
    the current one included); page_indices [B, max_pages] int32. Returns
    [B, H, D]. On CUDA it launches ``csrc/paged_attention_v1.cu`` or
    raises: bf16 q, contiguous inputs, D in {64, 128}, page_size a multiple
    of 16 up to 1,024, H / KV <= 8."""
    if q.device.type == "cpu":
        return paged_attention_v1_reference(
            q, k_pages_all, v_pages_all, layer, lengths, page_indices, page_size,
            k_scales_all, v_scales_all, sm_scale)
    batch, num_heads, head_dim = q.shape
    num_layers, kv_heads, n_slots, _ = k_pages_all.shape
    max_pages = page_indices.shape[1]
    quantized = k_pages_all.dtype == torch.int8
    tensors = (q, k_pages_all, v_pages_all, lengths, page_indices)
    if quantized:
        _require(k_scales_all is not None and v_scales_all is not None,
                 "an int8 pool needs k_scales and v_scales")
        tensors += (k_scales_all, v_scales_all)
    _require(all(t.is_cuda and t.device == q.device for t in tensors),
             "all inputs must be on q's CUDA device")
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _require(q.dtype == torch.bfloat16, "q must be bfloat16")
    _require(lengths.dtype == page_indices.dtype == torch.int32,
             "lengths and page_indices must be int32")
    _require(head_dim in (64, 128), f"head_dim {head_dim} not in (64, 128)")
    _require(page_size % 16 == 0 and page_size <= MAX_V1_PAGE,
             f"page_size {page_size} not a multiple of 16 up to {MAX_V1_PAGE}")
    _require(n_slots % page_size == 0, f"{n_slots} slots not whole pages of {page_size}")
    _require(v_pages_all.shape == k_pages_all.shape and k_pages_all.shape[3] == head_dim,
             f"pages {tuple(k_pages_all.shape)}/{tuple(v_pages_all.shape)} vs q {tuple(q.shape)}")
    _require(lengths.shape == (batch,) and page_indices.shape == (batch, max_pages),
             "lengths / page_indices shapes")
    _require(num_heads % kv_heads == 0 and num_heads // kv_heads <= MAX_V1_GROUP,
             f"{num_heads} heads vs {kv_heads} KV heads (H / KV <= {MAX_V1_GROUP})")
    _require(0 <= layer < num_layers, f"layer {layer} of {num_layers}")
    if quantized:
        _require(k_scales_all.dtype == v_scales_all.dtype == torch.float32,
                 "scales must be float32")
        _require(k_scales_all.shape == v_scales_all.shape == (num_layers, kv_heads, n_slots),
                 f"scales {tuple(k_scales_all.shape)} vs pages {tuple(k_pages_all.shape)}")
    else:
        _require(k_pages_all.dtype == v_pages_all.dtype == torch.bfloat16,
                 "pages must be bfloat16 or int8")
    scale = sm_scale if sm_scale is not None else head_dim**-0.5

    out = torch.empty_like(q)
    lib = kernel_lib.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        dims = (batch, num_heads, kv_heads, head_dim, n_slots, page_size, max_pages, int(layer),
                ctypes.c_float(scale), stream)
        if quantized:
            err = lib.dots_paged_attention_v1_int8(
                q.data_ptr(), k_pages_all.data_ptr(), v_pages_all.data_ptr(),
                k_scales_all.data_ptr(), v_scales_all.data_ptr(), lengths.data_ptr(),
                page_indices.data_ptr(), out.data_ptr(), *dims)
        else:
            err = lib.dots_paged_attention_v1_bf16(
                q.data_ptr(), k_pages_all.data_ptr(), v_pages_all.data_ptr(),
                lengths.data_ptr(), page_indices.data_ptr(), out.data_ptr(), *dims)
    kernel_lib.check(err, "paged_attention_stacked")
    if quantized:
        paged_attention_stacked.int8_launches += 1
    else:
        paged_attention_stacked.launches += 1
    return out


paged_attention_stacked.launches = 0
paged_attention_stacked.int8_launches = 0


def _stack_one(pages: torch.Tensor, scales: Optional[torch.Tensor]):
    """[KV, num_pages, page_size, D] pages (and [KV, num_pages, page_size]
    scales) as a one-layer stack [1, KV, N_slots, D] (and [1, KV, N_slots])."""
    kv_heads, _, _, head_dim = pages.shape
    stacked = pages.reshape(1, kv_heads, -1, head_dim)
    return stacked, None if scales is None else scales.reshape(1, kv_heads, -1)


def paged_attention(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel 3 on one layer's pools [KV, num_pages, page_size, D] (the
    JAX package's single-layer wrapper: a unit layer axis). q [B, H, D];
    returns [B, H, D]."""
    k_all, ks_all = _stack_one(k_pages, k_scales)
    v_all, vs_all = _stack_one(v_pages, v_scales)
    return paged_attention_stacked(q, k_all, v_all, 0, lengths, page_indices, k_pages.shape[2],
                                   ks_all, vs_all, sm_scale)


def paged_attention_v1_step(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The decoder's ``attn_impl="v1"``: kernel 3 for a decode step
    (q [B, 1, H, D]), as the JAX decoder's ``paged_v1`` branch. A verify
    step (nq > 1) raises: the JAX package has no such branch."""
    if q.shape[1] != 1:
        raise ValueError(f"attn_impl 'v1' takes one query per row, got nq = {q.shape[1]}")
    return paged_attention(q[:, 0], k_pages, v_pages, lengths, page_indices, sm_scale,
                           k_scales, v_scales)[:, None]


def paged_attention_plain(
    q: torch.Tensor,
    k_pages: torch.Tensor,
    v_pages: torch.Tensor,
    lengths: torch.Tensor,
    page_indices: torch.Tensor,
    sm_scale: Optional[float] = None,
    k_scales: Optional[torch.Tensor] = None,
    v_scales: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The plain version of whichever function :func:`paged_attention_multiquery`
    computes for these tensors, on any device: on CUDA it follows the same
    dispatch; on the CPU it is what the wrappers run there."""
    quantized = k_pages.dtype == torch.int8
    route = (choose_paged_kernel(q.shape[-1], k_pages.shape[2], quantized, q.shape[1])
             if q.is_cuda else "multiquery")
    if route == "v1":
        k_all, ks_all = _stack_one(k_pages, k_scales)
        v_all, vs_all = _stack_one(v_pages, v_scales)
        return paged_attention_v1_reference(q[:, 0], k_all, v_all, 0, lengths, page_indices,
                                            k_pages.shape[2], ks_all, vs_all, sm_scale)[:, None]
    if quantized and route == "multiquery":
        return paged_attention_int8_reference(
            q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, sm_scale)
    return paged_attention_multiquery_reference(
        q, k_pages, v_pages, lengths, page_indices, sm_scale, k_scales, v_scales)


_LOGGED: set = set()

# attn_impl of the model functions (see ops.flash_attention.IMPLEMENTATIONS):
# the kernels, their plain versions, the JAX package's XLA path, or kernel 3
# on every decode step (the JAX decoder's "paged_v1").
IMPLEMENTATIONS = {
    "kernel": paged_attention_multiquery,
    "reference": paged_attention_plain,
    "xla": paged_attention_multiquery_reference,
    "v1": paged_attention_v1_step,
}
