"""Paged decode attention: the hand-written Hopper kernel
(``csrc/paged_attention.cu``) and its plain PyTorch version.

Port of the Pallas kernel ``dots_ocr_tpu.ops.paged_attention.
paged_attention_multiquery`` (body ``_multipage_kernel``) in both of its
modes: bf16 K/V, and int8 K/V with per-token float32 scales. The JAX
package's nq = 1 wrapper ``paged_attention_multipage`` is a call of this
one with ``q[:, None]``.

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
from typing import Optional

import torch

from dots_ocr_tpu_torch.ops import kernel_lib
from dots_ocr_tpu_torch.ops.flash_attention import DEFAULT_MASK_VALUE

MAX_QUERY_ROWS = 24  # (H / KV) * nq rows one kernel block serves
INT8_TILE = 64  # tokens per tile of the int8 CUDA kernel


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
    package, including its int8 mode, which dequantizes K/V to bf16 and
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
    Returns [B, nq, H, D]. An int8 pool (with its scales) goes to
    :func:`paged_attention_multiquery_int8`. On CUDA: bf16 q and pages,
    int32 lengths and table, all contiguous; D in {64, 128}; page_size a
    multiple of 16; (H / KV) * nq <= 24."""
    if k_pages.dtype == torch.int8:
        return paged_attention_multiquery_int8(
            q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, sm_scale)
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

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = kernel_lib.load().dots_paged_attention_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), lengths.data_ptr(),
            page_indices.data_ptr(), out.data_ptr(), batch, nq, num_heads, kv_heads,
            head_dim, num_pages, page_size, max_pages, ctypes.c_float(scale),
            torch.cuda.current_stream().cuda_stream,
        )
    kernel_lib.check(err, "paged_attention_multiquery")
    paged_attention_multiquery.launches += 1
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
    """The int8 mode (module notes): int8 pools with float32 scales
    [KV, num_pages, page_size]. On CUDA it launches the int8 kernel of
    ``csrc/paged_attention.cu`` (tile INT8_TILE) or raises; the same limits
    as the bf16 mode apply, and q stays bf16."""
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


paged_attention_multiquery.launches = 0
paged_attention_multiquery_int8.launches = 0

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
    """The plain version of whichever kernel the pool's dtype selects, on
    any device (what the wrappers run for CPU tensors)."""
    if k_pages.dtype == torch.int8:
        return paged_attention_int8_reference(
            q, k_pages, v_pages, k_scales, v_scales, lengths, page_indices, sm_scale)
    return paged_attention_multiquery_reference(
        q, k_pages, v_pages, lengths, page_indices, sm_scale)


# attn_impl of the model functions (see ops.flash_attention.IMPLEMENTATIONS):
# the kernels, their plain versions, or the JAX package's XLA path.
IMPLEMENTATIONS = {
    "kernel": paged_attention_multiquery,
    "reference": paged_attention_plain,
    "xla": paged_attention_multiquery_reference,
}
