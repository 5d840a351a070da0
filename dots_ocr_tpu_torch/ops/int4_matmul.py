"""Grouped int4 weight-only matmul: the hand-written Hopper kernel
(``csrc/int4_matmul.cu``) and its plain PyTorch version.

Port of ``dots_ocr_tpu.ops.int4_matmul`` (Pallas body ``_int4_kernel``,
wrapper ``int4_matmul``, layer entry ``int4_linear``) in both of its modes:

  * W4A16: bf16 activations against the int4 weights, float32 sums;
  * W4A8 (``act_quant``, ``DOTS_INT4_ACT=1`` in ``int4_linear``): the
    activations are quantized per row to int8 first (``amax / 127``, 1 for
    an all-zero row, no clip) and the group products are integer products;
    the row's scale multiplies the float32 sum last.

Layout (as in the JAX package): ``packed [in/2, out]`` int8 holds two int4
values per byte along the contraction axis. The low nibble of row i is
``q[i] + 8`` (input rows ``[0, in/2)``), the high nibble ``q[i + in/2]`` in
two's complement. ``scales [in/128, out]`` float32 hold one symmetric scale
per 128-row input group and output column: ``w ~= q * s`` with q in
[-7, 7]. ``y = sum_g (x[:, g] @ q[g]) * s[g]``.

The JAX package's ``_pick_tile`` and ``DOTS_INT4_MIN_STEPS`` size the
Pallas grid to the TPU's VMEM; they have no counterpart here. The CUDA
kernel tiles itself and takes any number of rows. Both modes have two
regimes, picked from the row count alone (:func:`int4_regime`): up to
SPLIT_ROWS rows the contraction is split, above it a wgmma kernel runs.
W4A16 splits it over blocks (:func:`int4_split_plan`) and adds the same
exact float32 group products as the plain version in another order, so the
plain version takes no split. W4A8 stays bit-identical to the plain
version: its decode regime splits the integer group sums over the ranks of
a thread block cluster and adds the scaled terms in the Pallas order
(:func:`int4_w4a8_plan`).

``int4_matmul`` runs the plain version for tensors on the CPU; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from dots_ocr_tpu_torch.ops import kernel_lib

GROUP = 128  # input rows per scale group
# W4A16 regimes: at most SPLIT_ROWS rows (decode and k = 2 verify steps of
# 64 slots) split the contraction into units of SPLIT_UNIT packed rows over
# about SPLIT_BLOCKS_PER_SM blocks an SM (two fit); more rows (prefill
# chunks) run the wgmma kernel.
SPLIT_ROWS = 192
SPLIT_UNIT = 64
SPLIT_TILE_ROWS, SPLIT_TILE_COLS = 64, 128
SPLIT_BLOCKS_PER_SM = 2
# W4A8's decode regime (csrc/int4_matmul.cu, int4_w4a8_cluster_kernel): a
# cluster of up to W4A8_MAX_CLUSTER CTAs shares a W4A8_TILE_ROWS x cols
# output tile (cols in W4A8_COLS), each CTA a contiguous range of packed-row
# blocks; shared memory per CTA must stay under W4A8_SMEM_LIMIT.
W4A8_TILE_ROWS = 64
W4A8_COLS = (32, 64)
W4A8_MAX_CLUSTER = 8
W4A8_SMEM_LIMIT = 232448  # 227 KB: a block's dynamic shared memory on Hopper
W4A8_MAX_STAGES = 8
W4A8_PREFILL_ROWS, W4A8_PREFILL_COLS = 128, 128  # the wgmma regime's widest tile
# The plan's targets, from the sweep of kernel_ab.py (PERF.md): the split
# regime's fewest CTAs that reach W4A8_CTAS_PER_SM an SM; the wgmma
# regime's 128-column tiles where they give W4A8_WGMMA_TILES_PER_SM an SM.
# Cluster sizes that leave ranks idle for most of the kernel (per_rank *
# cluster more than W4A8_MAX_IMBALANCE times the blocks) are not taken.
W4A8_CTAS_PER_SM = 2
W4A8_MAX_IMBALANCE = 1.25
W4A8_WGMMA_TILES_PER_SM = 2


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """[..., in, out] integer values in [-7, 7] -> [..., in/2, out]
    nibble-packed int8. Low nibbles hold rows [0, in/2) biased by +8, high
    nibbles rows [in/2, in) in two's complement."""
    assert q.shape[-2] % 2 == 0, q.shape
    half = q.shape[-2] // 2
    lo = (q[..., :half, :].to(torch.int8) + 8) & 0xF
    hi = q[..., half:, :].to(torch.int8)
    return lo | (hi << 4)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [..., in/2, out] int8 -> [..., in, out]
    int8 (``>>`` on int8 is arithmetic, as ``jnp.right_shift`` is)."""
    lo = (packed & 0xF) - 8
    hi = packed >> 4
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def quantize_int4_np(w: np.ndarray, group: int = GROUP):
    """NumPy quantizer of the JAX package (tests): (packed, scales, q)."""
    in_dim, out_dim = w.shape
    g = in_dim // group
    wg = w.reshape(g, group, out_dim).astype(np.float32)
    s = np.maximum(np.abs(wg).max(axis=1) / 7.0, 1e-8)  # [G, out]
    q = np.clip(np.round(wg / s[:, None, :]), -7, 7).astype(np.int8)
    q = q.reshape(in_dim, out_dim)
    half = in_dim // 2
    packed = (((q[:half] + 8) & 0xF) | (q[half:] << 4)).astype(np.int8)
    return packed, s.astype(np.float32), q


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          scales: torch.Tensor) -> torch.Tensor:
    """Twin of the JAX package's XLA oracle: unpack, a grouped float32
    einsum, the scales, the sum over groups. Returns [..., out] float32
    (the caller casts)."""
    q = unpack_int4(packed)
    in_dim, out_dim = q.shape
    g = in_dim // GROUP
    xg = x.to(torch.float32).reshape(*x.shape[:-1], g, GROUP)
    qg = q.reshape(g, GROUP, out_dim).to(torch.float32)
    acc = torch.einsum("...gi,gio->...go", xg, qg)
    return (acc * scales).sum(dim=-2)


def quantize_rows(x: torch.Tensor):
    """W4A8's per-row activation quantization: (round(x / a_scale) as
    float32 integers, a_scale [S, 1]) with a_scale = amax / 127, or 1 for an
    all-zero row, and no clip. The divisor is a tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal, one rounding
    away from the kernel's true division."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    a_scale = torch.where(amax > 0, amax / amax.new_full((), 127.0), torch.ones_like(amax))
    return torch.round(xf / a_scale), a_scale


def int4_matmul_plain(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                      act_quant: bool = False) -> torch.Tensor:
    """The Pallas body's order of operations on any device, [S, in] ->
    [S, out] in x's dtype. Every low group first, each ``(x_g @ (q_lo + 8)
    - 8 * rowsum(x_g)) * s_g``, then every high group ``(x_g @ 16 q_hi) *
    (s_g / 16)``, summed into one float32 accumulator. The products run in
    float32, where they are exact (W4A8: integers below 2^24); W4A8
    quantizes x per row first and multiplies by the row's scale last."""
    half = packed.shape[0]
    groups_per_half = scales.shape[0] // 2
    lo = (packed & 0xF).to(torch.float32)  # q_lo + 8
    hi = (packed & -16).to(torch.float32)  # 16 * q_hi
    xs, a_scale = quantize_rows(x) if act_quant else (x.to(torch.float32), None)
    acc = torch.zeros(x.shape[0], packed.shape[1], dtype=torch.float32, device=x.device)
    for g in range(groups_per_half):
        a, b = g * GROUP, (g + 1) * GROUP
        xg = xs[:, a:b]
        acc = acc + (xg @ lo[a:b] - 8.0 * xg.sum(dim=1, keepdim=True)) * scales[g]
    for g in range(groups_per_half):
        a, b = g * GROUP, (g + 1) * GROUP
        s16 = scales[groups_per_half + g] * (1.0 / 16.0)
        acc = acc + (xs[:, half + a:half + b] @ hi[a:b]) * s16
    if act_quant:
        acc = acc * a_scale
    return acc.to(x.dtype)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"int4_matmul: {message}")


def int4_regime(rows: int) -> str:
    """Kernel 5's regime for ``rows`` rows in either mode: "split" (the
    contraction split over blocks) or "wgmma"."""
    return "split" if rows <= SPLIT_ROWS else "wgmma"


def int4_split_plan(rows: int, in_dim: int, out_dim: int, num_sms: int) -> tuple:
    """The split-K kernel's plan from static shapes only: ``(units_per_split,
    n_split)``, split s of every output tile taking the contraction's units
    [s u, (s + 1) u) of SPLIT_UNIT packed rows (half a low and half a high
    group), as many splits as put SPLIT_BLOCKS_PER_SM blocks on each SM, at
    most one a unit; every unit in exactly one split."""
    units = in_dim // 2 // SPLIT_UNIT
    tiles = -(-rows // SPLIT_TILE_ROWS) * (out_dim // SPLIT_TILE_COLS)
    n_split = max(1, min(units, -(-SPLIT_BLOCKS_PER_SM * num_sms // tiles)))
    per_split = -(-units // n_split)
    return per_split, -(-units // per_split)


class W4A8Plan(NamedTuple):
    """Kernel 5 W4A8's launch: ``regime`` "split" (the ordered cluster
    split, tiles of W4A8_TILE_ROWS x ``cols``, clusters of ``cluster`` CTAs)
    or "wgmma" (tiles of 128 rows x ``cols``, ``cluster`` 0: no cluster)."""
    regime: str
    cols: int
    cluster: int


def w4a8_ranges(in_dim: int, cluster: int) -> list:
    """The packed-row blocks [start, end) of each rank of a cluster, in rank
    order: the in_dim / 256 blocks (block kb holds low group kb and high
    group in_dim / 256 + kb) cut into contiguous, balanced ranges."""
    blocks = in_dim // 2 // GROUP
    return [(r * blocks // cluster, (r + 1) * blocks // cluster) for r in range(cluster)]


def _w4a8_layout(cols: int, cluster: int, in_dim: int) -> tuple:
    """(stages, bytes) of one CTA of the cluster kernel (its
    ``ClusterLayout::stages`` and ``smem``): the deepest ring, up to every
    step of a rank (W4A8_MAX_STAGES), that fits W4A8_SMEM_LIMIT, else
    min(3, per_rank) stages (0 stages: nothing fits)."""
    blocks = in_dim // 2 // GROUP
    per_rank = -(-blocks // cluster)
    # x's low and high 64-row slices (128 bytes a row), a packed tile of 128
    # rows x cols bytes, the two groups' float32 scales; 1,024-byte aligned
    stage = -(-(2 * W4A8_TILE_ROWS * GROUP + GROUP * cols + 2 * cols * 4) // 1024) * 1024
    # the base's alignment slack, the two unpacked s8 B tiles, the terms of
    # the rank's 2 * per_rank groups (64 rows x (cols + 8) float32), the
    # tile's row scales, the chain's table (an int a group)
    fixed = (1024 + 2 * cols * GROUP + 2 * per_rank * W4A8_TILE_ROWS * (cols + 8) * 4
             + 4 * W4A8_TILE_ROWS + 4 * 2 * blocks)
    for stages in range(min(per_rank, W4A8_MAX_STAGES), 0, -1):
        if stages * stage + fixed <= W4A8_SMEM_LIMIT:
            return (stages if stages >= min(3, per_rank) else 0), stages * stage + fixed
    least = min(3, per_rank)
    return 0, least * stage + fixed


def w4a8_smem(cols: int, cluster: int, in_dim: int) -> int:
    """Bytes of shared memory of one CTA of the cluster kernel at its
    deepest ring that fits (see ``_w4a8_layout``)."""
    return _w4a8_layout(cols, cluster, in_dim)[1]


def w4a8_stages(cols: int, cluster: int, in_dim: int) -> int:
    """Ring stages of the cluster kernel (0 where even min(3, per_rank)
    stages do not fit)."""
    return _w4a8_layout(cols, cluster, in_dim)[0]


def w4a8_candidates(rows: int, in_dim: int, out_dim: int) -> list:
    """Every (cols, cluster) the cluster kernel takes at these shapes: cols
    dividing out_dim, at most one rank a packed-row block, at most
    W4A8_MAX_CLUSTER ranks, the shared memory under W4A8_SMEM_LIMIT."""
    blocks = in_dim // 2 // GROUP
    return [(cols, cluster) for cols in W4A8_COLS if out_dim % cols == 0
            for cluster in range(1, min(W4A8_MAX_CLUSTER, blocks) + 1)
            if w4a8_stages(cols, cluster, in_dim) > 0]


def int4_w4a8_plan(rows: int, in_dim: int, out_dim: int, num_sms: int) -> W4A8Plan:
    """W4A8's regime and launch from static shapes only. Above SPLIT_ROWS
    rows: the wgmma kernel, on 128-column tiles where they give every SM
    W4A8_WGMMA_TILES_PER_SM tiles, else on 64. Up to it: the widest tile,
    then the fewest CTAs, that put W4A8_CTAS_PER_SM CTAs on every SM (each
    cluster rank reads its own packed tiles once; wider tiles re-read x
    less), else the most CTAs the shared memory allows, among the balanced
    cluster sizes. A contraction too long for any cluster's terms to fit
    its shared memory (in > ~14k) takes the wgmma kernel at any row count."""
    blocks = in_dim // 2 // GROUP
    options = [(cols, cluster) for cols, cluster in w4a8_candidates(rows, in_dim, out_dim)
               if -(-blocks // cluster) * cluster <= W4A8_MAX_IMBALANCE * blocks]
    if int4_regime(rows) == "wgmma" or not options:
        tiles = out_dim // W4A8_PREFILL_COLS * -(-rows // W4A8_PREFILL_ROWS)
        wide = tiles >= W4A8_WGMMA_TILES_PER_SM * num_sms
        return W4A8Plan("wgmma", W4A8_PREFILL_COLS if wide else W4A8_PREFILL_COLS // 2, 0)
    row_tiles = -(-rows // W4A8_TILE_ROWS)

    def ctas(option):
        cols, cluster = option
        return out_dim // cols * row_tiles * cluster

    enough = [o for o in options if ctas(o) >= W4A8_CTAS_PER_SM * num_sms]
    if enough:
        cols, cluster = min(enough, key=lambda o: (-o[0], ctas(o)))
    else:
        cols, cluster = max(options, key=lambda o: (ctas(o), o[0]))
    return W4A8Plan("split", cols, cluster)


def _check(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor) -> None:
    """Raise on what the kernel does not take (the fast test first: it runs
    on every call)."""
    dev = x.device
    if (x.dtype == torch.bfloat16 and packed.dtype == torch.int8
            and scales.dtype == torch.float32 and x.dim() == 2 and packed.dim() == 2
            and packed.device == dev and scales.device == dev and x.shape[0] >= 1
            and x.shape[1] % (2 * GROUP) == 0 and packed.shape[1] % 128 == 0
            and packed.shape[0] * 2 == x.shape[1]
            and scales.shape == (x.shape[1] // GROUP, packed.shape[1])
            and x.is_contiguous() and packed.is_contiguous() and scales.is_contiguous()
            and x.data_ptr() % 16 == 0 and packed.data_ptr() % 16 == 0
            and scales.data_ptr() % 16 == 0):
        return
    tensors = (x, packed, scales)
    _require(all(t.is_cuda and t.device == x.device for t in tensors),
             "all inputs must be on x's CUDA device")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors),
             "inputs must be contiguous and 16-byte aligned")
    _require(x.dtype == torch.bfloat16, f"x must be bfloat16, not {x.dtype}")
    _require(packed.dtype == torch.int8 and scales.dtype == torch.float32,
             "packed must be int8 and scales float32")
    _require(x.dim() == 2 and packed.dim() == 2 and x.shape[0] >= 1,
             f"x {tuple(x.shape)} must be [S >= 1, in], packed [in/2, out]")
    in_dim, out_dim = x.shape[1], packed.shape[1]
    _require(in_dim % (2 * GROUP) == 0, f"in {in_dim} is not a multiple of {2 * GROUP}")
    _require(out_dim % 128 == 0, f"out {out_dim} is not a multiple of 128")
    _require(False, f"packed {tuple(packed.shape)} / scales {tuple(scales.shape)} vs x "
                    f"{tuple(x.shape)}")


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                act_quant: bool = False) -> torch.Tensor:
    """[S, in] x packed [in/2, out] -> [S, out] in x's dtype (module notes).
    On CUDA: bf16 x, int8 packed, float32 scales, all contiguous on one
    device; in a multiple of 256, out of 128; any S >= 1. Counts launches in
    ``int4_matmul.launches`` (W4A16) and ``int4_matmul.w4a8_launches``, the
    latter also by regime (``w4a8_split_launches``, ``w4a8_wgmma_launches``)."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, packed, scales, act_quant)
    _check(x, packed, scales)
    index = x.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return int4_matmul(x, packed, scales, act_quant)
    rows, in_dim = x.shape
    out_dim = packed.shape[1]
    out = torch.empty(rows, out_dim, dtype=torch.bfloat16, device=x.device)
    stream = torch._C._cuda_getCurrentRawStream(index)
    lib = kernel_lib.load()
    if act_quant:
        plan = _w4a8_plan(rows, in_dim, out_dim, index)
        err = _w4a8_launch(lib, x, packed, scales, out, plan.cols, plan.cluster, stream)
    else:
        per_split, n_split = _w4a16_plan(rows, in_dim, out_dim, index)
        err = _w4a16_launch(lib, x, packed, scales, out, per_split, n_split, stream)
    kernel_lib.check(err, "int4_matmul")
    if act_quant:
        int4_matmul.w4a8_launches += 1
        if plan.regime == "split":
            int4_matmul.w4a8_split_launches += 1
        else:
            int4_matmul.w4a8_wgmma_launches += 1
    else:
        int4_matmul.launches += 1
    return out


@functools.lru_cache(maxsize=None)
def _w4a16_plan(rows: int, in_dim: int, out_dim: int, index: int) -> tuple:
    """(units_per_split, n_split) of the split-K kernel, (0, 1) for wgmma."""
    if int4_regime(rows) == "wgmma":
        return 0, 1
    num_sms = torch.cuda.get_device_properties(index).multi_processor_count
    return int4_split_plan(rows, in_dim, out_dim, num_sms)


@functools.lru_cache(maxsize=None)
def _w4a8_plan(rows: int, in_dim: int, out_dim: int, index: int) -> W4A8Plan:
    num_sms = torch.cuda.get_device_properties(index).multi_processor_count
    return int4_w4a8_plan(rows, in_dim, out_dim, num_sms)


int4_matmul.launches = 0
int4_matmul.w4a8_launches = 0
int4_matmul.w4a8_split_launches = 0
int4_matmul.w4a8_wgmma_launches = 0


def _w4a16_launch(lib, x, packed, scales, out, per_split: int, n_split: int, stream) -> int:
    """The W4A16 entry on checked CUDA inputs: split-K over ``n_split``
    splits of ``per_split`` units with float32 scratch for their partials,
    or (``per_split`` 0) the wgmma kernel. Returns the cudaError_t."""
    rows, in_dim = x.shape
    part = None
    if n_split > 1:
        part = torch.empty(n_split * rows * out.shape[1], dtype=torch.float32, device=x.device)
    return lib.dots_int4_matmul_w4a16(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(),
        0 if part is None else part.data_ptr(), out.data_ptr(), rows, in_dim, out.shape[1],
        per_split, n_split, stream)


def _w4a8_launch(lib, x, packed, scales, out, cols: int, cluster: int, stream) -> int:
    """The W4A8 entry on checked CUDA inputs: the row quantization into one
    scratch buffer (xq [S, in] int8, then the S float32 row scales), then
    the cluster kernel at ``cols`` columns and clusters of ``cluster`` CTAs,
    or (``cluster`` 0) the wgmma kernel at ``cols`` columns. Returns the
    cudaError_t."""
    rows, in_dim = x.shape
    scratch = torch.empty(rows * in_dim + 4 * rows, dtype=torch.int8, device=x.device)
    return lib.dots_int4_matmul_w4a8(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        rows, in_dim, out.shape[1], cols, cluster, stream)


def int4_matmul_xla(x: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
                    act_quant: bool = False) -> torch.Tensor:
    """The JAX package's CPU path for the same call: the XLA oracle cast to
    x's dtype. Like the JAX reference path, it ignores ``act_quant``."""
    return int4_matmul_reference(x, packed, scales).to(x.dtype)


# impl of int4_linear, as the attention ops' IMPLEMENTATIONS: the kernel,
# its plain version on any device, or the JAX package's CPU path. Tests and
# the chip smoke run point "kernel" at another entry to switch the model.
IMPLEMENTATIONS = {"kernel": int4_matmul, "reference": int4_matmul_plain,
                   "xla": int4_matmul_xla}


def int4_act_quant() -> bool:
    """Whether ``DOTS_INT4_ACT=1`` selects W4A8, read now (the JAX package
    reads it at each call)."""
    return os.environ.get("DOTS_INT4_ACT", "0") == "1"


def int4_linear(x: torch.Tensor, kernel: dict, impl: str = "kernel") -> torch.Tensor:
    """``layers.linear``'s entry for ``{"qint4", "scale4"}`` kernels: x
    [..., in] -> [..., out] in x's dtype. ``DOTS_INT4_ACT=1`` (read at each
    call, :func:`int4_act_quant`) selects W4A8, as in the JAX package."""
    act_quant = int4_act_quant()
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = IMPLEMENTATIONS[impl](x2, kernel["qint4"], kernel["scale4"], act_quant)
    return out.reshape(*x.shape[:-1], out.shape[-1])
