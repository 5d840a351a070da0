"""W8A16 matmul: bf16 activations against int8 weight-only weights, the
hand-written Hopper kernel (``csrc/int8_matmul.cuh``, its C entry in
``csrc/int8_matmul.cu``) and its plain PyTorch version.

No Pallas kernel to port: the JAX package computes ``einsum(x,
q.astype(bf16)) * s`` (``dots_ocr_tpu.models.layers.linear`` and
``unembed``) and XLA fuses the convert into the dot's operand read. The
plain version here is that function written as eager torch: it converts
the whole weight to x's dtype on every call, then takes cuBLAS's float32
sum. The kernel reads the int8 weight once and converts it on the way to
the tensor cores.

Two layouts of one function (the scale is float32, one per output column):

  * linear: x [M, K] . q [K, N] (``[in, out]``, N contiguous), the float32
    sum times ``scale[n]`` plus the optional bias, cast to x's dtype;
  * unembed: x [M, K] . q [N, K]^T (the tied embedding ``[vocab, d]``, K
    contiguous), the float32 sum times ``scale[n]``, float32.

int8 -> bf16 is exact, so kernel and plain version differ only in the
order of the float32 sums. The kernel computes the transposed product
out^T = q^T x^T with wgmma: the converted weight is built in registers as
the A operand and x's rows are wgmma's N. Two regimes, picked from the row
count alone (:func:`w8a16_plan`): up to DECODE_ROWS rows (decode and k = 2
verify steps) every row in one tile, so each weight byte is read once a
call; above it (prefill chunks) tiles of PREFILL_ROWS_TILE rows.

``w8a16_matmul`` runs the plain version for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from dots_ocr_tpu_torch.ops import kernel_lib

# The decode regime up to DECODE_ROWS rows: one tile of the smallest of
# ROW_TILES rows that holds them (wgmma's N; rows past M arrive as zeros).
# The prefill regime: PREFILL_ROWS_TILE-row tiles. A CTA has one or two
# consumer warpgroups, which share its tile by SPLITS: COLS columns each,
# or the same COLS columns with the contraction split between them. Its
# contraction's K_BLOCK-deep blocks are split over a cluster of up to
# MAX_CLUSTER ranks.
DECODE_ROWS = 192
ROW_TILES = (8, 16, 32, 64, 96, 128, 192)
PREFILL_ROWS_TILE = 128
COLS = 128
K_BLOCK = 64
K_MULTIPLE = 128
MAX_CLUSTER = 8
SPLITS = ("columns", "contraction")  # the kernel's Split, in order
# A contraction of LONG_BLOCKS blocks or more is split between a prefill
# CTA's two warpgroups; its 256-column CTAs take at most
# PREFILL_MAX_CLUSTER ranks.
LONG_BLOCKS = 64
PREFILL_MAX_CLUSTER = 4


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] as the float32 sum of the product.

    On CUDA a bf16 or fp16 product goes to cuBLAS with a float32 output
    (``torch.mm(..., out_dtype=torch.float32)``): no operand is upcast. On
    the CPU the operands are upcast (that build has no ``mm.dtype``
    kernel); a bf16 x bf16 product is exact in float32, so only the
    summation order differs.
    """
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def int8_linear_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          out_f32: bool = False) -> torch.Tensor:
    """The plain linear: x [..., K] . q [K, N] converted to x's dtype, the
    float32 sum times ``scale`` (+ bias), cast to x's dtype (float32 with
    ``out_f32``: an untied int8 lm_head)."""
    out = matmul_f32(x, q.to(x.dtype)) * scale
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out if out_f32 else out.to(x.dtype)


def int8_unembed_reference(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The plain unembed: x [..., K] . q [N, K]^T converted to x's dtype,
    the float32 sum times the per-row ``scale``, float32."""
    return matmul_f32(x, q.to(x.dtype).t()) * scale


class W8A16Plan(NamedTuple):
    """The kernel's launch: the regime ("decode": every row in one tile;
    "prefill": PREFILL_ROWS_TILE-row tiles), ``rows_tile`` rows of x a CTA
    (a multiple of 8), ``consumers`` warpgroups a CTA, which share the tile
    by ``split`` (one of SPLITS: COLS columns each, or the contraction of
    the same COLS columns), and the contraction over clusters of
    ``cluster`` ranks."""
    regime: str
    rows_tile: int
    consumers: int
    split: str
    cluster: int

    @property
    def cols_tile(self) -> int:
        return COLS * self.consumers if self.split == "columns" else COLS


def w8a16_plan(rows: int, in_dim: int, out_dim: int, num_sms: int,
               transposed: bool = False) -> W8A16Plan:
    """The regime and launch from static shapes only. Up to DECODE_ROWS
    rows one tile of the smallest of ROW_TILES rows that holds them, and a
    launch that depends on the weight's shape alone: one warpgroup a CTA,
    the contraction over the most cluster ranks (at most MAX_CLUSTER, at
    most one a block) whose CTAs fit one wave of one CTA an SM, at least
    one, then the fewest ranks with no longer share of the blocks. So a
    row's float32 sums are taken in one order at any decode row count: a
    request's greedy tokens do not depend on whether a step decodes or
    verifies, nor on the rows beside it. Above DECODE_ROWS,
    PREFILL_ROWS_TILE-row tiles: two warpgroups splitting the contraction of
    a [K, N] weight where it is long (LONG_BLOCKS blocks), over ranks of
    LONG_BLOCKS blocks; else two of 128 columns a CTA (x shared by 256
    columns) where N is a multiple of 256, over at most PREFILL_MAX_CLUSTER
    ranks that fit one wave; else one warpgroup.
    (kernel_ab.py's W8A16 sweep, one H100: the split wins at down, 140
    blocks, in the prefill regime; more prefill ranks than the wave needs
    lose to the reduction.)"""
    blocks = in_dim // K_BLOCK

    def ranks(tiles, most=MAX_CLUSTER):
        return _balanced(blocks, max(1, min(most, blocks, num_sms // tiles)))

    if rows <= DECODE_ROWS:
        tile = next(t for t in ROW_TILES if t >= rows)
        return W8A16Plan("decode", tile, 1, "columns", ranks(out_dim // COLS))
    row_tiles = -(-rows // PREFILL_ROWS_TILE)
    one = W8A16Plan("prefill", PREFILL_ROWS_TILE, 1, "columns", ranks(row_tiles * (out_dim // COLS)))
    if transposed:
        return one
    if blocks >= LONG_BLOCKS:
        return W8A16Plan("prefill", PREFILL_ROWS_TILE, 2, "contraction",
                         _balanced(blocks, blocks // LONG_BLOCKS))
    if out_dim % (2 * COLS):
        return one
    return W8A16Plan("prefill", PREFILL_ROWS_TILE, 2, "columns",
                     ranks(row_tiles * (out_dim // (2 * COLS)), PREFILL_MAX_CLUSTER))


def _balanced(units: int, ranks: int) -> int:
    """The fewest ranks (at least one) whose longest contiguous share of
    ``units`` is no longer than with ``ranks``."""
    per_rank = -(-units // max(1, ranks))
    return -(-units // per_rank)


def contraction_ranges(in_dim: int, cluster: int) -> list:
    """The contraction rows [start, end) of each rank of a cluster, in rank
    order (the kernel's ``kb0`` and ``nkb`` in K_BLOCK-deep blocks):
    contiguous, balanced, covering [0, in_dim)."""
    blocks = in_dim // K_BLOCK
    return [(r * blocks // cluster * K_BLOCK, (r + 1) * blocks // cluster * K_BLOCK)
            for r in range(cluster)]


def launch_grid(plan: W8A16Plan, rows: int, out_dim: int) -> tuple:
    """The kernel's grid (cluster ranks, column tiles, row tiles): the
    column tiles cover [0, out_dim) exactly, the row tiles every row."""
    return plan.cluster, out_dim // plan.cols_tile, -(-rows // plan.rows_tile)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"w8a16_matmul: {message}")


def _check(x, q, scale, bias, transposed: bool) -> None:
    """Raise on what the kernel does not take (the fast test first: it runs
    on every call)."""
    k = x.shape[-1]
    n = q.shape[0] if transposed else q.shape[-1]
    dev = x.device
    tensors = (x, q, scale) + (() if bias is None else (bias,))
    if (x.dtype == torch.bfloat16 and q.dtype == torch.int8 and scale.dtype == torch.float32
            and q.dim() == 2 and q.shape[1 if transposed else 0] == k
            and tuple(scale.shape) == (n,) and k % K_MULTIPLE == 0 and n % COLS == 0
            and (bias is None or (tuple(bias.shape) == (n,)
                                  and bias.dtype in (torch.float32, torch.bfloat16)))
            and all(t.device == dev and t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in tensors)):
        return
    _require(all(t.is_cuda and t.device == dev for t in tensors),
             "all inputs must be on x's CUDA device")
    _require(x.dtype == torch.bfloat16, f"x must be bfloat16, not {x.dtype}")
    _require(q.dtype == torch.int8 and scale.dtype == torch.float32,
             "q must be int8 and scale float32")
    _require(bias is None or bias.dtype in (torch.float32, torch.bfloat16),
             "bias must be float32 or bfloat16")
    _require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors),
             "inputs must be contiguous and 16-byte aligned")
    _require(k % K_MULTIPLE == 0, f"K {k} is not a multiple of {K_MULTIPLE}")
    _require(n % COLS == 0, f"N {n} is not a multiple of {COLS}")
    _require(False, f"q {tuple(q.shape)} / scale {tuple(scale.shape)} / bias "
                    f"{None if bias is None else tuple(bias.shape)} vs x {tuple(x.shape)} "
                    f"({'[N, K]' if transposed else '[K, N]'} layout)")


def w8a16_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, transposed: bool = False,
                 out_f32: bool = False) -> torch.Tensor:
    """x [..., K] against int8 q with its float32 per-column scale (module
    notes): q [K, N] (a linear; the sum times scale, + bias, in x's dtype,
    or float32 with ``out_f32``) or, ``transposed``, q [N, K] (an unembed:
    float32). On CUDA: bf16 x, K and N multiples of 128, every input
    contiguous on x's device (a layer's view of a stacked weight is taken
    as it is). Counts launches in ``w8a16_matmul.launches``, and by regime
    in ``decode_launches`` and ``prefill_launches``."""
    if x.device.type == "cpu":
        if transposed:
            return int8_unembed_reference(x, q, scale)
        return int8_linear_reference(x, q, scale, bias, out_f32)
    index = x.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return w8a16_matmul(x, q, scale, bias, transposed, out_f32)
    lead, k = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    _check(x2, q, scale, bias, transposed)
    n = q.shape[0] if transposed else q.shape[1]
    rows = x2.shape[0]
    f32 = out_f32 or transposed
    out = torch.empty(rows, n, dtype=torch.float32 if f32 else x.dtype, device=x.device)
    if rows:
        plan = _plan(rows, k, n, index, transposed)
        _launch(x2, q, scale, bias, out, transposed, f32, plan, index)
        w8a16_matmul.launches += 1
        if plan.regime == "decode":
            w8a16_matmul.decode_launches += 1
        else:
            w8a16_matmul.prefill_launches += 1
    return out.reshape(*lead, n)


def _launch(x, q, scale, bias, out, transposed: bool, out_f32: bool, plan: W8A16Plan,
            index: int) -> None:
    """One launch of the kernel at ``plan`` (checked inputs: ``x`` [M, K],
    ``out`` [M, N] allocated); raises if the launch is refused."""
    err = kernel_lib.load().dots_w8a16_matmul(
        x.data_ptr(), q.data_ptr(), scale.data_ptr(), 0 if bias is None else bias.data_ptr(),
        out.data_ptr(), x.shape[0], x.shape[1], out.shape[1], int(transposed), int(out_f32),
        int(bias is not None and bias.dtype == torch.bfloat16), plan.rows_tile, plan.consumers,
        SPLITS.index(plan.split), plan.cluster, torch._C._cuda_getCurrentRawStream(index))
    kernel_lib.check(err, "w8a16_matmul")


@functools.lru_cache(maxsize=None)
def _plan(rows: int, in_dim: int, out_dim: int, index: int, transposed: bool) -> W8A16Plan:
    num_sms = torch.cuda.get_device_properties(index).multi_processor_count
    return w8a16_plan(rows, in_dim, out_dim, num_sms, transposed)


w8a16_matmul.launches = 0
w8a16_matmul.decode_launches = 0
w8a16_matmul.prefill_launches = 0
