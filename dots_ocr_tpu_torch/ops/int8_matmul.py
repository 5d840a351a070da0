"""W8A16 matmul: bf16 activations against int8 weight-only weights, the
hand-written Hopper kernel (``csrc/int8_matmul.cu``) and its plain PyTorch
version.

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
order of the float32 sums. Two regimes, picked from the row count alone
(:func:`w8a16_plan`): up to SPLIT_ROWS rows (decode and k = 2 verify steps)
an mma.sync kernel whose contraction is split over the ranks of a thread
block cluster, above it a wgmma kernel (prefill chunks).

``w8a16_matmul`` runs the plain version for tensors on the CPU; a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from dots_ocr_tpu_torch.ops import kernel_lib

# Regime (a) up to SPLIT_ROWS rows: CTAs of a ROW_TILES-row x SPLIT_COLS
# tile (the smallest tile that holds the rows, or a smaller one where the
# shape has too few tiles for half the card), the contraction's units
# (SPLIT_UNIT rows: [K, N] 64, [N, K] 128) split over clusters of up to
# MAX_CLUSTER ranks, the fewest ranks that give CTAS_PER_SM CTAs an SM.
# Regime (b): 128 x 128 wgmma tiles, the contraction's K_MULTIPLE-wide
# blocks split over clusters of up to MAX_CLUSTER ranks where the tiles
# give fewer than WGMMA_CTAS_PER_SM CTAs an SM (one CTA fits an SM).
SPLIT_ROWS = 192
ROW_TILES = (16, 32, 64)
SPLIT_COLS = 128
SPLIT_UNIT = {False: 64, True: 128}  # by ``transposed`` ([N, K])
MAX_CLUSTER = 8
CTAS_PER_SM = 2
WGMMA_ROWS, WGMMA_CTAS_PER_SM = 128, 2
K_MULTIPLE = 128


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
    """The kernel's launch: ``rows_tile`` rows a CTA of the split regime, or
    0 for the wgmma regime, either with clusters of ``cluster`` ranks over
    the contraction."""
    rows_tile: int
    cluster: int

    @property
    def regime(self) -> str:
        return "wgmma" if self.rows_tile == 0 else "split"


def w8a16_plan(rows: int, in_dim: int, out_dim: int, num_sms: int,
               transposed: bool = False) -> W8A16Plan:
    """The regime and launch from static shapes only: above SPLIT_ROWS rows
    the wgmma kernel, its contraction split over the fewest cluster ranks
    that give WGMMA_CTAS_PER_SM CTAs an SM (at most MAX_CLUSTER, at most one
    a block). Up to it: the smallest row tile that holds the rows,
    halved (down to the smallest) while the largest clusters would leave
    half the SMs without a CTA; then the fewest cluster ranks (at most
    MAX_CLUSTER, at most one a unit) that give CTAS_PER_SM CTAs an SM, and
    of those ranks' longest share of the units, the fewest ranks that
    need no more.
    (kernel_ab.py's W8A16 sweep: a 64-row tile over 8 ranks beats 32 rows
    for wq / wo and down at 64 rows, 96 CTAs against 192; wk / wv, with 2
    column tiles, gains from 16-row tiles.)"""
    if rows > SPLIT_ROWS:
        blocks = in_dim // K_MULTIPLE
        tiles = -(-rows // WGMMA_ROWS) * (out_dim // SPLIT_COLS)
        return W8A16Plan(0, _balanced(
            blocks, min(MAX_CLUSTER, blocks, -(-WGMMA_CTAS_PER_SM * num_sms // tiles))))
    units = in_dim // SPLIT_UNIT[transposed]
    most = min(MAX_CLUSTER, units)

    def tiles(tile):
        return -(-rows // tile) * (out_dim // SPLIT_COLS)

    tile = next((t for t in ROW_TILES if rows <= t), ROW_TILES[-1])
    while tile > ROW_TILES[0] and 2 * tiles(tile) * most < num_sms:
        tile //= 2
    cluster = min(most, -(-CTAS_PER_SM * num_sms // tiles(tile)))
    return W8A16Plan(tile, _balanced(units, cluster))


def _balanced(units: int, ranks: int) -> int:
    """The fewest ranks (at least one) whose longest contiguous share of
    ``units`` is no longer than with ``ranks``."""
    per_rank = -(-units // max(1, ranks))
    return -(-units // per_rank)


def unit_ranges(in_dim: int, cluster: int, transposed: bool = False) -> list:
    """The contraction units [start, end) of each rank of a cluster (the
    kernel's ``u0`` and ``steps``): contiguous, balanced, in rank order."""
    units = in_dim // SPLIT_UNIT[transposed]
    return [(r * units // cluster, (r + 1) * units // cluster) for r in range(cluster)]


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
            and tuple(scale.shape) == (n,) and k % K_MULTIPLE == 0 and n % SPLIT_COLS == 0
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
    _require(n % SPLIT_COLS == 0, f"N {n} is not a multiple of {SPLIT_COLS}")
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
    in ``split_launches`` and ``wgmma_launches``."""
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
        err = kernel_lib.load().dots_w8a16_matmul(
            x2.data_ptr(), q.data_ptr(), scale.data_ptr(),
            0 if bias is None else bias.data_ptr(), out.data_ptr(), rows, k, n, int(transposed),
            int(f32), int(bias is not None and bias.dtype == torch.bfloat16), plan.rows_tile,
            plan.cluster, torch._C._cuda_getCurrentRawStream(index))
        kernel_lib.check(err, "w8a16_matmul")
        w8a16_matmul.launches += 1
        if plan.regime == "split":
            w8a16_matmul.split_launches += 1
        else:
            w8a16_matmul.wgmma_launches += 1
    return out.reshape(*lead, n)


@functools.lru_cache(maxsize=None)
def _plan(rows: int, in_dim: int, out_dim: int, index: int, transposed: bool) -> W8A16Plan:
    num_sms = torch.cuda.get_device_properties(index).multi_processor_count
    return w8a16_plan(rows, in_dim, out_dim, num_sms, transposed)


w8a16_matmul.launches = 0
w8a16_matmul.split_launches = 0
w8a16_matmul.wgmma_launches = 0
