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
kernel tiles itself and takes any number of rows. Its W4A16 mode has two
regimes, picked from the row count alone (:func:`int4_regime`): a split
over the contraction at M <= SPLIT_ROWS (:func:`int4_split_plan`) and a
wgmma kernel above. Both add the same exact float32 group products as the
plain version in another order, so the plain version takes no split.

``int4_matmul`` runs the plain version for tensors on the CPU; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import functools
import os

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
    """The W4A16 kernel for ``rows`` rows: "split" (split-K) or "wgmma"."""
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
    ``int4_matmul.launches`` (W4A16) and ``int4_matmul.w4a8_launches``."""
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
        xq = torch.empty(rows, in_dim, dtype=torch.int8, device=x.device)
        a_scale = torch.empty(rows, dtype=torch.float32, device=x.device)
        err = lib.dots_int4_matmul_w4a8(
            x.data_ptr(), packed.data_ptr(), scales.data_ptr(), xq.data_ptr(),
            a_scale.data_ptr(), out.data_ptr(), rows, in_dim, out_dim, stream)
    else:
        per_split, n_split = _w4a16_plan(rows, in_dim, out_dim, index)
        err = _w4a16_launch(lib, x, packed, scales, out, per_split, n_split, stream)
    kernel_lib.check(err, "int4_matmul")
    if act_quant:
        int4_matmul.w4a8_launches += 1
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


int4_matmul.launches = 0
int4_matmul.w4a8_launches = 0


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


def int4_linear(x: torch.Tensor, kernel: dict, impl: str = "kernel") -> torch.Tensor:
    """``layers.linear``'s entry for ``{"qint4", "scale4"}`` kernels: x
    [..., in] -> [..., out] in x's dtype. ``DOTS_INT4_ACT=1`` (read at each
    call) selects W4A8, as in the JAX package."""
    act_quant = os.environ.get("DOTS_INT4_ACT", "0") == "1"
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    out = IMPLEMENTATIONS[impl](x2, kernel["qint4"], kernel["scale4"], act_quant)
    return out.reshape(*x.shape[:-1], out.shape[-1])
