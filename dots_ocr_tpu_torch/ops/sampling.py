"""Seeded sampling on the card: threefry2x32 over a grid of (key, counter)
words, and the Gumbel-max draw (threefry bits, Gumbel noise and the argmax
over a row, as ``jax.random.categorical`` computes them) with its rows' key
derivation, each in one launch of a hand-written Hopper kernel
(``csrc/threefry_sample.cu``), beside their plain PyTorch versions.

Neither kernel has a Pallas counterpart. On the TPU, XLA fuses threefry
and the Gumbel-max reduction into the sampling program
(``dots_ocr_tpu.engine.sampling._categorical``); written as eager torch
ops, one ``fold_in`` is ~150 int64 elementwise operations and a draw over
[64, 151,936] logits over a hundred passes of ~78 MB each, every decode
step.

* :func:`threefry_grid` applies threefry2x32 to operands that broadcast to
  one grid (each an int64 tensor holding uint32 values, or an int), with an
  optional counter along the last axis, and returns the two words, their
  xor, or ``jax.random.uniform``'s float from it. ``fold_in``, ``split``,
  ``random_bits`` and ``uniform`` are each one launch of it.
* :func:`gumbel_argmax` computes, for each (row, column), the threefry bits
  from the row's key (or from one shared key, with the flat index as the
  counter), the uniform and the Gumbel noise, adds it to the logit
  (divided by the row's temperature when one is given), and reduces each
  row to its argmax: ties to the lowest index, as ``jnp.argmax``; ``-inf``
  never wins over a finite value and a row of only ``-inf`` gives 0. With
  ``positions`` and ``tag`` it derives the row keys itself,
  ``fold_in(fold_in(key, position), tag)``, in the kernel's prologue.

Bit-exact with ``jax.random`` under ``jax_threefry_partitionable=True``:
a draw of shape (B, V) from one key counts over the flat index; a per-row
key (``vmap``) counts over the column. Everything is uint32 arithmetic,
done here in int64 with 32-bit masks (torch's uint32 lacks ops on some
backends); the kernels read the low 32 bits of each int64 word.

The wrappers run the plain versions only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from dots_ocr_tpu_torch.ops import kernel_lib

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)
# The threefry entry's outputs: the two words [..., 2], their xor, or the
# uniform float32 from the xor.
WORDS, BITS, UNIFORM = 0, 1, 2
# The draw kernel's plan (csrc/threefry_sample.cu): CTAs of DRAW_THREADS, a
# row split over a cluster of up to DRAW_MAX_CLUSTER ranks, as many as give
# every SM DRAW_CTAS_PER_SM CTAs and at most one a DRAW_THREADS columns
# (kernel_ab.py's draw sweep: at 64 rows 2 ranks beat 4 and 8).
DRAW_THREADS = 512
DRAW_CTAS_PER_SM = 1
DRAW_MAX_CLUSTER = 8


def threefry2x32_reference(k0, k1, x0, x1):
    """The threefry2x32 block cipher (20 rounds), as ``jax.random`` runs it.
    Key words k0/k1 and counter words x0/x1 are int64 tensors (or ints)
    holding uint32 values; they broadcast. Returns the two output words."""
    m = MASK32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & m
    x1 = (x1 + ks[1]) & m
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x0 = (x0 + x1) & m
            x1 = ((x1 << rot) | (x1 >> (32 - rot))) & m
            x1 = x0 ^ x1
        x0 = (x0 + ks[(r + 1) % 3]) & m
        x1 = (x1 + ks[(r + 2) % 3] + r + 1) & m
    return x0, x1


def bits_to_uniform(bits: torch.Tensor, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(minval=minval, maxval=1)`` from its bits: the
    top 23 bits as a mantissa in [1, 2), minus 1, scaled and shifted in
    float32, and clamped below at minval."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.full((), minval, dtype=torch.float32, device=bits.device)
    span = torch.full((), 1.0, dtype=torch.float32, device=bits.device) - lo
    return torch.maximum(lo, mant * span + lo)


def bits_to_gumbel(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") from its bits."""
    return -torch.log(-torch.log(bits_to_uniform(bits, FLOAT32_TINY)))


def _device(*operands) -> torch.device:
    return next(t.device for t in operands if isinstance(t, torch.Tensor))


def threefry_grid_reference(k0, k1, x0, x1, iota_cols: Optional[int] = None,
                            mode: int = WORDS, minval: float = 0.0) -> torch.Tensor:
    """Plain version of :func:`threefry_grid` (on any device)."""
    k0, k1, x0, x1 = (op & MASK32 for op in (k0, k1, x0, x1))
    if iota_cols is not None:
        idx = torch.arange(iota_cols, dtype=torch.int64, device=_device(k0, k1, x0, x1))
        ctr = ((x0 << 32) | x1) + idx  # the 64-bit counter, modulo 2^64
        x0, x1 = (ctr >> 32) & MASK32, ctr & MASK32
    y0, y1 = threefry2x32_reference(k0, k1, x0, x1)
    if mode == WORDS:
        return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)
    bits = y0 ^ y1
    return bits if mode == BITS else bits_to_uniform(bits, minval)


def _require(cond: bool, name: str, message: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {message}")


def threefry_grid(k0, k1, x0, x1, iota_cols: Optional[int] = None, mode: int = WORDS,
                  minval: float = 0.0) -> torch.Tensor:
    """threefry2x32 of key words (k0, k1) and counter words (x0, x1), each an
    int64 tensor holding uint32 values (the low 32 bits are taken) or an
    int, broadcast to one grid. With ``iota_cols`` the grid gets a last axis
    of that many columns and column c counts c past the 64-bit counter (x0,
    x1). ``mode`` WORDS gives int64 [..., 2] (the two words), BITS int64
    (their xor), UNIFORM float32 (``jax.random.uniform`` on [minval, 1)
    from the xor). One launch on the card; counts ``threefry_grid.launches``."""
    dev = _device(k0, k1, x0, x1)
    if dev.type == "cpu":
        return threefry_grid_reference(k0, k1, x0, x1, iota_cols, mode, minval)
    tensors = [op for op in (k0, k1, x0, x1) if isinstance(op, torch.Tensor)]
    _require(all(t.device == dev and t.dtype == torch.int64 for t in tensors), "threefry_grid",
             "tensor operands must be int64 on one CUDA device")
    shape = torch.broadcast_shapes(*(t.shape for t in tensors),
                                   *(() if iota_cols is None else ((iota_cols,),)))
    cols = shape[-1] if shape else 1
    rows = (shape[:-1].numel() if shape else 1) if cols else 0
    desc, grids = [], []  # grids: the operands' [rows, cols] tensors, alive until the launch
    for op in (k0, k1, x0, x1):
        if isinstance(op, torch.Tensor):
            grids.append(op.broadcast_to(shape).reshape(rows, cols))  # a copy where strides need one
            desc += [grids[-1].data_ptr(), grids[-1].stride(0), grids[-1].stride(1), 0]
        else:
            desc += [0, 0, 0, int(op) & MASK32]
    out = torch.empty(*shape, *((2,) if mode == WORDS else ()), device=dev,
                      dtype=torch.float32 if mode == UNIFORM else torch.int64)
    if rows * cols == 0:
        return out
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return threefry_grid(k0, k1, x0, x1, iota_cols, mode, minval)
    operands = (ctypes.c_longlong * 16)(*desc)
    err = kernel_lib.load().dots_threefry2x32(
        ctypes.addressof(operands), out.data_ptr(), rows, cols, int(iota_cols is not None), mode,
        minval, torch._C._cuda_getCurrentRawStream(dev.index))
    kernel_lib.check(err, "threefry_grid")
    threefry_grid.launches += 1
    return out


threefry_grid.launches = 0


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on keys [..., 2] with data (an int, or an
    integer tensor broadcasting against keys[..., 0]) taken mod 2^32. An int
    is a kernel argument: no host copy, so a CUDA graph can hold it."""
    if not isinstance(data, int):
        data = torch.as_tensor(data, device=keys.device)
        if data.dtype != torch.int64:
            data = data.to(torch.int64)
    return threefry_grid(keys[..., 0], keys[..., 1], 0, data)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2]: subkey i is threefry of
    the counter (0, i) (the partitionable split, equal to fold_in(key, i))."""
    return threefry_grid(key[0], key[1], 0, 0, iota_cols=num)


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words ``jax.random.bits(key, (n,))``: keys [..., 2]
    int64 -> [..., n] int64. A draw of shape (B, V) from ONE key is
    ``random_bits(key, B * V).reshape(B, V)`` (the counter runs over the
    flat index); per-row keys [B, 2] give ``vmap``'s per-row draws."""
    return threefry_grid(keys[..., 0:1], keys[..., 1:2], 0, 0, iota_cols=n, mode=BITS)


def uniform(keys: torch.Tensor, n: int, minval: float = 0.0) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), minval=minval)`` per key: keys
    [..., 2] -> [..., n] float32."""
    return threefry_grid(keys[..., 0:1], keys[..., 1:2], 0, 0, iota_cols=n, mode=UNIFORM,
                         minval=minval)


def fold_keys_reference(keys: torch.Tensor, positions: Optional[torch.Tensor] = None,
                        tag: Optional[int] = None) -> torch.Tensor:
    """The draw's row keys in plain torch: ``fold_in(keys, positions)`` when
    positions are given, then ``fold_in(that, tag)`` when a tag is."""
    if positions is not None:
        keys = threefry_grid_reference(keys[..., 0], keys[..., 1], 0, positions.to(torch.int64))
    if tag is not None:
        keys = threefry_grid_reference(keys[..., 0], keys[..., 1], 0, tag)
    return keys


def gumbel_noise(keys: torch.Tensor, batch: int, n: int) -> torch.Tensor:
    """The Gumbel noise [batch, n] float32 of :func:`gumbel_argmax`, in plain
    torch: one shared key [2] counts over the flat index, per-row keys
    [batch, 2] over the column."""
    if keys.dim() == 1:
        bits = threefry_grid_reference(keys[0:1], keys[1:2], 0, 0, batch * n, BITS)
        return bits_to_gumbel(bits.reshape(batch, n))
    return bits_to_gumbel(threefry_grid_reference(keys[..., 0:1], keys[..., 1:2], 0, 0, n, BITS))


def gumbel_argmax_reference(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    tag: Optional[int] = None,
) -> torch.Tensor:
    """Plain version of :func:`gumbel_argmax`: ``jax.random.categorical(key,
    logits / temperature[:, None])`` under the row keys of
    :func:`fold_keys_reference`."""
    b, n = logits.shape
    keys = fold_keys_reference(keys, positions, tag)
    scaled = logits if temperature is None else logits / temperature[:, None]
    return torch.argmax(gumbel_noise(keys, b, n) + scaled, dim=-1)


def draw_plan(rows: int, cols: int, num_sms: int) -> int:
    """The draw kernel's cluster size: the ranks a row is split over, as
    many as one wave of DRAW_CTAS_PER_SM CTAs an SM holds for ``rows`` rows,
    at most DRAW_MAX_CLUSTER and at most one a DRAW_THREADS columns."""
    return max(1, min(DRAW_MAX_CLUSTER, DRAW_CTAS_PER_SM * num_sms // rows,
                      -(-cols // DRAW_THREADS)))


@functools.lru_cache(maxsize=None)
def _draw_plan(rows: int, cols: int, index: int) -> int:
    return draw_plan(rows, cols, torch.cuda.get_device_properties(index).multi_processor_count)


def gumbel_argmax(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: Optional[torch.Tensor] = None,
    noise_out: Optional[torch.Tensor] = None,
    positions: Optional[torch.Tensor] = None,
    tag: Optional[int] = None,
) -> torch.Tensor:
    """Seeded Gumbel-max draw over the last axis: [B] int64 tokens.

    logits [B, V] float32; keys int64 uint32 words, [2] (one key shared by
    every row: the counter is the flat index) or [B, 2] (a key per row: the
    counter is the column); ``positions`` [B] integers: row b draws under
    ``fold_in(key, positions[b])`` (per-row draws, counted over the
    column); ``tag``: then under ``fold_in(that, tag)``. Both folds run in
    the kernel. temperature [B] float32 (> 0) divides each row first, or
    None. ``noise_out`` [B, V] float32 receives the Gumbel noise (the
    kernel's check against its plain version; CUDA only).
    """
    if logits.device.type == "cpu":
        return gumbel_argmax_reference(logits, keys, temperature, positions, tag)
    name = "gumbel_argmax"
    b, v = logits.shape
    _require(logits.is_cuda and logits.dtype == torch.float32 and logits.is_contiguous(), name,
             "logits must be contiguous float32 on CUDA")
    _require(keys.device == logits.device and keys.dtype == torch.int64
             and keys.is_contiguous(), name, "keys must be contiguous int64 on logits' device")
    per_row = keys.dim() == 2
    _require(tuple(keys.shape) == ((b, 2) if per_row else (2,)), name,
             f"keys shape {tuple(keys.shape)} for {b} rows")
    if positions is not None:
        _require(positions.device == logits.device and tuple(positions.shape) == (b,), name,
                 "positions must be [B] on logits' device")
        if positions.dtype != torch.int64 or not positions.is_contiguous():
            positions = positions.to(torch.int64).contiguous()
    flat = not per_row and positions is None
    _require(not flat or b * v < 2**32, name, "the flat counter must fit 32 bits")
    _require(tag is None or 0 <= tag <= MASK32 // 2, name, f"tag {tag} out of range")
    if temperature is not None:
        _require(temperature.device == logits.device and temperature.dtype == torch.float32
                 and tuple(temperature.shape) == (b,), name, "temperature must be [B] float32")
        temperature = temperature.contiguous()
    if noise_out is not None:
        _require(noise_out.device == logits.device and noise_out.dtype == torch.float32
                 and tuple(noise_out.shape) == (b, v) and noise_out.is_contiguous(), name,
                 "noise_out must be contiguous [B, V] float32")
    index = logits.device.index
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return gumbel_argmax(logits, keys, temperature, noise_out, positions, tag)
    out = torch.empty(b, dtype=torch.int64, device=logits.device)
    err = kernel_lib.load().dots_threefry_gumbel_argmax(
        logits.data_ptr(), 0 if temperature is None else temperature.data_ptr(),
        keys.data_ptr(), 2 if per_row else 0, 0 if positions is None else positions.data_ptr(),
        -1 if tag is None else tag, int(flat), 0 if noise_out is None else noise_out.data_ptr(),
        out.data_ptr(), b, v, _draw_plan(b, v, index), torch._C._cuda_getCurrentRawStream(index))
    kernel_lib.check(err, name)
    gumbel_argmax.launches += 1
    return out


gumbel_argmax.launches = 0
