"""The seeded Gumbel-max draw: threefry2x32 bits, Gumbel noise and the
argmax over a row, as ``jax.random.categorical`` computes them, in one
hand-written Hopper kernel (``csrc/threefry_sample.cu``) and its plain
PyTorch version.

The kernel has no Pallas counterpart. On the TPU, XLA fuses threefry and
the Gumbel-max reduction into the sampling program
(``dots_ocr_tpu.engine.sampling._categorical``); written as eager torch
ops over [64, 151,936] logits the same draw is over a hundred elementwise
passes of ~78 MB each, every decode step. One launch computes, for each
(row, column), the threefry bits from the row's key (or from one shared
key, with the flat index as the counter), the uniform and the Gumbel noise,
adds it to the logit (divided by the row's temperature when one is given),
and reduces each row to its argmax: ties to the lowest index, as
``jnp.argmax``; ``-inf`` never wins over a finite value and a row of only
``-inf`` gives 0.

Bit-exact with ``jax.random`` under ``jax_threefry_partitionable=True``:
a draw of shape (B, V) from one key counts over the flat index; a per-row
key (``vmap``) counts over the column. Everything is uint32 arithmetic,
done here in int64 with 32-bit masks (torch's uint32 lacks ops on some
backends).

The wrapper runs the plain version only for tensors on the CPU. A CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dots_ocr_tpu_torch.ops import kernel_lib

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
FLOAT32_TINY = float(torch.finfo(torch.float32).tiny)
# Columns a block of the kernel's first pass covers (blocks per row =
# ceil(V / this); csrc/threefry_sample.cu's COLS_PER_BLOCK).
COLS_PER_BLOCK = 8192


def threefry2x32(k0, k1, x0, x1):
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


def random_bits(keys: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words ``jax.random.bits(key, (n,))``: keys [..., 2]
    int64 -> [..., n] int64. A draw of shape (B, V) from ONE key is
    ``random_bits(key, B * V).reshape(B, V)`` (the counter runs over the
    flat index); per-row keys [B, 2] give ``vmap``'s per-row draws."""
    idx = torch.arange(n, dtype=torch.int64, device=keys.device)
    y0, y1 = threefry2x32(keys[..., 0:1], keys[..., 1:2], idx >> 32, idx & MASK32)
    return y0 ^ y1


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


def _draw_bits(keys: torch.Tensor, batch: int, n: int) -> torch.Tensor:
    """[batch, n] bits of a categorical draw over rows of n: one shared key
    [2] counts over the flat index, per-row keys [batch, 2] over the column."""
    if keys.dim() == 1:
        return random_bits(keys, batch * n).reshape(batch, n)
    return random_bits(keys, n)


def gumbel_noise(keys: torch.Tensor, batch: int, n: int) -> torch.Tensor:
    """The Gumbel noise [batch, n] float32 of :func:`gumbel_argmax`."""
    return bits_to_gumbel(_draw_bits(keys, batch, n))


def gumbel_argmax_reference(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`gumbel_argmax`:
    ``jax.random.categorical(key, logits / temperature[:, None])``."""
    b, n = logits.shape
    scaled = logits if temperature is None else logits / temperature[:, None]
    return torch.argmax(gumbel_noise(keys, b, n) + scaled, dim=-1)


def _require(cond: bool, message: str) -> None:
    if not cond:
        raise ValueError(f"gumbel_argmax: {message}")


def _as_int32_words(keys: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(keys >= 2**31, keys - 2**32, keys).to(torch.int32).contiguous()


def gumbel_argmax(
    logits: torch.Tensor,
    keys: torch.Tensor,
    temperature: Optional[torch.Tensor] = None,
    noise_out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Seeded Gumbel-max draw over the last axis: [B] int64 tokens.

    logits [B, V] float32; keys int64 uint32 words, [2] (one key shared by
    every row: the counter is the flat index) or [B, 2] (a key per row: the
    counter is the column); temperature [B] float32 (> 0) divides each row
    first, or None. ``noise_out`` [B, V] float32 receives the Gumbel noise
    (the kernel's check against its plain version; CUDA only).
    """
    if logits.device.type == "cpu":
        return gumbel_argmax_reference(logits, keys, temperature)
    b, v = logits.shape
    _require(logits.is_cuda and logits.dtype == torch.float32 and logits.is_contiguous(),
             "logits must be contiguous float32 on CUDA")
    _require(keys.device == logits.device and keys.dtype == torch.int64,
             "keys must be int64 on logits' device")
    per_row = keys.dim() == 2
    _require(tuple(keys.shape) == ((b, 2) if per_row else (2,)),
             f"keys shape {tuple(keys.shape)} for {b} rows")
    _require(b * v < 2**32, "the flat counter must fit 32 bits")
    if temperature is not None:
        _require(temperature.device == logits.device and temperature.dtype == torch.float32
                 and tuple(temperature.shape) == (b,), "temperature must be [B] float32")
        temperature = temperature.contiguous()
    if noise_out is not None:
        _require(noise_out.device == logits.device and noise_out.dtype == torch.float32
                 and tuple(noise_out.shape) == (b, v) and noise_out.is_contiguous(),
                 "noise_out must be contiguous [B, V] float32")
    blocks = -(-v // COLS_PER_BLOCK)
    part_val = torch.empty((b, blocks), dtype=torch.float32, device=logits.device)
    part_idx = torch.empty((b, blocks), dtype=torch.int32, device=logits.device)
    out = torch.empty(b, dtype=torch.int64, device=logits.device)
    words = _as_int32_words(keys)
    with torch.cuda.device(logits.device):
        err = kernel_lib.load().dots_threefry_gumbel_argmax(
            logits.data_ptr(), 0 if temperature is None else temperature.data_ptr(),
            words.data_ptr(), 0 if noise_out is None else noise_out.data_ptr(),
            part_val.data_ptr(), part_idx.data_ptr(), out.data_ptr(),
            b, v, int(per_row), blocks, torch.cuda.current_stream().cuda_stream,
        )
    kernel_lib.check(err, "gumbel_argmax")
    gumbel_argmax.launches += 1
    return out


gumbel_argmax.launches = 0
