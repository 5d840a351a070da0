"""Rotary position embeddings: 1D (decoder) and 2D (vision grids).

Rotate-half layout (Qwen/Llama): the head dim splits into two halves,
(x1, x2) -> (x1*cos - x2*sin, x2*cos + x1*sin), frequencies repeated over
both halves. In 2D, the first half of the frequency bins encode the patch
row and the second half the column.

``token_order``, ``vision_grid_positions`` and ``vision_rope_table`` are
numpy copies of the JAX package's host helpers (``dots_ocr_tpu.models.rope``
imports jax).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    return 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim)
    )


@functools.lru_cache(maxsize=None)
def _inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """:func:`rope_freqs` on ``device``, uploaded once: a decode step that
    is captured in a CUDA graph must not copy from the host."""
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def rope_table(
    positions: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 tables of shape [..., head_dim] for integer
    positions [...]."""
    inv_freq = _inv_freq(head_dim, theta, positions.device)
    angles = positions.to(torch.float32)[..., None] * inv_freq
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)


def yarn_inv_freq(dim: int, theta: float, yarn) -> np.ndarray:
    """DeepSeek's YaRN inverse frequencies ([dim // 2] float32,
    ``DeepseekV3YarnRotaryEmbedding``): below the correction range the
    original frequencies, above it those divided by ``factor``, a linear
    ramp between; the range is where ``beta_fast`` .. ``beta_slow``
    rotations fit ``original_max_position_embeddings``."""
    base = theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim)
    extra, inter = 1.0 / base, 1.0 / (yarn.factor * base)

    def correction_dim(rotations: float) -> float:
        return (dim * math.log(yarn.original_max_position_embeddings
                               / (rotations * 2 * math.pi))) / (2 * math.log(theta))

    low = max(math.floor(correction_dim(yarn.beta_fast)), 0)
    high = min(math.ceil(correction_dim(yarn.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = np.clip((np.arange(dim // 2, dtype=np.float32) - low) / (high - low), 0, 1)
    extra_mask = 1.0 - ramp
    return (inter * (1 - extra_mask) + extra * extra_mask).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _yarn_inv_freq(dim: int, theta: float, yarn, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(yarn_inv_freq(dim, theta, yarn)).to(device)


def yarn_rope_table(positions: torch.Tensor, dim: int, theta: float,
                    yarn) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 [..., dim] of DeepSeek's YaRN rope at integer
    positions, both times mscale(factor, mscale) / mscale(factor,
    mscale_all_dim) (1 where the two are equal). ``yarn`` None: plain rope."""
    if yarn is None:
        return rope_table(positions, dim, theta)
    from dots_ocr_tpu_torch.models.config import yarn_get_mscale

    angles = positions.to(torch.float32)[..., None] * _yarn_inv_freq(dim, theta, yarn,
                                                                      positions.device)
    angles = torch.cat([angles, angles], dim=-1)
    m = yarn_get_mscale(yarn.factor, yarn.mscale) / yarn_get_mscale(yarn.factor,
                                                                   yarn.mscale_all_dim)
    return torch.cos(angles) * m, torch.sin(angles) * m


def apply_rope_interleaved(x: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """DeepSeek's rope on interleaved pairs: x [..., D] is reordered from
    (x0, x1, x2, x3, ..) to (x0, x2, .., x1, x3, ..) and then rotated
    half against half. cos / sin broadcast against x. Computes in float32,
    returns x.dtype (in the reordered layout, as DeepSeek's code leaves it)."""
    d = x.shape[-1]
    xf = x.to(torch.float32).unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
) -> torch.Tensor:
    """Rotate q or k. x: [..., seq, heads, head_dim]; cos/sin: [..., seq,
    head_dim]. Computes in float32, returns x.dtype."""
    cos = cos[..., None, :]  # heads axis before head_dim
    sin = sin[..., None, :]
    xf = x.to(torch.float32)
    return (xf * cos + rotate_half(xf) * sin).to(x.dtype)


def token_order(
    grid_h: int, grid_w: int, merge: int = 2, window: int = 0,
    pad_windows: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Emission order of a grid's raw patches + per-token window ids.

    Each merge x merge block is contiguous (row-major inside), so merged
    token j owns raw patches [merge^2 * j, merge^2 * (j+1)). Blocks are
    row-major over the merged grid when window == 0, or within each window
    (windows row-major) when window > 0. ``pad_windows`` pads edge windows
    to window^2 entries with perm = -1.

    Returns (perm, window_ids): ``perm[t]`` is the row-major patch index
    emitted at position t (-1 = window padding).
    """
    if window == 0:
        window = max(
            ((grid_h + merge - 1) // merge) * merge,
            ((grid_w + merge - 1) // merge) * merge,
        )
        pad_windows = False
    if window % merge:
        raise ValueError(f"window {window} is not a multiple of merge {merge}")

    hp = -(-grid_h // window) * window
    wp = -(-grid_w // window) * window
    ids = np.full((hp, wp), -1, np.int64)
    ids[:grid_h, :grid_w] = np.arange(grid_h * grid_w, dtype=np.int64).reshape(
        grid_h, grid_w
    )
    nwr, nwc = hp // window, wp // window
    wb = window // merge
    blocks = (
        ids.reshape(nwr, window, nwc, window)
        .transpose(0, 2, 1, 3)
        .reshape(nwr * nwc, wb, merge, wb, merge)
        .transpose(0, 1, 3, 2, 4)
        .reshape(nwr * nwc, window * window)
    )
    window_ids = np.broadcast_to(
        np.arange(nwr * nwc, dtype=np.int32)[:, None], blocks.shape
    )
    perm = blocks.reshape(-1)
    window_ids = window_ids.reshape(-1)
    if not pad_windows:
        keep = perm >= 0
        perm = perm[keep]
        window_ids = np.ascontiguousarray(window_ids[keep])
    return perm, window_ids


def vision_grid_positions(
    grid_h: int, grid_w: int, merge: int = 2, window: int = 0,
    pad_windows: bool = False,
) -> np.ndarray:
    """(row, col) pairs of a grid's patches in emission order (window
    padding gets (0, 0)). Shape [num_emitted, 2], int32."""
    perm, _ = token_order(
        grid_h, grid_w, merge=merge, window=window, pad_windows=pad_windows
    )
    safe = np.maximum(perm, 0)
    rows = (safe // grid_w).astype(np.int32)
    cols = (safe % grid_w).astype(np.int32)
    rows[perm < 0] = 0
    cols[perm < 0] = 0
    return np.stack([rows, cols], axis=-1)


def vision_rope_table(
    positions_2d: np.ndarray, head_dim: int, theta: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Host (cos, sin) for 2D positions [T, 2], each [T, head_dim] float32:
    the first half of the head_dim // 2 frequency bins encode the row, the
    second half the column (rotate-half)."""
    inv_freq = rope_freqs(head_dim // 2, theta)  # [head_dim // 4]
    rows = positions_2d[:, 0].astype(np.float32)
    cols = positions_2d[:, 1].astype(np.float32)
    angles = np.concatenate([rows[:, None] * inv_freq, cols[:, None] * inv_freq], axis=-1)
    angles = np.concatenate([angles, angles], axis=-1)  # [T, head_dim]
    return np.cos(angles), np.sin(angles)


def vision_rope_device(
    pos2d: torch.Tensor, head_dim: int, theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """2D-RoPE (cos, sin), each [T, head_dim] float32, computed on the
    device of the [T, 2] int32 positions."""
    inv_freq = torch.from_numpy(rope_freqs(head_dim // 2, theta)).to(pos2d.device)
    rows = pos2d[:, 0].to(torch.float32)
    cols = pos2d[:, 1].to(torch.float32)
    angles = torch.cat(
        [rows[:, None] * inv_freq, cols[:, None] * inv_freq], dim=-1
    )
    angles = torch.cat([angles, angles], dim=-1)
    return torch.cos(angles), torch.sin(angles)
