"""Host-side vision preprocessing: images -> packed uint8 patches + metadata.

A numpy copy of ``dots_ocr_tpu.models.preprocess`` (which imports jax
through its config module): patches in merge-contiguous order, [T, 2] int32
2D positions, per-token segment ids (-1 = padding), the token axis padded
to a bucket. With ``cfg.window_size > 0`` the packing is window-major:
every window is padded to exactly ``window_size^2`` tokens (zero patches,
segment id -1), ``window_ids`` is carried, and the bucket is a multiple of
``window_size^2`` so the windowed layers reshape the token axis into
[num_windows, window_size^2]. The im2col runs in the port's C++
patchifier (``native/``) when a host compiler exists, else in numpy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from dots_ocr_tpu_torch.models.config import VisionConfig
from dots_ocr_tpu_torch.models.rope import token_order, vision_grid_positions
from dots_ocr_tpu_torch.native import patchify_native


@dataclass
class PackedVisionInput:
    """Packed vision batch (host numpy)."""

    patches: np.ndarray        # [T_pad, patch_dim] uint8 (normalized on device)
    pos2d: np.ndarray          # [T_pad, 2] int32 (row, col); padding = (0, 0)
    segment_ids: np.ndarray    # [T_pad] int32, image index, -1 = padding
    grids: List[Tuple[int, int]]  # per-image (grid_h, grid_w) in raw patches
    num_tokens: int            # emitted raw patch count (window padding included)
    num_merged: int            # valid merged tokens = real patches / merge^2
    # [T_pad] int32 window id per token (-1 past the packed tokens) with
    # window-major packing; None when every layer attends image-wide.
    window_ids: Optional[np.ndarray] = None

    def merged_valid_rows(self, merge: int = 4) -> np.ndarray:
        """Indices of valid merged rows in emission order: the k-th imgpad
        token maps to row merged_valid_rows[k] (merge groups are
        homogeneous: window and bucket padding cover whole groups)."""
        return np.nonzero(self.segment_ids[::merge] >= 0)[0]


def extract_patches(
    image: Image.Image, cfg: VisionConfig
) -> Tuple[np.ndarray, Tuple[int, int], np.ndarray, np.ndarray]:
    """Smart-resized image -> ([T_emit, patch_dim] uint8 patches in emission
    order, (grid_h, grid_w), per-token window ids, per-token validity). With
    windowing T_emit > grid_h * grid_w: edge windows are padded to
    window^2 tokens (zero patches, valid False)."""
    arr = np.asarray(image.convert("RGB"), dtype=np.uint8)
    h, w, c = arr.shape
    p = cfg.patch_size
    grid = p * cfg.spatial_merge_size
    if h % grid or w % grid:
        raise ValueError(f"image {w}x{h} is not on the {grid}-pixel grid")
    grid_h, grid_w = h // p, w // p
    perm, window_ids = token_order(grid_h, grid_w, merge=cfg.spatial_merge_size,
                                   window=cfg.window_size, pad_windows=cfg.window_size > 0)
    valid = perm >= 0
    out = patchify_native(np.ascontiguousarray(arr), perm, p, grid_w)
    if out is None:  # no host compiler: numpy im2col, channel-last in a patch
        flat = (
            arr.reshape(grid_h, p, grid_w, p, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape(grid_h * grid_w, p * p * c)
        )
        out = np.zeros((len(perm), flat.shape[1]), np.uint8)
        out[valid] = flat[perm[valid]]
    return out, (grid_h, grid_w), window_ids, valid


def token_bucket(num_tokens: int, bucket_step: int = 512) -> int:
    """Pad the packed token count to a bucket of at least 512 tokens (few
    distinct shapes; the JAX package's buckets, so packs match it)."""
    return max(512, -(-num_tokens // bucket_step) * bucket_step)


def _assemble(parts, grids, cfg: VisionConfig, bucket_step: int) -> PackedVisionInput:
    """parts: (patches, pos2d, segment_ids, window_ids or None) per
    request/image, emitted rows only, concatenated in order into one
    bucket-padded token axis."""
    total = sum(len(pt[0]) for pt in parts)
    padded = token_bucket(total, bucket_step=bucket_step)
    windowed = cfg.window_size > 0 and any(pt[3] is not None for pt in parts)
    if cfg.window_size > 0:
        wtok = cfg.window_size**2
        padded = -(-padded // wtok) * wtok
    patches = np.zeros((padded, cfg.patch_dim), np.uint8)
    pos2d = np.zeros((padded, 2), np.int32)
    segment_ids = np.full((padded,), -1, np.int32)
    window_ids = np.full((padded,), -1, np.int32) if windowed else None
    off = 0
    for pt, pos, seg, win in parts:
        n = len(pt)
        patches[off : off + n] = pt
        pos2d[off : off + n] = pos
        segment_ids[off : off + n] = seg
        if windowed:
            window_ids[off : off + n] = win
        off += n
    merge = cfg.spatial_merge_size**2
    return PackedVisionInput(
        patches=patches,
        pos2d=pos2d,
        segment_ids=segment_ids,
        grids=list(grids),
        num_tokens=total,
        num_merged=sum((gh * gw) // merge for gh, gw in grids),
        window_ids=window_ids,
    )


def pack_images(
    images: Sequence[Image.Image], cfg: VisionConfig, bucket_step: int = 512
) -> PackedVisionInput:
    """Pack N smart-resized images into one padded token axis."""
    parts, grids, window_offset = [], [], 0
    for idx, image in enumerate(images):
        patches, (gh, gw), window_ids, valid = extract_patches(image, cfg)
        pos2d = vision_grid_positions(gh, gw, merge=cfg.spatial_merge_size,
                                      window=cfg.window_size, pad_windows=cfg.window_size > 0)
        parts.append((patches, pos2d, np.where(valid, idx, -1).astype(np.int32),
                      window_ids + window_offset))
        window_offset += int(window_ids.max()) + 1 if len(window_ids) else 0
        grids.append((gh, gw))
    return _assemble(parts, grids, cfg, bucket_step)


def merge_packed(
    packed_list: Sequence[PackedVisionInput], cfg: VisionConfig, bucket_step: int = 512
) -> PackedVisionInput:
    """Merge per-request packs into one token axis (batched prefill): the
    emitted regions concatenated in request order, segment ids offset so
    images never alias across requests (window padding keeps -1), window
    ids offset so windows stay distinct."""
    parts, grids, seg_offset, win_offset = [], [], 0, 0
    for packed in packed_list:
        n = packed.num_tokens
        seg = packed.segment_ids[:n]
        win = None
        if packed.window_ids is not None:
            win = packed.window_ids[:n] + win_offset
            win_offset += int(packed.window_ids[:n].max()) + 1 if n else 0
        parts.append((packed.patches[:n], packed.pos2d[:n],
                      np.where(seg >= 0, seg + seg_offset, -1), win))
        seg_offset += len(packed.grids)
        grids.extend(packed.grids)
    return _assemble(parts, grids, cfg, bucket_step)
