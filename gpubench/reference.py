"""The plain reference's shared part: plain PyTorch in float32, no kernels,
no cache, no batching, written from the configuration's description and not
from the program under test (it imports nothing of it). Each
``arch/<arch>.py`` builds its decoder, its prompt ids and ``served_gaps``
on these.

It works out again what the program derives from the benchmark's inputs
for the vision tower: the patches of a page (row-major 14 x 14 x 3 pixels,
CLIP normalisation, each 2 x 2 merge group contiguous), the 2D rotary
positions, and, for an int8 configuration, the int8 weights (symmetric per
slice, ``round(w / s)`` clipped to 127, ``s = max(max|w| / 127, 1e-8)``).

The encoder, as the configuration states it: patch embed, 42 post-norm
blocks (RMSNorm after each residual add; q, k, v with bias, 2D RoPE over
(row, col), image-wide softmax attention at 1 / sqrt(128); SwiGLU MLP), a
final RMSNorm, then the 2 x 2 merge: RMSNorm over the four tokens'
concatenation, fc1 + b1, GELU (tanh), fc2 + b2. The k-th image pad of the
prompt takes the k-th merged token.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BLOCK = 1024  # query rows per attention block


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32 (no TF32) while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


# -- what the program derives from the inputs, worked out again ---------------

def byte_tokens(text: str, specials: Dict[str, int]) -> List[int]:
    """UTF-8 bytes, with each special string as its own id."""
    out: List[int] = []
    i = 0
    while i < len(text):
        for s, tid in specials.items():
            if text.startswith(s, i):
                out.append(tid)
                i += len(s)
                break
        else:
            out.extend(text[i].encode("utf-8"))
            i += 1
    return out


def page_patches(pixels: np.ndarray, dims: dict, device) -> tuple:
    """[h, w, 3] uint8 -> (normalised patches [T, 588] float32 with each
    2 x 2 merge group contiguous, merge groups row-major; (row, col) of each
    patch [T, 2])."""
    v = dims["vision"]
    p, m = v["patch_size"], v["spatial_merge_size"]
    h, w, c = pixels.shape
    gh, gw = h // p, w // p
    x = torch.from_numpy(np.ascontiguousarray(pixels)).to(device)
    # [gh/m, m, p, gw/m, m, p, c] -> [gh/m, gw/m, m, m, p, p, c]
    x = x.reshape(gh // m, m, p, gw // m, m, p, c).permute(0, 3, 1, 4, 2, 5, 6)
    patches = x.reshape(gh * gw, p * p * c).to(torch.float32) / 255.0
    mean = torch.tensor(v["image_mean"], device=device).repeat(p * p)
    std = torch.tensor(v["image_std"], device=device).repeat(p * p)
    patches = (patches - mean) / std
    r = torch.arange(gh, device=device).reshape(gh // m, m, 1, 1).expand(gh // m, m, gw // m, m)
    col = torch.arange(gw, device=device).reshape(1, 1, gw // m, m).expand(gh // m, m, gw // m, m)
    pos = torch.stack([r.permute(0, 2, 1, 3).reshape(-1), col.permute(0, 2, 1, 3).reshape(-1)], -1)
    return patches, pos


def quantize_int8(w: torch.Tensor, axis: int) -> torch.Tensor:
    """The int8 weight ``w`` stands for, dequantized to float32: symmetric
    per slice along ``axis`` (the reduction axis of its scale)."""
    wf = w.to(torch.float32)
    s = (wf.abs().amax(dim=axis, keepdim=True) / 127.0).clamp_min(1e-8)
    return torch.round(wf / s).clamp(-127, 127) * s


# -- the model ------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight.float()


def rope_halves(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate-half RoPE; x [T, H, D], angles [T, D / 2]."""
    cos = torch.cat([angles.cos(), angles.cos()], -1)[:, None]
    sin = torch.cat([angles.sin(), angles.sin()], -1)[:, None]
    half = x.shape[-1] // 2
    rotated = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rotated * sin


def inv_freq(dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / theta ** (torch.arange(0, dim, 2, device=device, dtype=torch.float32) / dim)


def attention(q, k, v, causal: bool) -> torch.Tensor:
    """Softmax attention in float32, [T, H, D] x [S, KV, D], in blocks of
    query rows; GQA by repeating each KV head over its query group."""
    t, h, d = q.shape
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1).transpose(0, 1)  # [H, S, D]
    v = v.repeat_interleave(group, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for lo in range(0, t, BLOCK):
        hi = min(t, lo + BLOCK)
        s = torch.matmul(q[lo:hi].transpose(0, 1), k.transpose(1, 2)) * d**-0.5
        if causal:
            keep = torch.arange(k.shape[1], device=q.device)[None] <= torch.arange(
                lo, hi, device=q.device)[:, None]
            s = s.masked_fill(~keep, float("-inf"))
        out[lo:hi] = torch.matmul(torch.softmax(s, -1), v).transpose(0, 1)
    return out


def lin(x, w, b=None):
    y = x @ w.float()
    return y if b is None else y + b.float()


def encode_page(vision: dict, dims: dict, patches: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One page's patches -> its merged tokens [T / 4, D_llm]."""
    v = dims["vision"]
    hd, eps = v["head_dim"], v["rms_norm_eps"]
    t = patches.shape[0]
    freqs = inv_freq(hd // 2, v["rope_theta"], patches.device)
    angles = torch.cat([pos[:, :1].float() * freqs, pos[:, 1:].float() * freqs], -1)
    x = lin(patches, vision["patch_embed"]["kernel"], vision["patch_embed"]["bias"])
    b = vision["blocks"]
    for i in range(v["num_layers"]):
        a = {k: w[i] for k, w in b["attn"].items()}
        q = rope_halves(lin(x, a["wq"], a["bq"]).reshape(t, -1, hd), angles)
        k = rope_halves(lin(x, a["wk"], a["bk"]).reshape(t, -1, hd), angles)
        val = lin(x, a["wv"], a["bv"]).reshape(t, -1, hd)
        x = rms_norm(x + lin(attention(q, k, val, False).reshape(t, -1), a["wo"]),
                     b["norm1"][i], eps)
        m = {k: w[i] for k, w in b["mlp"].items()}
        x = rms_norm(x + lin(F.silu(lin(x, m["gate"])) * lin(x, m["up"]), m["down"]),
                     b["norm2"][i], eps)
    x = rms_norm(x, vision["post_norm"], eps)
    mg = vision["merger"]
    merge = v["spatial_merge_size"] ** 2
    h = rms_norm(x.reshape(t // merge, -1), mg["norm"], eps)
    h = F.gelu(lin(h, mg["fc1"], mg["b1"]), approximate="tanh")
    return lin(h, mg["fc2"], mg["b2"])
