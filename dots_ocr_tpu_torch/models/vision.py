"""NaViT-style vision encoder over packed tokens (port of
``dots_ocr_tpu.models.vision``).

All images of a batch pack into one token axis [T, patch_dim] with
per-token segment ids; image-wide attention is block-diagonal through the
flash kernel's segment masking. The patch embed is a [T, patch_dim] x
[patch_dim, D] matmul (host-side im2col), and the 2x2 merger is a reshape
because the packing keeps each merge group contiguous. The 42 stacked
blocks run as a Python loop over the layer axis.

With ``cfg.window_size > 0`` the packing is window-major with every window
padded to W = window_size^2 tokens, and each layer not in
``cfg.full_attn_layers`` attends within its windows: [T, H, D] reshapes
to [T / W, W, H, D] and runs ``window_attention.IMPLEMENTATIONS``
(the window kernel on the serving path). The JAX package picks the branch
per layer with ``lax.cond``; here a Python ``if`` on the layer index does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dots_ocr_tpu_torch.models.config import VisionConfig
from dots_ocr_tpu_torch.models.layers import linear, rms_norm, swiglu, unstack_layers
from dots_ocr_tpu_torch.models.rope import apply_rope
from dots_ocr_tpu_torch.ops import flash_attention, window_attention


def vision_block(
    x: torch.Tensor,
    block_params: dict,
    cfg: VisionConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    segment_ids: torch.Tensor,
    attn_impl: str = "kernel",
    windowed: bool = False,
) -> torch.Tensor:
    """One post-norm block over packed tokens x [T, D]. ``attn_impl``
    "kernel" runs the flash (or, with ``windowed``, the window) wrapper,
    "reference" its plain version, "xla" the JAX package's CPU path."""
    attn_p = block_params["attn"]
    t = x.shape[0]
    heads, head_dim = cfg.num_heads, cfg.head_dim

    def attend(h: torch.Tensor) -> torch.Tensor:
        q = linear(h, attn_p["wq"], attn_p.get("bq")).reshape(t, heads, head_dim)
        k = linear(h, attn_p["wk"], attn_p.get("bk")).reshape(t, heads, head_dim)
        v = linear(h, attn_p["wv"], attn_p.get("bv")).reshape(t, heads, head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if windowed:
            w = cfg.window_size**2
            segw = segment_ids.reshape(t // w, w)
            out = window_attention.IMPLEMENTATIONS[attn_impl](
                q.reshape(t // w, w, heads, head_dim), k.reshape(t // w, w, heads, head_dim),
                v.reshape(t // w, w, heads, head_dim), segw)
        else:
            seg = segment_ids[None]
            out = flash_attention.IMPLEMENTATIONS[attn_impl](q[None], k[None], v[None], seg, seg)[0]
        return linear(out.reshape(t, heads * head_dim), attn_p["wo"])

    def mlp(h: torch.Tensor) -> torch.Tensor:
        m = block_params["mlp"]
        return swiglu(h, m["gate"], m["up"], m["down"])

    if cfg.post_norm:
        x = rms_norm(x + attend(x), block_params["norm1"], cfg.rms_norm_eps)
        return rms_norm(x + mlp(x), block_params["norm2"], cfg.rms_norm_eps)
    x = x + attend(rms_norm(x, block_params["norm1"], cfg.rms_norm_eps))
    return x + mlp(rms_norm(x, block_params["norm2"], cfg.rms_norm_eps))


def vision_forward(
    params: dict,
    cfg: VisionConfig,
    patches: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    segment_ids: torch.Tensor,
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """Encoder over packed patches [T, patch_dim] (uint8 are normalized
    here with the config's CLIP mean/std); returns pre-merge hidden [T, D].
    Windowed layers (module notes) need T a multiple of window_size^2, as
    window-major packing gives; otherwise every layer attends image-wide,
    as in the JAX package."""
    dtype = params["patch_embed"]["kernel"].dtype
    if patches.dtype == torch.uint8:
        pixels = cfg.patch_dim // cfg.in_channels  # channel fastest in a patch
        mean = torch.tensor(cfg.image_mean, device=patches.device).repeat(pixels)
        std = torch.tensor(cfg.image_std, device=patches.device).repeat(pixels)
        patches = (patches.to(torch.float32) / 255.0 - mean) / std
    x = linear(patches.to(dtype), params["patch_embed"]["kernel"],
               params["patch_embed"].get("bias"))
    cos, sin = rope_cos.to(torch.float32), rope_sin.to(torch.float32)
    windows = cfg.window_size > 0 and x.shape[0] % cfg.window_size**2 == 0
    for i, block in enumerate(unstack_layers(params["blocks"])):
        x = vision_block(x, block, cfg, cos, sin, segment_ids,
                         attn_impl, windowed=windows and i not in cfg.full_attn_layers)
    return rms_norm(x, params["post_norm"], cfg.rms_norm_eps)


def merge_tokens(params: dict, cfg: VisionConfig, hidden: torch.Tensor) -> torch.Tensor:
    """2x2 spatial merge + projector: [T, D] -> [T / 4, llm_hidden]. The
    GELU is the tanh approximation, as ``jax.nn.gelu`` defaults to."""
    merge = cfg.spatial_merge_size**2
    t, d = hidden.shape
    m = params["merger"]
    h = rms_norm(hidden.reshape(t // merge, merge * d), m["norm"], cfg.rms_norm_eps)
    h = linear(h, m["fc1"], m.get("b1"))
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(hidden.dtype)
    return linear(h, m["fc2"], m.get("b2"))


def encode_images(
    params: dict,
    cfg: VisionConfig,
    patches: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    segment_ids: torch.Tensor,
    attn_impl: str = "kernel",
) -> torch.Tensor:
    """Packed patches -> merged decoder-space tokens [T / merge^2, llm_hidden]."""
    hidden = vision_forward(params, cfg, patches, rope_cos, rope_sin, segment_ids,
                            attn_impl)
    return merge_tokens(params, cfg, hidden)
