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

Tensor-parallel serving (``tp``): the config is the rank's shard config,
wo, down and the merger's fc2 are row-parallel, each followed by its
all-reduce, and the windowed layers run the flash kernel with one batch
row a window instead of the window kernel, as the JAX package does under a
mesh (``dots_ocr_tpu/models/vision.py:105, :119``). Under training the
inputs of q / k / v, of gate / up and of the merger's fc1 pass through f
(``ops/tp.py::copy_to_model``) where the part is split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dots_ocr_tpu_torch.models.config import VisionConfig
from dots_ocr_tpu_torch.models.layers import linear, rms_norm, swiglu, unstack_layers
from dots_ocr_tpu_torch.models.rope import apply_rope
from dots_ocr_tpu_torch.ops import flash_attention, window_attention
from dots_ocr_tpu_torch.ops.tp import copy_to_model, row_reduce


def vision_block(
    x: torch.Tensor,
    block_params: dict,
    cfg: VisionConfig,
    cos: torch.Tensor,
    sin: torch.Tensor,
    segment_ids: torch.Tensor,
    attn_impl: str = "kernel",
    windowed: bool = False,
    tp=None,
) -> torch.Tensor:
    """One post-norm block over packed tokens x [T, D]. ``attn_impl``
    "kernel" runs the flash (or, with ``windowed``, the window) wrapper,
    "reference" its plain version, "xla" the JAX package's CPU path."""
    attn_p = block_params["attn"]
    t = x.shape[0]
    heads, head_dim = cfg.num_heads, cfg.head_dim

    def attend(h: torch.Tensor) -> torch.Tensor:
        h = copy_to_model(h, tp, "vision.attn")
        q = linear(h, attn_p["wq"], attn_p.get("bq")).reshape(t, heads, head_dim)
        k = linear(h, attn_p["wk"], attn_p.get("bk")).reshape(t, heads, head_dim)
        v = linear(h, attn_p["wv"], attn_p.get("bv")).reshape(t, heads, head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        if windowed:
            w = cfg.window_size**2
            segw = segment_ids.reshape(t // w, w)
            qw, kw, vw = (a.reshape(t // w, w, heads, head_dim) for a in (q, k, v))
            if tp is None:
                out = window_attention.IMPLEMENTATIONS[attn_impl](qw, kw, vw, segw)
            else:
                out = flash_attention.IMPLEMENTATIONS[attn_impl](qw, kw, vw, segw, segw)
        else:
            seg = segment_ids[None]
            out = flash_attention.IMPLEMENTATIONS[attn_impl](q[None], k[None], v[None], seg, seg)[0]
        return linear(out.reshape(t, heads * head_dim), attn_p["wo"],
                      reduce=row_reduce(tp, "vision.attn"))

    def mlp(h: torch.Tensor) -> torch.Tensor:
        m = block_params["mlp"]
        h = copy_to_model(h, tp, "vision.mlp")
        return swiglu(h, m["gate"], m["up"], m["down"], reduce=row_reduce(tp, "vision.mlp"))

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
    tp=None,
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
                         attn_impl, windowed=windows and i not in cfg.full_attn_layers, tp=tp)
    return rms_norm(x, params["post_norm"], cfg.rms_norm_eps)


def merge_tokens(params: dict, cfg: VisionConfig, hidden: torch.Tensor,
                 tp=None) -> torch.Tensor:
    """2x2 spatial merge + projector: [T, D] -> [T / 4, llm_hidden]. The
    GELU is the tanh approximation, as ``jax.nn.gelu`` defaults to. Under
    TP fc1 is column-parallel and fc2 row-parallel (b2 after the sum)."""
    merge = cfg.spatial_merge_size**2
    t, d = hidden.shape
    m = params["merger"]
    h = rms_norm(hidden.reshape(t // merge, merge * d), m["norm"], cfg.rms_norm_eps)
    h = linear(copy_to_model(h, tp, "vision.merger"), m["fc1"], m.get("b1"))
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(hidden.dtype)
    return linear(h, m["fc2"], m.get("b2"), reduce=row_reduce(tp, "vision.merger"))


def encode_images(
    params: dict,
    cfg: VisionConfig,
    patches: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    segment_ids: torch.Tensor,
    attn_impl: str = "kernel",
    tp=None,
) -> torch.Tensor:
    """Packed patches -> merged decoder-space tokens [T / merge^2, llm_hidden]."""
    hidden = vision_forward(params, cfg, patches, rope_cos, rope_sin, segment_ids,
                            attn_impl, tp=tp)
    return merge_tokens(params, cfg, hidden, tp=tp)
