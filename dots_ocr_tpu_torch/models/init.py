"""Parameter tree: shapes, seeded on-device random init, and the weight
bridge from the JAX package.

The tree is the one of ``dots_ocr_tpu.models.init.param_specs``: nested
dicts of tensors, transformer blocks stacked on a leading layer axis,
linear kernels ``[in, out]``. ``from_numpy_params`` takes the JAX tree
converted to numpy (``jax.tree.map(np.asarray, params)``) unchanged,
including the JAX package's quantized leaves (``models/quantize.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from dots_ocr_tpu_torch.models.config import DecoderConfig, DotsOCRConfig, VisionConfig

Shapes = Dict[str, Any]


def vision_param_shapes(cfg: VisionConfig, llm_hidden: int) -> Shapes:
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    A = cfg.num_heads * cfg.head_dim
    attn = {"wq": (L, D, A), "wk": (L, D, A), "wv": (L, D, A), "wo": (L, A, D)}
    if cfg.qkv_bias:
        attn.update({"bq": (L, A), "bk": (L, A), "bv": (L, A)})
    md = cfg.merge_dim
    return {
        "patch_embed": {"kernel": (cfg.patch_dim, D), "bias": (D,)},
        "blocks": {
            "norm1": (L, D),
            "norm2": (L, D),
            "attn": attn,
            "mlp": {"gate": (L, D, I), "up": (L, D, I), "down": (L, I, D)},
        },
        "post_norm": (D,),
        "merger": {
            "norm": (md,),
            "fc1": (md, md),
            "b1": (md,),
            "fc2": (md, llm_hidden),
            "b2": (llm_hidden,),
        },
    }


def decoder_param_shapes(cfg: DecoderConfig) -> Shapes:
    L, D, I = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    Q, KV = cfg.q_dim, cfg.kv_dim
    attn = {"wq": (L, D, Q), "wk": (L, D, KV), "wv": (L, D, KV), "wo": (L, Q, D)}
    if cfg.qkv_bias:
        attn.update({"bq": (L, Q), "bk": (L, KV), "bv": (L, KV)})
    out = {
        "embed": (cfg.vocab_size, D),
        "blocks": {
            "input_norm": (L, D),
            "post_attn_norm": (L, D),
            "attn": attn,
            "mlp": {"gate": (L, D, I), "up": (L, D, I), "down": (L, I, D)},
        },
        "final_norm": (D,),
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = (D, cfg.vocab_size)
    return out


def param_shapes(config: DotsOCRConfig) -> Shapes:
    return {
        "vision": vision_param_shapes(config.vision, config.decoder.hidden_size),
        "decoder": decoder_param_shapes(config.decoder),
    }


def _map_tree(fn, tree: Shapes, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def init_params(
    config: DotsOCRConfig,
    device: torch.device,
    generator: torch.Generator,
    scale: float = 0.02,
):
    """Random-normal init on ``device`` from ``generator`` (a generator on
    that device): norm weights 1, biases 0, everything else N(0, scale^2),
    drawn in float32 and cast to the config dtype."""
    dtype = config.torch_dtype

    def make(path, shape):
        name = path[-1]
        if "norm" in name:
            return torch.ones(shape, dtype=dtype, device=device)
        if name.startswith("b") and len(shape) <= 2:
            return torch.zeros(shape, dtype=dtype, device=device)
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    return _map_tree(make, param_shapes(config))


def zeros_params(config: DotsOCRConfig, device: torch.device):
    """Cheap deterministic params on ``device`` in the config dtype (shape
    tests, the spec simulator's bigram model): norm weights 1, so a forward
    pass stays finite, everything else 0."""
    dtype = config.torch_dtype

    def make(path, shape):
        fill = torch.ones if "norm" in path[-1] else torch.zeros
        return fill(shape, dtype=dtype, device=device)

    return _map_tree(make, param_shapes(config))


def count_params(params) -> int:
    """Elements over every leaf of a parameter tree."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def _quantized_leaf(node: dict, shape: Tuple[int, ...], path: Tuple[str, ...],
                    device: torch.device):
    """A quantized leaf of the JAX tree, its integers and float32 scales
    checked against the float kernel's shape [..., in, out]: int8 or W8A8
    ``[..., in, out]`` with scales ``[..., out]``, or int4 nibble-packed
    ``[..., in/2, out]`` with group scales ``[..., in/128, out]``. The int8
    embedding's per-row scales are [vocab]."""
    lead, in_dim, out_dim = shape[:-2], shape[-2], shape[-1]
    if set(node) == {"qint4", "scale4"}:
        keys = ("qint4", "scale4")
        want = (lead + (in_dim // 2, out_dim), lead + (in_dim // 128, out_dim))
    else:
        keys = ("qint8_act" if "qint8_act" in node else "qint8", "scale")
        want = (shape, (shape[0],) if path[-1] == "embed" else lead + (out_dim,))
    q = np.array(node[keys[0]], dtype=np.int8)
    s = np.array(node[keys[1]], dtype=np.float32)
    if (q.shape, s.shape) != want:
        raise ValueError(f"{'/'.join(path)}: {keys} shapes {q.shape}, {s.shape} != {want}")
    return {keys[0]: torch.from_numpy(q).to(device), keys[1]: torch.from_numpy(s).to(device)}


def from_numpy_params(tree, config: DotsOCRConfig, device: torch.device):
    """The JAX parameter tree as numpy arrays -> the port's tree on
    ``device`` in the config dtype. Shapes are checked against
    :func:`param_shapes`; layouts carry over as they are. A quantized leaf
    (int8 ``{"qint8", "scale"}``, W8A8 ``{"qint8_act", "scale"}`` or int4
    ``{"qint4", "scale4"}``, ``dots_ocr_tpu.models.quantize``) keeps its
    integer dtype and float32 scales."""
    dtype = config.torch_dtype

    def convert(path, shape):
        node = tree
        for key in path:
            node = node[key]
        if isinstance(node, dict):
            return _quantized_leaf(node, tuple(shape), path, device)
        arr = np.array(node, dtype=np.float32)  # a writable copy
        if arr.shape != tuple(shape):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != {shape}")
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return _map_tree(convert, param_shapes(config))
