"""Seeded random weights of a configuration, made on the device: what every
architecture shares (the vision tower's shapes, the draw); each
``arch/<arch>.py`` adds its decoder's shapes and its ``make_weights``.

The tree is the layout the program takes (nested dicts, transformer blocks
stacked on a leading layer axis, linear kernels ``[in, out]``), with the
shapes of the configuration file. Each tower's leaves are views of one
buffer drawn in one call from a generator on the device, in the served
dtype: N(0, 0.02^2) for every leaf, 1 + N(0, 0.02^2) for the norms. The
same seed gives the same weights, so the reference draws them again after
the program has gone.

A trained OCR model is confident: its top logit stands well clear of the
next, so sampling at temperature 0.1 nearly always takes it. Random weights
at std 0.02 give logits of std ~0.8, whose top two lie ~0.16 apart, and at
0.1 a quarter of the draws leave the top token. The configuration's
``weights.final_norm_gain`` multiplies the decoder's final norm, and with it
the logits, to give them a trained model's spread.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

SCALE = 0.02


def vision_shapes(dims: dict) -> Dict:
    v, llm = dims["vision"], dims["decoder"]["hidden_size"]
    n, d, i = v["num_layers"], v["hidden_size"], v["intermediate_size"]
    a = v["num_heads"] * v["head_dim"]
    patch_dim = v["in_channels"] * v["temporal_patch_size"] * v["patch_size"] ** 2
    md = d * v["spatial_merge_size"] ** 2
    return {
        "patch_embed": {"kernel": (patch_dim, d), "bias": (d,)},
        "blocks": {
            "norm1": (n, d), "norm2": (n, d),
            "attn": {"wq": (n, d, a), "wk": (n, d, a), "wv": (n, d, a), "wo": (n, a, d),
                     "bq": (n, a), "bk": (n, a), "bv": (n, a)},
            "mlp": {"gate": (n, d, i), "up": (n, d, i), "down": (n, i, d)},
        },
        "post_norm": (d,),
        "merger": {"norm": (md,), "fc1": (md, md), "b1": (md,), "fc2": (md, llm),
                   "b2": (llm,)},
    }


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def tower(shapes: Dict, generator: torch.Generator, dtype, device, std: float,
          gains: Dict[str, float]) -> Dict:
    """One tower's leaves of ``shapes``, drawn in one ``randn`` call from
    ``generator``; a norm named in ``gains`` is multiplied by its gain."""
    leaves = list(_leaves(shapes))
    total = sum(math.prod(s) for _, s in leaves)
    flat = torch.randn(total, generator=generator, device=device, dtype=dtype)
    flat.mul_(std)
    out: Dict = {}
    off = 0
    for path, shape in leaves:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        if "norm" in path[-1]:
            leaf.add_(1.0)
            if path[-1] in gains:
                leaf.mul_(gains[path[-1]])
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
        off += n
    return out
