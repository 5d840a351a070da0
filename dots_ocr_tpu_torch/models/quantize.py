"""Weight-only int8 quantization of the decoder (port of the int8 subset of
``dots_ocr_tpu.models.quantize``).

Symmetric per-output-channel scales: ``w ~= q * s[None, :]`` with
``q = clip(round(w / s), -127, 127)`` and ``s = max(max|w| / 127, 1e-8)``
per column. A quantized kernel is the dict ``{"qint8": int8 [in, out],
"scale": f32 [out]}``; stacked ``[L, in, out]`` leaves get per-layer scales
``[L, out]``. The tied embedding is quantized per vocab row, the output
channel of the unembed. Vision weights, norms and biases stay as they are.
``torch.round`` rounds half to even, as ``jnp.round`` does.

W8A8 vision (``quantize_kernel_act``) and int4 are not ported.
"""

from __future__ import annotations

from typing import Dict

import torch

BLOCK_KERNELS = (
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
    ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"),
)


def _quantize(w: torch.Tensor, axis: int) -> Dict[str, torch.Tensor]:
    wf = w.to(torch.float32)
    s = (wf.abs().amax(dim=axis) / 127.0).clamp_min(1e-8)
    q = torch.round(wf / s.unsqueeze(axis)).clamp(-127, 127).to(torch.int8)
    return {"qint8": q, "scale": s}


def quantize_kernel(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] (or stacked [L, in, out]) -> {qint8, scale [out] / [L, out]}."""
    return _quantize(w, axis=-2)


def quantize_embedding(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[vocab, d] -> {qint8, scale [vocab]} (per-row scales)."""
    return _quantize(w, axis=1)


def dequantize_kernel(qk: Dict[str, torch.Tensor], axis: int = 0) -> torch.Tensor:
    """Inverse of quantize_kernel (axis=0) / quantize_embedding (axis=1), f32."""
    q, s = qk["qint8"], qk["scale"]
    return q.to(torch.float32) * (s[:, None] if axis == 1 else s[..., None, :])


def is_quantized_kernel(obj) -> bool:
    return isinstance(obj, dict) and set(obj) == {"qint8", "scale"}


def quantize_decoder_params(params: dict, include_embed: bool = True) -> dict:
    """A new parameter tree with the decoder's block linears (and, with
    ``include_embed``, the embedding and any lm_head) as int8. Takes the
    full tree ({"vision", "decoder"}) or a bare decoder tree; the leaves
    that stay are shared, not copied."""
    if "decoder" in params:
        return {**params, "decoder": quantize_decoder_params(params["decoder"], include_embed)}
    blocks = dict(params["blocks"])
    for group, name in BLOCK_KERNELS:
        if name in blocks.get(group, {}) and not isinstance(blocks[group][name], dict):
            blocks[group] = {**blocks[group], name: quantize_kernel(blocks[group][name])}
    dec = {**params, "blocks": blocks}
    if include_embed and "embed" in dec and not is_quantized_kernel(dec["embed"]):
        dec["embed"] = quantize_embedding(dec["embed"])
        if "lm_head" in dec:
            dec["lm_head"] = quantize_kernel(dec["lm_head"])
    return dec


def param_bytes(params) -> int:
    """Total bytes of a parameter tree's tensors (for the quantization log)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
