"""Weight quantization for serving (port of ``dots_ocr_tpu.models.quantize``).

Three kinds of quantized linear kernel, each a dict that ``layers.linear``
dispatches on; stacked ``[L, in, out]`` leaves quantize per layer:

  * weight-only int8 ``{"qint8": int8 [in, out], "scale": f32 [out]}``:
    symmetric per output channel, ``q = clip(round(w / s), -127, 127)``
    with ``s = max(max|w| / 127, 1e-8)`` per column. The tied embedding is
    quantized per vocab row, the output channel of the unembed.
  * W8A8 ``{"qint8_act": int8 [in, out], "scale": f32 [out]}``: the same
    weights, tagged so that ``linear`` also quantizes the activations per
    row and takes an int8 x int8 -> int32 product (the vision tower's block
    linears, ``--vision-quantize int8``).
  * weight-only int4 ``{"qint4": int8 [in/2, out] nibble-packed, "scale4":
    f32 [in/128, out]}``: symmetric per 128-row input group and output
    column, q in [-7, 7], consumed by ``ops/int4_matmul.py``
    (``--quantize int4``). Kernels whose shape is not int4-aligned fall back
    to int8, kernel by kernel; the embedding and lm_head stay int8.

Norms, biases, the patch embed and the merger stay as they are. In
DeepSeek's decoder (``models/mla.py``) the MLA projections q_a, q_b and
o_proj, the dense layers' and the shared experts' MLPs and the lm_head are
quantized; kv_a (576 outputs, not a multiple of the W8A16 kernel's 128
columns), kv_b (split into the absorbed decode's W_UK and W_UV), the router
and the routed experts (grouped products) stay as they are.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from dots_ocr_tpu_torch.ops.int4_matmul import GROUP, pack_int4

BLOCK_KERNELS = (
    ("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo"),
    ("mlp", "gate"), ("mlp", "up"), ("mlp", "down"),
)
# DeepSeek's MLA query projections (its o_proj is "wo").
MLA_KERNELS = (("attn", "q_a"), ("attn", "q_b"))
# DeepSeek's stacked MLPs outside the blocks: the dense layers', the shared experts'.
MLP_GROUPS = ("dense", "shared")
QUANT_KEYS = ("qint8", "scale")
ACT_QUANT_KEYS = ("qint8_act", "scale")
INT4_KEYS = ("qint4", "scale4")


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


def quantize_kernel_act(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] (or stacked) -> {qint8_act, scale}: :func:`quantize_kernel`'s
    weights, tagged for the W8A8 product."""
    qk = quantize_kernel(w)
    return {"qint8_act": qk["qint8"], "scale": qk["scale"]}


def quantize_kernel_int4(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[in, out] (or stacked [L, in, out]) -> {qint4 [..., in/2, out],
    scale4 [..., in/128, out]}: s = max(max|w| / 7, 1e-8) over each group
    of 128 input rows, q = clip(round(w / s), -7, 7), packed by
    :func:`~dots_ocr_tpu_torch.ops.int4_matmul.pack_int4`. Needs in % 256
    == 0 and out % 128 == 0 (:func:`int4_compatible`)."""
    wf = w.to(torch.float32)
    in_dim, out_dim = wf.shape[-2:]
    wg = wf.reshape(*wf.shape[:-2], in_dim // GROUP, GROUP, out_dim)
    amax = wg.abs().amax(dim=-2)
    s = (amax / amax.new_full((), 7.0)).clamp_min(1e-8)  # true division, as jnp's
    q = torch.round(wg / s.unsqueeze(-2)).clamp(-7, 7).to(torch.int8)
    return {"qint4": pack_int4(q.reshape(wf.shape)), "scale4": s}


def int4_compatible(w) -> bool:
    return (isinstance(w, torch.Tensor) and w.dim() in (2, 3)
            and w.shape[-2] % 256 == 0 and w.shape[-1] % 128 == 0)


def is_quantized_kernel(obj) -> bool:
    return isinstance(obj, dict) and set(obj) == set(QUANT_KEYS)


def is_act_quantized_kernel(obj) -> bool:
    return isinstance(obj, dict) and set(obj) == set(ACT_QUANT_KEYS)


def is_int4_kernel(obj) -> bool:
    return isinstance(obj, dict) and set(obj) == set(INT4_KEYS)


def has_int4_kernels(params) -> bool:
    """Whether any kernel of a parameter tree is int4."""
    return is_int4_kernel(params) or (
        isinstance(params, dict) and any(has_int4_kernels(v) for v in params.values()))


def _quantize_blocks(blocks: dict, quantize: Callable[[torch.Tensor], dict]) -> dict:
    """The block linears of BLOCK_KERNELS through ``quantize``; already
    quantized ones and every other leaf are kept (shared, not copied)."""
    blocks = dict(blocks)
    for group, name in BLOCK_KERNELS + MLA_KERNELS:
        if name in blocks.get(group, {}) and not isinstance(blocks[group][name], dict):
            blocks[group] = {**blocks[group], name: quantize(blocks[group][name])}
    return blocks


def _quantize_decoder(params: dict, include_embed: bool, quantize) -> dict:
    if "decoder" in params:
        return {**params, "decoder": _quantize_decoder(params["decoder"], include_embed, quantize)}
    dec = {**params, "blocks": _quantize_blocks(params["blocks"], quantize)}
    for group in MLP_GROUPS:
        if group in dec:
            dec[group] = {k: w if isinstance(w, dict) else quantize(w)
                          for k, w in dec[group].items()}
    if include_embed and "embed" in dec and not is_quantized_kernel(dec["embed"]):
        dec["embed"] = quantize_embedding(dec["embed"])
        if "lm_head" in dec:
            dec["lm_head"] = quantize_kernel(dec["lm_head"])
    return dec


def quantize_decoder_params(params: dict, include_embed: bool = True) -> dict:
    """A new parameter tree with the decoder's block linears (and, with
    ``include_embed``, the embedding and any lm_head) as int8. Takes the
    full tree ({"vision", "decoder"}) or a bare decoder tree."""
    return _quantize_decoder(params, include_embed, quantize_kernel)


def quantize_decoder_params_int4(params: dict, include_embed: bool = True) -> dict:
    """As :func:`quantize_decoder_params`, with the block linears as int4
    where :func:`int4_compatible` (int8 otherwise); the embedding and lm_head
    stay int8. One device only: the nibble packing interleaves input-row
    halves, which a row-parallel shard would split."""
    return _quantize_decoder(
        params, include_embed,
        lambda w: quantize_kernel_int4(w) if int4_compatible(w) else quantize_kernel(w))


def quantize_vision_params(params: dict) -> dict:
    """A new tree with the vision tower's block linears as W8A8 (the full
    tree or a bare vision tree); the patch embed, merger, norms and biases
    stay as they are."""
    if "vision" in params:
        return {**params, "vision": quantize_vision_params(params["vision"])}
    return {**params, "blocks": _quantize_blocks(params["blocks"], quantize_kernel_act)}


def param_bytes(params) -> int:
    """Total bytes of a parameter tree's tensors (for the quantization log)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
