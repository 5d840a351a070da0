"""Primitive layers as plain functions over parameter dicts of tensors.

Linear kernels keep the JAX layout ``[in, out]`` so a parameter tree carries
over unchanged. A kernel is a tensor or a weight-only int8 dict
``{"qint8": int8 [in, out], "scale": f32 [out]}`` (``models/quantize.py``);
the int4 and W8A8 dicts are not ported.

Every product returns its float32 sum, as the JAX package's
``preferred_element_type=jnp.float32`` does: the bias and any int8 scale
apply to that sum, and the cast to the activation dtype comes last.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F

Kernel = Union[torch.Tensor, dict]


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] as the float32 sum of the product.

    On CUDA a bf16 or fp16 product goes to cuBLAS with a float32 output
    (``torch.mm(..., out_dtype=torch.float32)``): no operand is upcast. On
    the CPU the operands are upcast (that build has no ``mm.dtype``
    kernel); a bf16 x bf16 product is exact in float32, so only the
    summation order differs.
    """
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) and w.dtype == x.dtype:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, output cast back to x.dtype (Qwen convention)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def linear(x: torch.Tensor, kernel: Kernel, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x @ kernel (+ bias) with kernel [in, out], cast to x.dtype.

    An int8 kernel is converted to x.dtype and its per-output-channel scale
    multiplies the float32 sum (it commutes with the contraction). The
    convert writes a copy of the weight in x.dtype on every call, where
    XLA fuses it into the dot's operand read.
    """
    if isinstance(kernel, dict):
        out = matmul_f32(x, kernel["qint8"].to(x.dtype)) * kernel["scale"]
    else:
        out = matmul_f32(x, kernel)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, gate_kernel: Kernel, up_kernel: Kernel,
           down_kernel: Kernel) -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(x)) * up(x))."""
    gate = linear(x, gate_kernel)
    up = linear(x, up_kernel)
    hidden = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return linear(hidden, down_kernel)


def embed(input_ids: torch.Tensor, embedding: Kernel) -> torch.Tensor:
    """Token embedding lookup. An int8 per-row table gives bf16 rows times
    their bf16 scale, whatever the model dtype (as the JAX package does)."""
    if isinstance(embedding, dict):
        rows = embedding["qint8"][input_ids].to(torch.bfloat16)
        scale = embedding["scale"][input_ids].to(torch.bfloat16)
        return rows * scale[..., None]
    return embedding[input_ids]


def unembed(x: torch.Tensor, embedding: Kernel) -> torch.Tensor:
    """Tied-embedding logits x @ embedding.T as float32. An int8 table's
    per-vocab-row scale multiplies the logits' vocab axis."""
    if isinstance(embedding, dict):
        return matmul_f32(x, embedding["qint8"].to(x.dtype).t()) * embedding["scale"]
    return matmul_f32(x, embedding.t())


def layer_params(blocks: dict, i: int) -> dict:
    """Layer i of a parameter tree whose leaves are stacked on axis 0."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i]
        for k, v in blocks.items()
    }
