"""Primitive layers as plain functions over parameter dicts of tensors.

Linear kernels keep the JAX layout ``[in, out]`` so a parameter tree carries
over unchanged. A kernel is a tensor or one of the quantized dicts of
``models/quantize.py``: weight-only int8 ``{"qint8", "scale"}``, W8A8
``{"qint8_act", "scale"}`` or weight-only int4 ``{"qint4", "scale4"}``.

Every product returns its float32 sum, as the JAX package's
``preferred_element_type=jnp.float32`` does: the bias and any int8 scale
apply to that sum, and the cast to the activation dtype comes last.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F

from dots_ocr_tpu_torch.ops.int4_matmul import int4_linear
from dots_ocr_tpu_torch.ops.int8_matmul import matmul_f32, w8a16_matmul

Kernel = Union[torch.Tensor, dict]
Reduce = Callable[..., torch.Tensor]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32, output cast back to x.dtype (Qwen convention)."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.to(torch.float32)).to(x.dtype)


def int8_matmul(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 xq [..., K] and int8 q [K, N]
    (``torch._int_mm``, cuBLASLt on the card, where the JAX package leaves it
    to XLA). Rows are zero-padded past 16 for ``_int_mm``'s shape rule."""
    x2 = xq.reshape(-1, xq.shape[-1])
    rows = x2.shape[0]
    if rows <= 16:
        x2 = F.pad(x2, (0, 0, 0, 17 - rows))
    return torch._int_mm(x2, q)[:rows].reshape(*xq.shape[:-1], q.shape[-1])


def linear(x: torch.Tensor, kernel: Kernel, bias: Optional[torch.Tensor] = None,
           reduce: Optional[Reduce] = None) -> torch.Tensor:
    """x @ kernel (+ bias) with kernel [in, out], cast to x.dtype.

    ``reduce`` makes it a row-parallel linear of tensor-parallel serving:
    ``kernel`` holds the rank's rows, the float32 product (int8 scale
    included) is summed over the ranks in place by ``reduce``
    (``ops/tp.py::tp_all_reduce``), and the bias and the cast follow the
    sum, as GSPMD's psum of the JAX package's float32 einsum does. A W8A8
    kernel takes each row's amax over every rank's slice (``reduce``'s
    "max") and sums the exact int32 products before its scales.

    An int8 kernel goes through ``ops.int8_matmul.w8a16_matmul``: the
    weight as x.dtype (exact), its per-output-channel scale on the float32
    sum (it commutes with the contraction), then the bias and the cast; on
    the card in one kernel that reads the int8 weight, where XLA fuses the
    convert into the dot's operand read.

    An int4 kernel goes through ``ops.int4_matmul.int4_linear``, which
    returns x.dtype: the sum is rounded to x.dtype before the bias, as in
    the JAX package. A W8A8 kernel quantizes x per row (``a_scale =
    max(amax / 127, 1e-8)``, codes clipped to +-127), takes the exact int32
    product, and scales it as ``acc * a_scale * s``.
    """
    summed = reduce is None
    if isinstance(kernel, dict) and "qint8" in kernel:
        if summed:
            return w8a16_matmul(x, kernel["qint8"], kernel["scale"], bias)
        out = w8a16_matmul(x, kernel["qint8"], kernel["scale"], out_f32=True)
    elif isinstance(kernel, dict) and "qint4" in kernel:
        out = int4_linear(x, kernel).to(torch.float32)
    elif isinstance(kernel, dict) and "qint8_act" in kernel:
        xf = x.to(torch.float32)
        amax = xf.abs().amax(dim=-1, keepdim=True)
        if not summed:
            amax = reduce(amax, op="max")
        a_scale = (amax / amax.new_full((), 127.0)).clamp_min(1e-8)  # true division
        xq = torch.round(xf / a_scale).clamp(-127, 127).to(torch.int8)
        acc = int8_matmul(xq, kernel["qint8_act"])
        if not summed:
            acc, summed = reduce(acc), True
        out = acc.to(torch.float32) * a_scale * kernel["scale"]
    else:
        out = matmul_f32(x, kernel)
    if not summed:
        out = reduce(out)
    if bias is not None:
        out = out + bias.to(torch.float32)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, gate_kernel: Kernel, up_kernel: Kernel,
           down_kernel: Kernel, reduce: Optional[Reduce] = None) -> torch.Tensor:
    """SwiGLU MLP: down(silu(gate(x)) * up(x)); ``reduce`` as in
    :func:`linear` for a rank's column-parallel gate / up and row-parallel
    down."""
    gate = linear(x, gate_kernel)
    up = linear(x, up_kernel)
    hidden = F.silu(gate.to(torch.float32)).to(x.dtype) * up
    return linear(hidden, down_kernel, reduce=reduce)


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
    per-vocab-row scale multiplies the logits' vocab axis (the W8A16 kernel
    on the card)."""
    if isinstance(embedding, dict):
        return w8a16_matmul(x, embedding["qint8"], embedding["scale"], transposed=True)
    return matmul_f32(x, embedding.t())


def layer_params(blocks: dict, i: int) -> dict:
    """Layer i of a parameter tree whose leaves are stacked on axis 0."""
    return {
        k: layer_params(v, i) if isinstance(v, dict) else v[i]
        for k, v in blocks.items()
    }


def unstack_layers(blocks: dict) -> list:
    """Every layer of a stacked parameter tree, as views (``torch.unbind``).
    Under autograd one unbind's backward stacks all the layers' gradients
    into the stacked leaf at once, where indexing each layer
    (:func:`layer_params`) would add a zero-padded full-size gradient a
    layer."""
    if not isinstance(blocks, dict):
        return list(torch.unbind(blocks))
    parts = {k: unstack_layers(v) for k, v in blocks.items()}
    depth = len(next(iter(parts.values())))
    return [{k: p[i] for k, p in parts.items()} for i in range(depth)]
