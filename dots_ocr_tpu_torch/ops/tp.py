"""The collectives of tensor parallelism (port of ``dots_ocr_tpu.ops.tp``).

The JAX package wraps each Pallas kernel in ``jax.shard_map``
(``flash_attention_tp``, ``paged_attention_multiquery_tp``,
``paged_attention_multipage_tp``) so that every chip runs the unmodified
kernel over its own heads, and GSPMD inserts the psum at the row-parallel
wo / down matmuls. Here a process is one rank and holds only its shard
(``parallel/sharding.py``): q, k, v and the paged pools already have the
rank's heads, so the plain kernel wrappers (``flash_attention``,
``paged_attention.IMPLEMENTATIONS``) serve as the per-rank functions, with
their own head-grouping checks. The partial sums meet in
:func:`tp_all_reduce`, once after each row-parallel linear
(``models/layers.py::linear``'s ``reduce``).

Training differentiates through the same places with Megatron's pair of
``torch.autograd.Function`` classes, where GSPMD derives the collectives of the
JAX step: **f** (:func:`copy_to_model`) at the input of each
column-parallel block, identity forward and a sum of the input's gradient
over the model group backward; **g** (:func:`model_all_reduce` on a tensor
that requires grad) after each row-parallel linear, the sum of the float32
product forward and identity backward. Neither is
``torch.distributed.nn.functional.all_reduce``, whose backward sums again.
Serving runs no autograd (nothing requires grad), so it keeps the in-place
:func:`tp_all_reduce` and its count. Training's collectives, these and the
gradient, norm and loss sums of ``train/train_step.py``, count in
``train_all_reduce.launches``.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.distributed as dist

from dots_ocr_tpu_torch.parallel.distributed import TPGroup, TPGroupLost


def kernel_tp_degree(world: Optional[int], *head_counts: int) -> int:
    """TP degree if every head count divides it, else 0; 1 for no group or
    a group of one (the JAX package's rule over the mesh's model axis)."""
    if world is None or world == 1:
        return 1
    if all(h % world == 0 for h in head_counts):
        return world
    return 0


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _all_reduce(x: torch.Tensor, tp: TPGroup, group, op: str) -> torch.Tensor:
    if tp.lost:
        raise TPGroupLost(tp.lost)
    try:
        dist.all_reduce(x, op=_OPS[op], group=group)
    except RuntimeError as e:
        tp.lost = f"all_reduce failed: {e}"
        raise TPGroupLost(tp.lost) from e
    return x


def tp_all_reduce(x: torch.Tensor, tp: TPGroup, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the TP group (``op`` "sum" or "max"), in place, and
    return it. Counts calls in ``tp_all_reduce.launches`` (under gloo a
    call also waits for the device's queued work: its CUDA tensors go
    through the host). A failed collective marks the group lost and raises
    :class:`TPGroupLost`."""
    _all_reduce(x, tp, tp.group, op)
    tp_all_reduce.launches += 1
    return x


tp_all_reduce.launches = 0


def train_all_reduce(x: torch.Tensor, tp: TPGroup, group=None) -> torch.Tensor:
    """Sum ``x`` over ``group`` (default: the model group), in place, and
    return it; training's collectives, counted in
    ``train_all_reduce.launches``. Fails as :func:`tp_all_reduce` does."""
    _all_reduce(x, tp, tp.group if group is None else group, "sum")
    train_all_reduce.launches += 1
    return x


train_all_reduce.launches = 0


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: identity forward; the input's gradient summed over the
    model group backward (each rank's column shard contributes a part)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # a copy: autograd may hand the same gradient tensor to other nodes
        return train_all_reduce(grad.clone(memory_format=torch.contiguous_format), ctx.tp), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: the row-parallel partial products summed over the model
    group forward; identity backward (every rank's shard sees the whole
    output's gradient)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, tp: TPGroup) -> torch.Tensor:
        return train_all_reduce(x.clone(memory_format=torch.contiguous_format), tp)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def _sharded(tp: Optional[TPGroup], part: str) -> bool:
    return tp is not None and part in tp.plan.row_parallel


def copy_to_model(x: torch.Tensor, tp: Optional[TPGroup], part: str) -> torch.Tensor:
    """f at the input of ``part``'s column-parallel block (q / k / v, gate /
    up, the merger's fc1) when the rank holds a shard of it and autograd
    records ``x``; else ``x`` itself (serving, a whole part)."""
    if _sharded(tp, part) and x.requires_grad and torch.is_grad_enabled():
        return _CopyToModel.apply(x, tp)
    return x


def model_all_reduce(x: torch.Tensor, tp: TPGroup, op: str = "sum") -> torch.Tensor:
    """The sum after a row-parallel linear: g when autograd records ``x``
    (training; "sum" only, as a float tree has no W8A8 amax), else the
    in-place :func:`tp_all_reduce` of serving."""
    if x.requires_grad and torch.is_grad_enabled():
        if op != "sum":
            raise ValueError(f"tensor-parallel training reduces by sum, not {op!r}")
        return _ReduceFromModel.apply(x, tp)
    return tp_all_reduce(x, tp, op)


def row_reduce(tp: Optional[TPGroup], part: str) -> Optional[Callable[..., torch.Tensor]]:
    """The reduce a row-parallel linear of ``part`` ("decoder.attn",
    "decoder.mlp", "vision.attn", "vision.mlp", "vision.merger") needs on
    this rank: the all-reduce when the rank holds a shard of it, None when
    it is replicated (or there is no group)."""
    if not _sharded(tp, part):
        return None
    return functools.partial(model_all_reduce, tp=tp)
