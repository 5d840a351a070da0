"""The one collective of tensor-parallel serving (port of
``dots_ocr_tpu.ops.tp``).

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


def tp_all_reduce(x: torch.Tensor, tp: TPGroup, op: str = "sum") -> torch.Tensor:
    """Reduce ``x`` over the TP group (``op`` "sum" or "max"), in place, and
    return it. Counts calls in ``tp_all_reduce.launches`` (under gloo a
    call also waits for the device's queued work: its CUDA tensors go
    through the host). A failed collective marks the group lost and raises
    :class:`TPGroupLost`."""
    if tp.lost:
        raise TPGroupLost(tp.lost)
    try:
        dist.all_reduce(x, op=_OPS[op], group=tp.group)
    except RuntimeError as e:
        tp.lost = f"all_reduce failed: {e}"
        raise TPGroupLost(tp.lost) from e
    tp_all_reduce.launches += 1
    return x


tp_all_reduce.launches = 0


def row_reduce(tp: Optional[TPGroup], part: str) -> Optional[Callable[..., torch.Tensor]]:
    """The reduce a row-parallel linear of ``part`` ("decoder.attn",
    "decoder.mlp", "vision.attn", "vision.mlp", "vision.merger") needs on
    this rank: the all-reduce when the rank holds a shard of it, None when
    it is replicated (or there is no group)."""
    if tp is None or part not in tp.plan.row_parallel:
        return None
    return functools.partial(tp_all_reduce, tp=tp)
