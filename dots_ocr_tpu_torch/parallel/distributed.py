"""Process-group set-up for tensor-parallel serving (port of
``dots_ocr_tpu.parallel.distributed``).

The JAX package runs one process per host and a mesh over its chips; the
port runs one process per rank, the ranks in lockstep: rank 0 serves HTTP
and broadcasts each engine tick's events, every rank applies them to its
own engine over its own parameter shard, and the row-parallel linears'
partial sums meet in one all-reduce over the device group
(``ops/tp.py::tp_all_reduce``).

Two groups a rank: the device group (``backend``: NCCL across distinct
GPUs, or gloo, which stages CUDA tensors through the host and lets ranks
share one GPU) and a CPU gloo group for the pickled control messages. Both
have a finite timeout, so a dead rank fails a collective instead of
hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 120.0


class TPGroupLost(RuntimeError):
    """A collective of the TP group failed: a rank died or timed out. The
    group cannot be used again."""


@dataclasses.dataclass
class TPGroup:
    """One rank's view of the tensor-parallel group. ``plan`` is the
    rank's :class:`parallel.sharding.ShardPlan`, set once its parameters
    are sharded; ``lost`` the reason the group failed, if it did."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: Any
    control: Any
    timeout_s: float = DEFAULT_TIMEOUT_S
    plan: Any = None
    lost: Optional[str] = None


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return int(value) if value else None


def initialize_distributed(
    backend: Optional[str] = None,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    init_method: Optional[str] = None,
    device: Optional[torch.device] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> Optional[TPGroup]:
    """Join the TP group; returns None for one process (no group).

    Arguments default from the standard variables: ``RANK``,
    ``WORLD_SIZE``, and ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``);
    ``init_method`` may name a ``file://`` store or ``tcp://host:port``.
    ``backend`` is required for more than one process and never chosen
    from what the host has: ``nccl`` needs a GPU a rank and refuses to
    start otherwise; ``gloo`` lets every rank use ``device``."""
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world in (None, 1):
        logger.info("single-process run: no TP group")
        return None
    if backend not in BACKENDS:
        raise ValueError(f"TP backend {backend!r} not in {BACKENDS}")
    if rank is None:
        raise ValueError("TP rank not given (RANK)")
    device = torch.device(device if device is not None else "cpu")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        torch.cuda.set_device(device)
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    if init_method is None:
        init_method = "env://"
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            timeout=timeout)
    control = dist.new_group(backend="gloo", timeout=timeout)
    logger.info("TP rank %d / %d joined (%s on %s)", rank, world, backend, device)
    return TPGroup(rank=rank, world=world, backend=backend, device=device,
                   group=dist.group.WORLD, control=control, timeout_s=timeout_s)


def broadcast_object(obj: Any, tp: TPGroup) -> Any:
    """Rank 0's ``obj`` on every rank, pickled over the CPU control group.
    Raises :class:`TPGroupLost` (and marks the group lost) on failure."""
    box = [obj if tp.rank == 0 else None]
    try:
        dist.broadcast_object_list(box, src=0, group=tp.control)
    except RuntimeError as e:
        tp.lost = tp.lost or f"control broadcast failed: {e}"
        raise TPGroupLost(tp.lost) from e
    return box[0]


def destroy(tp: Optional[TPGroup]) -> None:
    """Leave the group, every rank together (best effort: a lost group
    may not close cleanly)."""
    if tp is None or not dist.is_initialized():
        return
    try:
        if not tp.lost:
            dist.barrier(group=tp.control)
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001
        logger.debug("process group teardown failed", exc_info=True)
