"""Process-group set-up for tensor-parallel serving and for training over a
(data, model) layout of ranks (port of ``dots_ocr_tpu.parallel.distributed``
and of the mesh builders of ``dots_ocr_tpu.parallel.sharding``).

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

Training lays ``WORLD_SIZE`` ranks out as ``make_mesh`` lays devices out,
row-major over (data, model) (:class:`Layout`): rank r has data index
``r // model`` and model index ``r % model``. A model group is ``model``
contiguous ranks (the tensor-parallel group, which never crosses a node, as
``multihost_mesh`` asserts); a data group is the strided ranks of one model
index. Serving is the layout (1, world).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, List, Optional, Tuple

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class Layout:
    """A (data, model) layout of ranks, in ``make_mesh``'s row-major order."""

    data: int
    model: int

    @property
    def world(self) -> int:
        return self.data * self.model

    def coords(self, rank: int) -> Tuple[int, int]:
        """(data index, model index) of a rank."""
        return divmod(rank, self.model)

    def model_ranks(self, data_index: int) -> List[int]:
        return list(range(data_index * self.model, (data_index + 1) * self.model))

    def data_ranks(self, model_index: int) -> List[int]:
        return list(range(model_index, self.world, self.model))

    def replica_ranks(self, data_index: int, kv_head: int, replication: int) -> List[int]:
        """The ranks of a model group that hold KV head ``kv_head`` when
        each KV head is repeated on ``replication`` contiguous ranks."""
        start = data_index * self.model + kv_head * replication
        return list(range(start, start + replication))


def make_layout(world: int, model_parallel: int = 1,
                local_world: Optional[int] = None) -> Layout:
    """``auto_mesh``'s rule over ranks: data = world / model, which must
    divide; with ``local_world`` (the ranks of a node) a model group must
    not cross a node, as ``multihost_mesh`` asserts."""
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks are not divisible by model={model_parallel}")
    if local_world is not None and local_world % model_parallel:
        raise ValueError(f"{local_world} ranks a node are not divisible by "
                         f"model={model_parallel}: a model group would cross a node")
    return Layout(world // model_parallel, model_parallel)


class TPGroupLost(RuntimeError):
    """A collective of the TP group failed: a rank died or timed out. The
    group cannot be used again."""


@dataclasses.dataclass
class TPGroup:
    """One rank's view of the tensor-parallel group. ``rank`` and
    ``world`` are the rank's model index and the model group's size (under
    serving the global rank and world), ``group`` the model group on the
    device backend and ``control`` the CPU gloo group of every rank.
    ``plan`` is the rank's :class:`parallel.sharding.ShardPlan`, set once
    its parameters are sharded; ``lost`` the reason the group failed, if
    it did.

    Training over a layout with data > 1 adds the rank's data index and
    data group, ``model_control`` (the model group on CPU gloo, for the
    checkpoint's gathers; ``control`` when the model group is every rank)
    and, once the plan repeats KV heads, ``replica_group`` (the ranks that
    hold this rank's KV head, :func:`join_replica_groups`)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    group: Any
    control: Any
    timeout_s: float = DEFAULT_TIMEOUT_S
    plan: Any = None
    lost: Optional[str] = None
    data: int = 1
    data_rank: int = 0
    data_group: Any = None
    model_control: Any = None
    replica_group: Any = None

    @property
    def layout(self) -> Layout:
        return Layout(self.data, self.world)

    @property
    def global_rank(self) -> int:
        return self.data_rank * self.world + self.rank


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
    model_parallel: Optional[int] = None,
) -> Optional[TPGroup]:
    """Join the TP group; returns None for one process (no group).

    Arguments default from the standard variables: ``RANK``,
    ``WORLD_SIZE``, and ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``);
    ``init_method`` may name a ``file://`` store or ``tcp://host:port``.
    ``backend`` is required for more than one process and never chosen
    from what the host has: ``nccl`` needs a GPU a rank and refuses to
    start otherwise; ``gloo`` lets every rank use ``device``.

    ``model_parallel`` (training) lays the ranks out as
    ``make_layout(world, model_parallel, LOCAL_WORLD_SIZE)``; every rank
    creates every model group, then every data group, then the model
    groups on CPU gloo, in that order (``new_group`` is collective). None,
    or the whole world, is serving's one group of every rank."""
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    rank = rank if rank is not None else _env_int("RANK")
    if world in (None, 1):
        logger.info("single-process run: no TP group")
        return None
    if backend not in BACKENDS:
        raise ValueError(f"TP backend {backend!r} not in {BACKENDS}")
    if rank is None:
        raise ValueError("TP rank not given (RANK)")
    layout = make_layout(world, model_parallel or world,
                         _env_int("LOCAL_WORLD_SIZE") if model_parallel else None)
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
    if layout.model == world:
        logger.info("TP rank %d / %d joined (%s on %s)", rank, world, backend, device)
        return TPGroup(rank=rank, world=world, backend=backend, device=device,
                       group=dist.group.WORLD, control=control, timeout_s=timeout_s,
                       model_control=control)
    data_index, model_index = layout.coords(rank)

    def mine(groups):
        return next(g for ranks, g in groups if rank in ranks)

    model_groups = [(r, dist.new_group(r, timeout=timeout))
                    for r in map(layout.model_ranks, range(layout.data))]
    data_groups = [(r, dist.new_group(r, timeout=timeout))
                   for r in map(layout.data_ranks, range(layout.model))]
    model_controls = [(r, dist.new_group(r, backend="gloo", timeout=timeout))
                      for r in map(layout.model_ranks, range(layout.data))]
    logger.info("rank %d / %d joined (%s on %s): data %d of %d, model %d of %d", rank, world,
                backend, device, data_index, layout.data, model_index, layout.model)
    return TPGroup(rank=model_index, world=layout.model, backend=backend, device=device,
                   group=mine(model_groups), control=control, timeout_s=timeout_s,
                   data=layout.data, data_rank=data_index, data_group=mine(data_groups),
                   model_control=mine(model_controls))


def join_replica_groups(tp: TPGroup, replication: int) -> None:
    """With KV heads repeated on ``replication`` contiguous ranks of each
    model group, set ``tp.replica_group`` to the ranks that share this
    rank's KV head. Every rank creates every replica group, in the same
    order (``new_group`` is collective)."""
    if replication <= 1:
        return
    layout = tp.layout
    timeout = datetime.timedelta(seconds=tp.timeout_s)
    for d in range(layout.data):
        for head in range(layout.model // replication):
            ranks = layout.replica_ranks(d, head, replication)
            group = dist.new_group(ranks, timeout=timeout)
            if tp.global_rank in ranks:
                tp.replica_group = group


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
