"""Training checkpoint save/restore (port of ``dots_ocr_tpu.train.checkpoint``).

The directory layout is the JAX package's: ``model_config.json`` (the
config's dataclasses as dicts), the ``latest`` marker holding the newest
step, and one ``state_{step}/`` per save. There is no orbax here: a state is
one safetensors file, ``state_{step}/state.safetensors``, written and read by
the port's own ``models/loader.py`` routines, with the params under their
dotted tree names, the moments under ``mu.*`` / ``nu.*`` and the scalars
``count`` and ``step``. Tensors keep their dtype.

Under tensor and data parallelism the checkpoint holds whole tensors, as
orbax writes a global array (``dots_ocr_tpu/train/checkpoint.py:48``): the
model ranks of data rank 0 send their shards of params, mu and nu to rank 0
over the CPU gloo group (gloo has no gather of CUDA tensors), rank 0 joins
them (``parallel.sharding.unshard_params``) and writes the layout above.
A checkpoint restores at any layout: ``restore_checkpoint``, then
``train_step.shard_train_state``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from dots_ocr_tpu_torch.models.config import (
    DecoderConfig,
    DotsOCRConfig,
    SpecialTokens,
    VisionConfig,
)
from dots_ocr_tpu_torch.models.loader import read_safetensors, write_safetensors
from dots_ocr_tpu_torch.parallel.distributed import TPGroupLost
from dots_ocr_tpu_torch.parallel.sharding import leaf_roles, unshard_params
from dots_ocr_tpu_torch.train.train_step import (
    AdamState,
    TrainState,
    tree_from_items,
    tree_items,
)

STATE_FILE = "state.safetensors"


def _config_to_dict(config: DotsOCRConfig) -> dict:
    return {
        "vision": dataclasses.asdict(config.vision),
        "decoder": dataclasses.asdict(config.decoder),
        "special": dataclasses.asdict(config.special),
        "dtype": config.dtype,
    }


def _config_from_dict(d: dict) -> DotsOCRConfig:
    vision = dict(d["vision"])
    vision["full_attn_layers"] = tuple(vision.get("full_attn_layers", ()))
    for key in ("image_mean", "image_std"):
        if key in vision:
            vision[key] = tuple(vision[key])
    return DotsOCRConfig(
        vision=VisionConfig(**vision),
        decoder=DecoderConfig(**d["decoder"]),
        special=SpecialTokens(**d["special"]),
        dtype=d["dtype"],
    )


def gather_train_state(state: TrainState, config: DotsOCRConfig, tp) -> Optional[TrainState]:
    """The whole state on rank 0 (host tensors; None on every other rank)
    from the ranks' shards: a split leaf gathered over data rank 0's model
    group, a whole leaf rank 0's own. Every rank calls it together."""
    roles = leaf_roles(state.params, config, tp.world)
    root = tp.global_rank == 0
    trees = []
    for tree in (state.params, state.opt_state.mu, state.opt_state.nu):
        shards = [[] for _ in range(tp.world)]
        for name, t in tree_items(tree):
            host = t.detach().to("cpu", copy=True)
            pieces = [host] * tp.world
            if roles[name] != "whole" and tp.world > 1 and tp.data_rank == 0:
                pieces = [torch.empty_like(host) for _ in range(tp.world)] if root else None
                try:
                    dist.gather(host, pieces, dst=0, group=tp.model_control)
                except RuntimeError as e:
                    tp.lost = tp.lost or f"checkpoint gather failed: {e}"
                    raise TPGroupLost(tp.lost) from e
            if root:
                for shard, piece in zip(shards, pieces):
                    shard.append((name, piece))
        if root:
            trees.append(unshard_params([tree_from_items(s) for s in shards], tp.plan, config))
    if not root:
        return None
    return TrainState(trees[0], AdamState(state.opt_state.count.cpu(), trees[1], trees[2]),
                      state.step.cpu())


def save_checkpoint(path: str, state: TrainState, config: DotsOCRConfig, tp=None) -> None:
    """Write a resumable checkpoint directory (the state's tensors are
    copied to the host). Under ``tp`` every rank calls it with its shard:
    rank 0 writes the whole state (:func:`gather_train_state`), the others
    wait for it."""
    if tp is not None:
        whole = gather_train_state(state, config, tp)
        if whole is not None:
            save_checkpoint(path, whole, config)
        dist.barrier(group=tp.control)
        return
    path = os.path.abspath(path)
    step = int(state.step)
    os.makedirs(os.path.join(path, f"state_{step}"), exist_ok=True)
    with open(os.path.join(path, "model_config.json"), "w") as f:
        json.dump(_config_to_dict(config), f, indent=2)
    tensors = dict(tree_items(state.params))
    for name, tree in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        tensors.update((f"{name}.{key}", t) for key, t in tree_items(tree))
    tensors["count"] = state.opt_state.count.reshape(1)  # safetensors views bytes of
    tensors["step"] = state.step.reshape(1)              # a tensor of rank >= 1
    write_safetensors(os.path.join(path, f"state_{step}", STATE_FILE), tensors)
    with open(os.path.join(path, "latest"), "w") as f:
        f.write(str(step))


def latest_step(path: str) -> Optional[int]:
    marker = os.path.join(path, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        return int(f.read().strip())


def restore_checkpoint(
    path: str, device: torch.device
) -> Tuple[TrainState, DotsOCRConfig]:
    """Restore the newest checkpoint with its tensors on ``device`` (a
    checkpoint written from the card restores on the CPU, and the other way
    round)."""
    path = os.path.abspath(path)
    step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    with open(os.path.join(path, "model_config.json")) as f:
        config = _config_from_dict(json.load(f))
    tensors = {k: t.to(device=device, copy=True) for k, t in
               read_safetensors(os.path.join(path, f"state_{step}", STATE_FILE)).items()}
    groups = {"params": [], "mu": [], "nu": []}
    for name, t in tensors.items():
        head, _, rest = name.partition(".")
        if head in ("mu", "nu"):
            groups[head].append((rest, t))
        elif name not in ("count", "step"):
            groups["params"].append((name, t))
    opt_state = AdamState(tensors["count"].reshape(()), tree_from_items(groups["mu"]),
                          tree_from_items(groups["nu"]))
    return TrainState(tree_from_items(groups["params"]), opt_state,
                      tensors["step"].reshape(())), config
