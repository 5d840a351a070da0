"""Training checkpoint save/restore (port of ``dots_ocr_tpu.train.checkpoint``).

The directory layout is the JAX package's: ``model_config.json`` (the
config's dataclasses as dicts), the ``latest`` marker holding the newest
step, and one ``state_{step}/`` per save. There is no orbax here: a state is
one safetensors file, ``state_{step}/state.safetensors``, written and read by
the port's own ``models/loader.py`` routines, with the params under their
dotted tree names, the moments under ``mu.*`` / ``nu.*`` and the scalars
``count`` and ``step``. Tensors keep their dtype.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import torch

from dots_ocr_tpu_torch.models.config import (
    DecoderConfig,
    DotsOCRConfig,
    SpecialTokens,
    VisionConfig,
)
from dots_ocr_tpu_torch.models.loader import read_safetensors, write_safetensors
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


def save_checkpoint(path: str, state: TrainState, config: DotsOCRConfig) -> None:
    """Write a resumable checkpoint directory (the state's tensors are
    copied to the host)."""
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
