"""Training driver: SFT-style fine-tuning over the full VLM (port of
``dots_ocr_tpu.train.cli``), on one device or one process a rank.

JSONL samples -> chat-templated, image-packed batches -> ``train_step``,
with safetensors checkpoints and optional per-layer remat. Runs on the card
unless ``--device cpu`` is given.

Several processes (``torchrun --nproc-per-node N``: ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT``) train over a (data,
model) layout, as the JAX CLI's ``auto_mesh(model_parallel)``: model =
``--model-parallel``, data = ``WORLD_SIZE / model``, ``--tp-backend
nccl|gloo`` required (nccl: a GPU a rank, ``LOCAL_RANK``'s; gloo: every
rank on ``--device``, so ranks may share one GPU). Every rank builds the
same seeded init (or loads the same checkpoint), keeps its shard, draws the
same batches and takes its data rank's rows; rank 0 alone logs steps (the
global loss, tokens/s of the global batch) and writes whole-tensor
checkpoints, which restore at any layout.

Data format (one JSON object per line):
  {"prompt": "<task prompt>", "response": "<target text>",
   "images": ["path.png", ...]}        # images optional

Smoke mode (--synthetic N) trains on generated text-only batches, without
data or a checkpoint. Every logged step gives its loss, accuracy, grad_norm
(before clipping), ms a step and tokens/s over the steps since the last log.

Usage:
  python -m dots_ocr_tpu_torch.train.cli --synthetic 16 --size tiny --steps 10 --device cpu
  torchrun --nproc-per-node 2 -m dots_ocr_tpu_torch.train.cli --model-parallel 2 \\
      --tp-backend gloo --device cpu --size tiny --synthetic 1
  python -m dots_ocr_tpu_torch.train.cli --data sft.jsonl --weights ./weights/DotsOCR \\
      --batch-size 8 --seq-len 4096 --remat --ckpt ./ckpts
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Iterator, List

import numpy as np
import torch

logger = logging.getLogger(__name__)


def build_batch(samples: List[dict], tokenizer, config, seq_len: int,
                vision_bucket_step: int = 512, device: torch.device = torch.device("cuda")):
    """Tokenize + pack a list of samples into one TrainBatch on ``device``."""
    from dots_ocr_tpu_torch.engine.chat_template import build_prompt_ids
    from dots_ocr_tpu_torch.models import preprocess
    from dots_ocr_tpu_torch.models.rope import vision_rope_table
    from dots_ocr_tpu_torch.models.vlm import build_scatter_indices
    from dots_ocr_tpu_torch.train.train_step import batch_to_device
    from dots_ocr_tpu_torch.utils.image_io import fetch_image

    cfg = config.vision
    grid = cfg.patch_size * cfg.spatial_merge_size
    batch = len(samples)
    pad = config.special.pad_token_id
    eos = config.special.eos_token_id

    input_ids = np.full((batch, seq_len), pad, np.int32)
    targets = np.full((batch, seq_len), pad, np.int32)
    loss_mask = np.zeros((batch, seq_len), np.float32)
    seq_lens = np.zeros(batch, np.int32)
    all_images = []
    for row, sample in enumerate(samples):
        images = [
            fetch_image(p, min_pixels=3136, max_pixels=11289600)
            for p in sample.get("images", [])
        ]
        counts = [(im.width // grid) * (im.height // grid) for im in images]
        prompt_ids = build_prompt_ids(tokenizer, sample["prompt"], counts)
        response_ids = tokenizer.encode(sample["response"]) + [eos]
        ids = (prompt_ids + response_ids)[:seq_len]
        n = len(ids)
        input_ids[row, :n] = ids
        # next-token targets; supervise only the response span
        targets[row, : n - 1] = ids[1:]
        start = min(len(prompt_ids), n - 1)
        loss_mask[row, max(0, start - 1) : n - 1] = 1.0
        seq_lens[row] = n
        all_images.extend(images)

    vision = {}
    if all_images:
        packed = preprocess.pack_images(all_images, cfg, bucket_step=vision_bucket_step)
        merge = cfg.spatial_merge_size**2
        sb, sp = build_scatter_indices(
            input_ids, config.special.imgpad_id,
            packed.patches.shape[0] // merge,
            valid_rows=packed.merged_valid_rows(merge),
        )
        cos, sin = vision_rope_table(packed.pos2d, cfg.head_dim, cfg.rope_theta)
        vision = dict(patches=packed.patches, rope_cos=cos, rope_sin=sin,
                      segment_ids=packed.segment_ids, scatter_batch=sb, scatter_pos=sp)
    positions = np.broadcast_to(np.arange(seq_len, dtype=np.int32), input_ids.shape)
    return batch_to_device(dict(input_ids=input_ids, positions=positions, seq_lens=seq_lens,
                                target_ids=targets, loss_mask=loss_mask, **vision), device)


def data_batches(path: str, batch_size: int) -> Iterator[List[dict]]:
    """Cycle over JSONL rows in fixed-size batches."""
    rows = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    if not rows:
        raise ValueError(f"no samples in {path}")
    idx = 0
    while True:
        batch = [rows[(idx + j) % len(rows)] for j in range(batch_size)]
        idx = (idx + batch_size) % len(rows)
        yield batch


def check_layout(args) -> int:
    """``auto_mesh``'s rule: WORLD_SIZE ranks must divide by
    ``--model-parallel``; several need ``--tp-backend``. Returns the world
    size, or exits with the reason."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if args.model_parallel < 1 or world % args.model_parallel:
        raise SystemExit(f"--model-parallel {args.model_parallel} does not divide WORLD_SIZE "
                         f"{world} (TP training lays the ranks out as data x model; launch "
                         f"a multiple of {args.model_parallel} ranks, e.g. torchrun "
                         f"--nproc-per-node {max(args.model_parallel, 1)})")
    if world > 1 and args.tp_backend is None:
        raise SystemExit(f"WORLD_SIZE {world}: TP training needs --tp-backend nccl|gloo")
    if args.tp_backend == "nccl" and world > 1 and (
            args.device != "cuda" or torch.cuda.device_count() < min(
                world, int(os.environ.get("LOCAL_WORLD_SIZE", world)))):
        raise SystemExit("--tp-backend nccl needs a CUDA device a rank (--tp-backend gloo lets "
                         "ranks share one device)")
    return world


def rank_device(args) -> torch.device:
    """A rank's device: its own GPU under nccl (``LOCAL_RANK``), else
    ``--device``."""
    if args.tp_backend == "nccl" and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return torch.device(args.device)


def main(argv=None):
    ap = argparse.ArgumentParser(description="dots_ocr_tpu_torch SFT trainer")
    ap.add_argument("--data", type=str, default=None, help="JSONL samples")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on synthetic batches (smoke mode)")
    ap.add_argument("--weights", type=str, default=None)
    ap.add_argument("--size", choices=["tiny", "small", "flagship"],
                    default="flagship")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--lr", type=float, default=1e-5)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--tp-backend", choices=["nccl", "gloo"], default=None,
                    help="the device collectives' backend, required with WORLD_SIZE > 1")
    args = ap.parse_args(argv)
    world = check_layout(args)

    from dots_ocr_tpu_torch.parallel.distributed import destroy, initialize_distributed
    from dots_ocr_tpu_torch.utils.observability import setup_logging

    setup_logging()
    device = rank_device(args)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is available (--device cpu to train "
                         "on the CPU)")
    if device.type == "cpu" and world > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))  # ranks share the cores
    tp = initialize_distributed(args.tp_backend, world_size=world, device=device,
                                model_parallel=args.model_parallel)
    try:
        _train(args, device, tp)
    finally:
        destroy(tp)


def _train(args, device: torch.device, tp) -> None:
    from dots_ocr_tpu_torch.engine.scheduler import default_tokenizer
    from dots_ocr_tpu_torch.engine.tokenizer import load_checkpoint_tokenizer
    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.parallel.sharding import shard_batch
    from dots_ocr_tpu_torch.train.checkpoint import save_checkpoint
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        shard_for_training,
        train_step,
    )

    if args.weights:
        from dots_ocr_tpu_torch.models.loader import load_checkpoint

        config, params = load_checkpoint(args.weights, device=device)
        tokenizer = load_checkpoint_tokenizer(args.weights) or default_tokenizer(config)
    else:
        config = {
            "tiny": DotsOCRConfig.tiny,
            "small": DotsOCRConfig.small,
            "flagship": DotsOCRConfig.flagship,
        }[args.size]()
        params = init_params(config, device, torch.Generator(device=device).manual_seed(0))
        tokenizer = default_tokenizer(config)

    if tp is not None:
        params = shard_for_training(params, config, tp)  # the whole tensors are freed
    optimizer = make_optimizer(learning_rate=args.lr)
    state = init_train_state(params, optimizer)
    del params
    rank0 = tp is None or tp.global_rank == 0
    if rank0:
        logger.info("training on %s: %s, %d steps of %d x %d tokens%s%s", device, args.size
                    if not args.weights else args.weights, args.steps, args.batch_size,
                    args.seq_len, ", remat" if args.remat else "",
                    "" if tp is None else f", {tp.data} data x {tp.world} model ranks over "
                    f"{tp.backend}")

    if not args.synthetic:
        if not args.data:
            raise SystemExit("--data or --synthetic required")
        source = data_batches(args.data, args.batch_size)

    t0 = t_log = time.perf_counter()
    last_logged = 0
    for step in range(1, args.steps + 1):
        if args.synthetic:
            batch = make_dummy_batch(config, batch_size=args.batch_size,
                                     seq_len=args.seq_len, seed=step, device=device)
        else:
            batch = build_batch(next(source), tokenizer, config, args.seq_len, device=device)
        if tp is not None:
            batch = shard_batch(batch, tp.data, tp.data_rank)
        state, metrics = train_step(state, batch, config, optimizer, remat=args.remat, tp=tp)
        last = step == args.steps
        if rank0 and (step % args.log_every == 0 or last):
            values = {k: float(v) for k, v in metrics.items()}  # waits for the step
            now = time.perf_counter()
            steps = step - last_logged
            logger.info(
                "step=%d loss=%.4f acc=%.3f grad_norm=%.3f ms_per_step=%.1f "
                "tokens_per_s=%.0f elapsed=%.1fs",
                step, values["loss"], values["accuracy"], values["grad_norm"],
                (now - t_log) * 1e3 / steps,
                steps * args.batch_size * args.seq_len / (now - t_log), now - t0,
            )
            t_log, last_logged = now, step
        if args.ckpt and (step % args.ckpt_every == 0 or last):
            save_checkpoint(args.ckpt, state, config, tp=tp)
            if rank0:
                logger.info("checkpoint saved at step %d", step)
    if device.type == "cuda" and rank0:
        logger.info("peak_memory_allocated=%d bytes", torch.cuda.max_memory_allocated(device))


if __name__ == "__main__":
    main()
