"""OpenAI-compatible server on the PyTorch engine.

``main`` takes the JAX server's flags, builds the port's
``ContinuousBatchingEngine`` (or, with ``--engine batch``, the batch
``InferenceEngine``) on a torch device (CUDA by default), over random
weights or a checkpoint directory (``--weights``), and runs the port's copy
of the JAX package's ``OpenAIServer`` (``serve/openai_server.py``). The
shipped serving path is ported: chunked prefill, ``--speculate-k``,
``--quantize int8`` (weight-only decoder, embedding included),
``--kv-cache-dtype int8``, and every quantized configuration the JAX
server offers on one device: ``--quantize int4``
(decoder block linears through the int4 kernel, embedding and lm_head
int8) and ``--vision-quantize int8`` (W8A8 vision block linears). So is
the windowed encoder (``--vision-attn windowed --vision-window-patches
--vision-full-layers``: window kernel on the windowed layers) and int8 KV
at a page size that is not a multiple of 128 (the v1 paged kernel on
every decode step, as the JAX package runs it). So is the warmup: on the
card every decode and verify chunk is a CUDA graph replay, and
``--warmup full`` captures every graph ``step()`` can dispatch before the
server binds (after one vision and one text request, which build the
kernels), while ``--warmup background`` binds at once and warms on idle
engine ticks, starting with one warm request of each ``--warmup-pages``
size. ``--compile-cache DIR`` is where the CUDA kernels are built and
found (a relative path is taken from the repository root): a second
process with the same directory loads them without running ``nvcc``.

``--tensor-parallel-size N`` serves the model over N ranks, one process
each (rank 0 is this process and the only HTTP front end; it spawns ranks
1..N-1): each rank builds the same weights and keeps its Megatron shard
(``parallel/sharding.py``), and the ranks step their engines in lockstep
(``serve/async_engine.py``). ``--tp-backend nccl`` (the default) needs a
GPU a rank and keeps the decode chunks as CUDA graphs with their
all-reduces captured; ``--tp-backend gloo`` runs every rank on the one
device given (CUDA tensors staged through the host, decode chunks eager),
as on a one-GPU host or the CPU. ``--quantize int4`` and ``--engine batch``
are refused with TP, as in the JAX server.

    python -m dots_ocr_tpu_torch.serve.server --random-flagship --port 8000 \
        --quantize int4 --vision-quantize int8 --kv-cache-dtype int8 --speculate-k 2 \
        --warmup background --compile-cache .cache/xla
    python -m dots_ocr_tpu_torch.serve.server --random-flagship --port 8000 \
        --quantize int8 --speculate-k 2 --tensor-parallel-size 2 --tp-backend gloo
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import multiprocessing
import os
import socket
import sys
import time
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from dots_ocr_tpu_torch.engine.engine import InferenceEngine
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.engine.tokenizer import load_checkpoint_tokenizer
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import init_params
from dots_ocr_tpu_torch.models.loader import load_checkpoint
from dots_ocr_tpu_torch.models.quantize import (
    param_bytes,
    quantize_decoder_params,
    quantize_decoder_params_int4,
    quantize_vision_params,
)
from dots_ocr_tpu_torch.ops import kernel_lib
from dots_ocr_tpu_torch.parallel.distributed import (
    BACKENDS,
    destroy,
    initialize_distributed,
)
from dots_ocr_tpu_torch.parallel.sharding import shard_params
from dots_ocr_tpu_torch.serve.async_engine import follow
from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer

logger = logging.getLogger(__name__)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dots_ocr_tpu_torch OpenAI-compatible server")
    p.add_argument("--platform", type=str, default=os.environ.get("DOTS_OCR_PLATFORM", "cuda"),
                   help="torch device type: 'cuda' (default) or 'cpu' (plain "
                   "versions of the kernels, for development)")
    p.add_argument("--weights", type=str, default=None, help="checkpoint dir")
    p.add_argument("--random-tiny", action="store_true",
                   help="serve the tiny float32 random model (with --platform cpu)")
    p.add_argument("--random-flagship", action="store_true",
                   help="serve the full-width flagship model with random bf16 "
                   "weights made on the device from a fixed seed")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--model-name", type=str, default="model")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--engine", choices=["continuous", "batch"], default="continuous")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="serve over this many ranks, one process each (rank 0 serves HTTP); "
                   "continuous engine, int8 or bf16 weights")
    p.add_argument("--tp-backend", choices=BACKENDS, default="nccl",
                   help="nccl: one GPU a rank, decode chunks as CUDA graphs; gloo: every "
                   "rank on the one --platform device, collectives through the host, "
                   "decode chunks eager")
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--max-slots", type=int, default=32)
    p.add_argument("--max-seq-tokens", type=int, default=40960)
    p.add_argument("--steps-per-sync", type=int, default=16)
    p.add_argument("--prefill-chunk-tokens", type=int, default=2048,
                   help="chunked prefill: longer prompts run in chunks of this "
                   "many tokens between decode chunks; 0 = monolithic only")
    p.add_argument("--warmup", nargs="?", const="full", default=None,
                   choices=("full", "background"),
                   help="full: warm requests, then capture every decode graph before "
                   "binding; background: bind at once and warm on idle engine ticks")
    p.add_argument("--warmup-pages", type=str, default="560x420,1540x2044",
                   help="HxW page sizes of --warmup background's warm requests")
    p.add_argument("--compile-cache", type=str, default=None,
                   help="directory the CUDA kernels are built in and loaded from "
                   "(relative: from the repository root)")
    p.add_argument("--kv-cache-dtype", choices=["bf16", "int8"], default="bf16")
    p.add_argument("--quantize", choices=["none", "int8", "int4"], default="none")
    p.add_argument("--vision-quantize", choices=["none", "int8"], default="none")
    p.add_argument("--speculate-k", type=int, default=0)
    p.add_argument("--spec-min-tokens-per-iter", type=float, default=1.5)
    p.add_argument("--vision-attn", choices=["config", "full", "windowed"], default="config")
    p.add_argument("--vision-window-patches", type=int, default=16)
    p.add_argument("--vision-full-layers", type=str, default="")
    return p


def check_tp_args(args) -> None:
    """Refuse what tensor parallelism does not serve, before anything is
    built: the JAX server's refusals, and nccl without a GPU a rank (the
    backend is never swapped for gloo behind the caller's back)."""
    world = args.tensor_parallel_size
    if world < 1:
        raise SystemExit(f"--tensor-parallel-size {world} must be >= 1")
    if world == 1:
        return
    if args.engine != "continuous":
        raise SystemExit("--tensor-parallel-size needs --engine continuous (as in the JAX "
                         "server)")
    if args.quantize == "int4":
        # The nibble packing interleaves input-row halves, which a
        # row-parallel shard would split incoherently.
        raise SystemExit("--quantize int4 is single-chip only: it does not compose with "
                         "--tensor-parallel-size > 1 (as in the JAX server)")
    if args.tp_backend == "nccl":
        gpus = torch.cuda.device_count() if args.platform == "cuda" else 0
        if gpus < world:
            raise SystemExit(
                f"--tensor-parallel-size {world} --tp-backend nccl needs {world} CUDA devices "
                f"(--platform {args.platform}: {gpus}); --tp-backend gloo runs every rank on "
                "one device")


def rank_device(args, rank: int) -> torch.device:
    """A rank's device: its own GPU under nccl, the one device under gloo."""
    if args.platform == "cuda" and args.tp_backend == "nccl" and args.tensor_parallel_size > 1:
        return torch.device("cuda", rank)
    return torch.device(args.platform)


def apply_compile_cache(path: str) -> str:
    """``--compile-cache``: build and load the CUDA kernels in ``path``
    (relative to the repository root, as the TPU launcher resolves it).
    Returns the absolute directory."""
    path = path if os.path.isabs(path) else os.path.join(REPO, path)
    kernel_lib.set_build_dir(path)
    return kernel_lib.BUILD_DIR


def build_engine(args, tp=None):
    """The engine the flags ask for; with ``tp`` (a TP rank's group) the
    rank's shard of the same weights."""
    check_tp_args(args)
    if args.tensor_parallel_size > 1 and tp is None:
        raise SystemExit("--tensor-parallel-size > 1: the ranks are started by main()")
    if args.compile_cache:
        logger.info("kernel cache: %s", apply_compile_cache(args.compile_cache))
    device = tp.device if tp is not None else torch.device(args.platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--platform cuda: no CUDA device is available")
    tokenizer = params = None
    if args.random_tiny:
        config = DotsOCRConfig.tiny()
    elif args.random_flagship:
        config = DotsOCRConfig.flagship()
    elif args.weights:
        config, params = load_checkpoint(args.weights, device=device)
        tokenizer = load_checkpoint_tokenizer(args.weights)
    else:
        raise SystemExit("--weights is required (or use --random-flagship / --random-tiny)")
    if args.vision_attn != "config":
        if args.vision_attn == "full":
            vision = dataclasses.replace(config.vision, window_size=0, full_attn_layers=())
        else:  # windowed
            full = tuple(int(i) for i in args.vision_full_layers.split(",") if i.strip())
            vision = dataclasses.replace(config.vision, window_size=args.vision_window_patches,
                                         full_attn_layers=full)
        config = config.replace(vision=vision)
        logger.info("vision attention override: %s (window_size=%d patches, full layers=%s)",
                    args.vision_attn, vision.window_size, vision.full_attn_layers)
    if params is None:
        params = init_params(config, device, torch.Generator(device=device).manual_seed(0))
    if args.quantize in ("int8", "int4"):
        before = param_bytes(params)
        params = (quantize_decoder_params_int4 if args.quantize == "int4"
                  else quantize_decoder_params)(params)
        logger.info("%s weight quantization: %.2f GB -> %.2f GB", args.quantize,
                    before / 1e9, param_bytes(params) / 1e9)
    if args.vision_quantize == "int8":
        params = quantize_vision_params(params)
        logger.info("vision tower quantized W8A8 (block linears int8 x int8; "
                    "patch embed / merger stay %s)", config.dtype)
    if args.engine == "batch":
        return InferenceEngine(params, config, tokenizer=tokenizer, device=device)
    if tp is not None:
        before = param_bytes(params)
        params, tp.plan = shard_params(params, config, tp.rank, tp.world)
        logger.info("TP rank %d / %d: parameters %.3f GB of %.3f GB (%s row-parallel; "
                    "KV replication %d)", tp.rank, tp.world, param_bytes(params) / 1e9,
                    before / 1e9, ", ".join(sorted(tp.plan.row_parallel)) or "nothing",
                    tp.plan.kv_replication)
    return ContinuousBatchingEngine(
        params, config, device, tokenizer=tokenizer, tp=tp,
        sched=SchedulerConfig(
            num_pages=args.num_pages,
            page_size=args.page_size,
            max_slots=args.max_slots,
            steps_per_sync=args.steps_per_sync,
            max_pages_per_seq=max(2, -(-args.max_seq_tokens // args.page_size)),
            prefill_chunk_tokens=args.prefill_chunk_tokens,
            speculate_k=args.speculate_k,
            spec_min_tokens_per_iter=args.spec_min_tokens_per_iter,
            kv_cache_dtype=args.kv_cache_dtype,
        ),
    )


def warm_requests(engine) -> None:
    """``--warmup full``'s requests: a blank 560 x 420 page and a text
    prompt, greedy, 8 tokens each."""
    dummy = Image.fromarray(np.zeros((560, 420, 3), np.uint8))
    engine.generate_batch(["warmup", "warmup"], [[dummy], []],
                          temperature=0.0, max_new_tokens=8)


def warm_up(engine) -> dict:
    """``--warmup full``, as the JAX server: one vision and one text request
    end to end (they build the kernels), then, on the continuous engine,
    every decode program ``step()`` can dispatch (``warmup_decode``: on the
    card each is captured as a CUDA graph). Returns the seconds it took, the
    thunks run, the graphs captured and the bytes of the graph pool (None
    off the card)."""
    t0 = time.perf_counter()
    warm_requests(engine)
    thunks = engine.warmup_decode() if hasattr(engine, "warmup_decode") else 0
    graphs = getattr(engine, "_graphs", None)
    out = dict(seconds=time.perf_counter() - t0, thunks=thunks,
               graphs=0 if graphs is None else len(graphs),
               pool_bytes=None if graphs is None else graphs.pool_bytes())
    logger.info("warmup complete: %s", out)
    return out


def parse_pages(spec: str):
    """``--warmup-pages`` "HxW,HxW" -> ((H, W), ...)."""
    sizes = []
    for part in (spec or "").split(","):
        part = part.strip().lower()
        if "x" in part:
            h, w = part.split("x", 1)
            sizes.append((int(h), int(w)))
    return tuple(sizes) or ((560, 420),)


def start_warmup(engine, args) -> Optional[dict]:
    """``--warmup``: ``full`` warms now and returns :func:`warm_up`'s
    numbers; ``background`` queues the warmup for the engine thread's idle
    ticks (continuous engine only, as in the JAX server)."""
    if args.warmup == "full":
        return warm_up(engine)
    if args.warmup == "background" and hasattr(engine, "queue_warmup"):
        n = engine.queue_warmup(vision_sizes=parse_pages(args.warmup_pages))
        logger.info("background warmup: %d thunks queued; serving now, warming on idle "
                    "engine ticks", n)
    return None


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _logging() -> None:
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(levelname)s %(name)s: %(message)s")


def join_group(args, rank: int, init_method: str):
    if args.platform == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.tensor_parallel_size))
    return initialize_distributed(args.tp_backend, rank, args.tensor_parallel_size,
                                  init_method, device=rank_device(args, rank))


def follower_main(argv: List[str], rank: int, init_method: str) -> None:
    """Rank ``rank`` (> 0) of a TP server: the same engine on its shard,
    the same warmup, then rank 0's ticks until it stops (no HTTP)."""
    _logging()
    args = build_parser().parse_args(argv)
    tp = join_group(args, rank, init_method)
    try:
        engine = build_engine(args, tp)
        start_warmup(engine, args)
        follow(engine)
    finally:
        destroy(tp)


def serve_tp(args, argv: List[str]) -> None:
    """Rank 0 of a TP server: build the kernels once, spawn ranks
    1..N-1, join the group, then serve HTTP over the lockstep engines."""
    world = args.tensor_parallel_size
    if args.platform == "cuda":
        if args.compile_cache:
            apply_compile_cache(args.compile_cache)
        kernel_lib.load()  # built once here, found by every rank
    if args.tp_backend == "gloo" and args.platform == "cuda":
        logger.info("TP over gloo: %d ranks share %s; all-reduces go through the host and "
                    "decode chunks run eagerly (no CUDA graphs)", world, rank_device(args, 0))
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    followers = [ctx.Process(target=follower_main, args=(argv, rank, init_method), daemon=True)
                 for rank in range(1, world)]
    for rank, proc in enumerate(followers, start=1):
        proc.start()
        logger.info("TP rank %d: pid %d", rank, proc.pid)
    tp = join_group(args, 0, init_method)
    try:
        engine = build_engine(args, tp)
        start_warmup(engine, args)
        OpenAIServer(engine, model_name=args.model_name, max_batch=args.max_batch).run(
            host=args.host, port=args.port
        )
    finally:
        for proc in followers:
            proc.join(timeout=10)
            if proc.is_alive():
                proc.terminate()
        destroy(tp)


def main(argv=None):
    _logging()
    argv = list(argv) if argv is not None else sys.argv[1:]
    args = build_parser().parse_args(argv)
    check_tp_args(args)
    if args.tensor_parallel_size > 1:
        serve_tp(args, argv)
        return
    engine = build_engine(args)
    start_warmup(engine, args)
    OpenAIServer(engine, model_name=args.model_name, max_batch=args.max_batch).run(
        host=args.host, port=args.port
    )


if __name__ == "__main__":
    main()
