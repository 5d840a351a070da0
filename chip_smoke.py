#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``dots_ocr_tpu_torch``) on one GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases, each fatal on failure (exit code != 0, no result line):

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels from ``dots_ocr_tpu_torch/csrc`` (nvcc, sm_90a);
3. kernels vs plain versions at the serving paths' shapes: flash attention
   for a packed 2-image vision batch, a causal padded decoder prefill and a
   chunked-prefill chunk (q_offset 2048); paged decode attention (kernel 2)
   over 64 slots at nq = 1 and 3, bf16 pools and int8 pools with float32
   scales; the int4 matmul in both modes (W4A16, W4A8) at the four decoder
   linear shapes and 64, 192, 2,048 and 4,096 rows (W4A16 beside cuBLAS bf16
   on the dequantized weight and torch._weight_int4pack_mm; W4A8, exact and
   20 repeats bit-identical, beside torch._int_mm on the quantized rows and
   the unpacked int8 weight for context); the window kernel at the
   windowed vision batch (the same 2 images packed window-major, a padded
   edge window and a fully padded bucket window), beside flash with the
   windows as segments (and flash's own case on those windows); the v1
   paged kernel (kernel 3) in both modes over 64 slots x 2,048 tokens at
   page 64 and 128 (kernel 2's bf16 mode timed beside it at page 128), in
   bf16 at D 64, and in int8 at phase 10's served shape (3 live rows among
   64 slots, a table of 640 pages of 64); the W8A16 matmul (the int8
   weight-only linear and the tied int8 lm_head) at the flagship's five
   shapes x 1, 7, 9, 64, 65, 192, 193 and 2,048 rows, each case's plan
   printed, beside cuBLAS bf16 on the weight converted once and
   ``torch._weight_int8pack_mm`` where the card's torch has a CUDA kernel
   for it ("none" otherwise), 20 repeats bit-identical, device times as
   CUDA graphs;
   the seeded draw with its keys folded in the kernel and the threefry
   entry, bit for bit; max abs
   error against the stated tolerance (kernels 1-4 also against a bound
   scaled to the output, which a control must fail),
   median CUDA-event times per call over back-to-back calls, the least
   time the card could take (bound) and, where one PyTorch call computes the
   same function, that call's time; and, for context, the W8A8 vision
   linear against the bf16 one at the vision shapes;
4. end to end, the shipped path: the flagship model (full width and depth,
   random bf16 weights from a seed, quantized to int8) with int8 KV, k = 2
   speculation and 2,048-token chunked prefill at the shipping geometry,
   served by the port's ``OpenAIServer`` on 127.0.0.1 (its repetition guard
   off: DRY_TOKENS); /health, three concurrent chat completions (a page, a
   receipt, a text prompt), /metrics (prefill chunks and verify chunks
   counted); the flash kernel (with q_offset > 0), the int8 paged kernel
   and the W8A16 kernel in both regimes must launch in that run;
5. consistency of that path: the page request's chunked-prefill logits and
   four int8-KV decode steps through the kernels vs their plain versions;
6. end to end, the fully quantized path: as phase 4 with int4 decoder
   block linears (int8 embedding) and W8A8 vision; the int4 kernel (W4A16),
   flash (with q_offset > 0) and the int8 paged kernel must launch; then a
   second greedy wave of the three requests with ``DOTS_INT4_ACT=1`` set
   around it (W4A8, read by ``int4_linear`` at each call), in which the
   W4A8 kernel's prefill regime (the 2,048-token chunks) and its decode
   regime (decode and verify steps) must both launch;
7. consistency of that path, as phase 5, with the int4 linears switched to
   their plain version through ``int4_matmul.IMPLEMENTATIONS``, both decoder
   passes on the kernel path's image embeddings; the argmax must agree too.
   The W8A8 encoder's kernel-vs-plain gap must stay within the noise of its
   activation quantization;
8. end to end, the bf16 path (bf16 weights and KV, no speculation, one
   4,096-token prefill), as phase 4; the flash and bf16 paged kernels must
   launch; then the same consistency check in bf16;
9. the cost of quantized weights in decode: one decode step for 64 slots
   with the bf16 weights, their int8 quantization (the W8A16 kernel)
   and their int4 quantization in both modes (W4A8's decode regime at a
   64-slot step), and the bf16 step with ``attn_impl="v1"``
   (kernel 3's bf16 mode on a path through the model);
10. end to end, windowed vision and int8 KV at page 64: int8 weights, int8
   KV, page 64 (kernel 3 on every decode step, as the JAX package runs it),
   no speculation, 2,048-token chunks, the encoder windowed (16 x 16-patch
   windows, layers 6, 13, 20, 27, 34, 41 image-wide), served as phase 4;
   the window kernel, flash and kernel 3's int8 mode must launch; then the
   consistency check of phase 5 on that path;
11. end to end, ``deploy/shipping.env`` as written: its PAGE_SIZE, KV_DTYPE,
   QUANTIZE, SPECULATE_K, PREFILL_CHUNK, NUM_PAGES, MAX_SLOTS,
   MAX_SEQ_TOKENS, STEPS_PER_SYNC, VISION_ATTN, WARMUP and COMPILE_CACHE,
   nothing overridden (today int8 weights, bf16 KV, k = 2, ``--warmup
   full``, so no graph may be captured while it serves), served as phase 4,
   then the same
   three requests again sampled at temperature 1 for 128 tokens, so that
   the engine's speculation gate turns speculation off and plain decode
   steps run too (SHIPPING_WAVES); flash (with q_offset > 0),
   kernel 2's bf16 mode at nq = 1 (decode) and nq = 3 (verify), the W8A16
   kernel in both regimes, the draw and the threefry entry must launch; then the consistency check of phase 5 on that configuration;
12. a pool that runs dry: phase 4's flags with ``--num-pages`` cut to what
   the three prompts and the admission watermark take, so that the
   requests cannot all grow to their ``max_tokens`` (the repetition guard
   off, as in phase 4); the engine must
   preempt (``preemptions`` >= 1 in /metrics), answer every request HTTP
   200 with the greedy text phase 4's full pool gave for the same
   requests at the same ``max_tokens`` (its second wave), and serve one
   more request afterwards. Kernel 2's int8 mode must launch here too;
13. pipelined decode A/B at full width: deploy/shipping.env's geometry with
   speculation off and the repetition guard off, two engines on one set of
   weights in this process, (a)
   synchronous chunks of STEPS_PER_SYNC and (b) the defaults (deep chunks,
   lookahead-1), in turns a, b, b, a, each serving the three requests
   greedy for 256 tokens: identical token ids, (b) pipelined with fewer
   input uploads than chunks, (a) not pipelined; wall, decode tok/s, steps,
   uploads and the host's wait in fetches per chunk printed. Then
   deploy/shipping.env as written (k = 2) with the defaults over HTTP, the
   same requests for 256 tokens: every request HTTP 200, chunks pipelined;
14. on that server, the logit options over HTTP: logprobs (one per token,
   finite, <= 0, and no verify chunk while the request decodes alone, where
   a plain request's does run), a logit_bias ban of the unbiased first
   token and a +100 boost, presence/frequency penalties (HTTP 200, no verify
   step), and ``seed`` (two requests with seed 1 at temperature 1 give the
   same text, seed 2 another; the seeded draw kernel launches);
15. the loader, the batch engine and the parser's local mode: random
   flagship weights (full width and depth, from a seed) written as a
   synthetic HF checkpoint (config.json + bf16 safetensors through
   ``export_hf_state_dict``); ``DotsOCRParser(use_local=True, seed=...)``
   loads it with ``InferenceEngine.from_pretrained`` on the card and parses
   a 2-page PDF (written by this script) twice: byte-identical artifacts;
   then the batched PDF path over a continuous engine on the same weights
   (``engine=``), twice, byte-identical; flash and the draw kernel must
   launch; load seconds and tok/s printed;
16. the parser's server mode: the port's server with deploy/shipping.env's
   flags and ``--weights`` (that checkpoint), the port's CLI
   (``python -m dots_ocr_tpu_torch``) as subprocesses with ``--seed``: the
   PDF and a PNG, each parsed twice serially (identical artifacts), then
   the PDF with its pages co-batched (``--num_thread 2``: the share of
   pages with the serial text is reported); flash, kernel 2 and the draw
   kernel must launch; launches and per-page latency printed;
17. CUDA graphs and the warmup flags, on deploy/shipping.env's engine: (a)
   ``--warmup full`` (seconds, graphs captured, the graph pool's bytes),
   then the three requests greedy for GRAPH_TOKENS tokens and sampled at
   temperature 1 with GRAPH_SEED, through that engine and through the same
   engine run eagerly (``cuda_graphs=False``, the same warm requests
   first): identical token ids, every chunk a replay, nothing captured
   after the warmup; (b) phase 9's 64-slot x 2,048-context step as one
   decode chunk (nq = 1) and as one k = 2 verify chunk (nq = 3: 192 rows a
   linear, deploy/shipping.env's step) of CHUNK_DEPTH iterations each,
   replayed and eager, in turns: ms a step, the host's dispatch ms and the
   device's busy share (torch.profiler), the W8A16 kernels' launches (every
   int8 linear and the lm_head of every step) and ms a chunk and the
   ``direct_copy_kernel`` launches left, and the decode chunk sampled (one
   draw launch a step); (c) ``--warmup background``: /health answers while warm
   thunks are pending, a request sent then comes back HTTP 200, and
   ``dots_ocr_engine_warm_pending`` reaches 0; (d) ``--compile-cache``: a
   fresh process builds into an empty cache directory, a second one loads
   from it with no nvcc on its PATH, and phase 11's server left the library
   in shipping.env's COMPILE_CACHE;
18. training (no kernel: the JAX loss's dense-attention path under
   autograd): (a) ``python -m dots_ocr_tpu_torch.train.cli`` on the
   flagship at full width and depth, text-only synthetic batches of 2 x
   2,048 tokens, --remat, 5 steps: every loss and grad_norm finite; ms a
   step (steps 2-5), tokens/s and peak memory printed; (b) in this process,
   10 ``train_step``s on one fixed batch with 256 image tokens a row (1,024
   patches a row, 2,048 packed), remat, lr 1e-4: every vision and decoder
   leaf gets a nonzero gradient, the loss falls by 1.0 or more, no kernel
   launches; ms a step and peak memory printed; (c) in a subprocess with
   deterministic algorithms on, the full width cut to 2 vision and 2
   decoder layers, float32 with TF32 off, one 256-token row with 64 image
   tokens: one ``train_step`` on the card against the port on the CPU
   (loss and grad_norm within 1e-4 relative, the updated parameters as
   ``TRAIN_OUTLIER_SHARE`` says), then ``save_checkpoint`` on the card,
   ``restore_checkpoint`` and one more step, bit-equal to the step taken
   without the round trip;
19. tensor-parallel serving, in spawned rank processes on this card (NCCL
   refuses two ranks on one device, so they share it over gloo: the
   all-reduces go through the host and the decode chunks run eagerly): (a)
   TP = 2 at the flagship's full width and depth with deploy/shipping.env's
   serve flags (no warmup), phase 11's two waves of the three requests
   through rank 0's ``OpenAIServer`` while rank 1 follows; every rank must
   launch kernel 1, kernel 2 at nq = 1 and 3, W8A16, the draw and the
   all-reduce, with equal counters and launches on both ranks; the page
   request's last 64 teacher-forced logits within LOGIT_TOL of TP = 1 on
   the same seeded weights; each rank's parameter and pool bytes, phase 9's
   step eager at TP = 2 and TP = 1, the all-reduces a step and one
   all-reduce's ms printed; (b) TP = 4 at the flagship's width with 2 + 2
   layers, int8 weights and KV, k = 2: each KV head on two ranks (a pool of
   one head), gate/up padded from 2,240 to 2,304, logits within LOGIT_TOL;
   (c) TP = 2 over NCCL with every decode chunk a CUDA graph replay, where
   the host has 2 GPUs (else one line says it did not run, and why); (d) TP =
   2 at 2 + 2 layers where decode takes kernel 3's route (int8 KV at page
   64, no speculation): kernel 3 on every rank and kernel 2 never, the
   teacher-forced logits and a k = 2 verify plus a decode step through the
   paged route within LOGIT_TOL of TP = 1.
   ``--tp-only`` runs phases 1-2, phase 3's shard cases and phase 19 alone
   (a developer's shortcut; the full run takes no arguments);
20. tensor- and data-parallel training, in spawned rank processes sharing
   this card over gloo: (a) TP = 2 at the flagship's full width and depth,
   bf16, remat, 3 steps of 2 x 2,048 text tokens; step 1's loss and
   grad_norm within TRAIN_TP_LOSS_TOL / TRAIN_TP_NORM_TOL of the card's TP
   = 1 step; ms a step, tokens/s, peak memory a rank, all-reduces a step and
   one all-reduce's ms printed; (b) phase 18 (c)'s model (2 + 2 layers,
   float32) with image tokens at TP = 2, TP = 4 (each KV head on two ranks)
   and model 2 x data 2, each held to the card's one-process step under
   phase 18 (c)'s rule, and the TP = 2 checkpoint restored in one process
   bit-equal to the gathered state; (c) TP = 2 over NCCL where the host has
   2 GPUs (else one line says why not). ``--train-tp-only`` runs phases 1
   and 20 alone; ``--train-repeat N`` runs phase 18 (c)'s card-vs-CPU step
   N times, each in its own subprocess, with its diagnostics (the warnings
   raised, the outliers leaf by leaf, each leaf's digest on either side
   across runs, a second CPU step bit-compared, the CPU's threads).

Phase 3 also holds kernels 1, 2 and W8A16 at a rank's shapes
(``tp_shard_cases``): kernel 1 at 6 and 3 heads (vision) and 6q / 3q over
one KV head (a prefill chunk), kernel 2 over one KV head in both modes, and
W8A16 at TP = 2's wq / wk-wv / gate-up / wo / down and TP = 4's padded
gate/up and down, at 64, 192 and 2,048 rows.

On the card every decode and verify chunk of every serving phase but 19 is
a CUDA graph replay (``engine/graphs.py``): each phase requires as many
replays as decode chunks, and the launch counts it reads include the replays (a
graph's launches are counted at capture and added at every replay).

The seeded draw kernel (``csrc/threefry_sample.cu``) is held in phase 3 to
its plain version bit for bit (tokens and Gumbel noise, 20 repeats) at
[64, 151,936] with the rows' keys folded in the kernel from slot keys and
positions (with and without a tag), with a shared key and with per-row
keys, with mixed temperatures and -inf entries, and at the [64, 256]
nucleus pool; its bound counts the instructions of its main loop in the
built library's SASS. The W8A16 kernel must launch on phases 4, 9, 11, 13
and 17.

With the engine's defaults every serving phase pipelines its event-free
decode chunks where the budgets allow (phase 11 must show pipelined
chunks: its 128-token sampled wave gives them).

The line before the last is one JSON object with the per-kernel numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

REPO = os.path.dirname(os.path.abspath(__file__))
# bf16 kernel vs plain: |err| <= ATOL + RTOL * |plain| elementwise. Inputs
# are N(0, 1); both sides round their output to bf16 (2^-8 relative) and
# sum in different orders; P enters P @ V rounded to bf16 on both sides.
ATOL, RTOL = 2e-2, 2e-2
# ATOL is about one typical output of kernels 1 and 2 at their long rows
# (an output averages V over ~5k tokens: ~0.02), so their cases are also
# held to a bound scaled to the output (tight_errors): per element one
# bf16 ulp of the plain value (2^-7 |plain|: both sides round an f32
# result to bf16) plus TIGHT_ROW times the RMS over D of that (row, head)
# of the plain output, and over the whole output a relative RMS error of
# at most TIGHT_RMS. Both sides round P to bf16, against different running
# maxima: that moves an f32 output by ~0.2% of its row's RMS, ~1% at the
# max over 10^7 values, and the relative RMS error by ~3e-3. A control
# must fail the bound: the plain version with V rounded through fp8 e4m3
# (3 mantissa bits: ~3e-2 relative RMS), a coarser rounding than either
# side's.
TIGHT_ROW, TIGHT_RMS = 0.05, 1e-2
# Those cases also repeat the kernel call REPEAT_CALLS times on the same
# inputs: each output must equal the first bit for bit (a race would not).
REPEAT_CALLS = 20
# Kernel path vs plain path through the whole model (bf16, random weights):
# max |logit difference| <= LOGIT_TOL * std(plain logits). The model itself
# amplifies bf16 rounding: perturbing every attention output of the plain
# path by +-1 bf16 ulp at random moves the page's prefill logits by 0.19 std
# at the max over 151,936 logits (H100 80GB HBM3, 700 W) - the kernel path
# moves them by the same 0.19. A wrong mask or a dropped tile moves them by
# several std. The int8 path holds the same bound: its paged kernel and
# plain version share the tile and every rounding step (they differ by the
# softmax denominator's summation order), so the flash kernel's bf16
# rounding is what the model amplifies there too.
LOGIT_TOL = 0.5
PAGE_SIZE, NUM_PAGES, MAX_SLOTS, MAX_SEQ_TOKENS = 128, 2048, 64, 40960
# The shipped chunk. The byte-level tokenizer (the repo has no checkpoint
# tokenizer) spends one token per prompt character, so the page request
# (1,260 image tokens + the ~900-token layout prompt) takes 2 chunks.
PREFILL_CHUNK = 2048
# The bf16 path of the first slice: one monolithic prefill up to 4,096.
PREFILL_LIMIT = 4096
SHIPPED_FLAGS = ["--quantize", "int8", "--kv-cache-dtype", "int8", "--speculate-k", "2",
                 "--spec-min-tokens-per-iter", "1.5",
                 "--prefill-chunk-tokens", str(PREFILL_CHUNK)]
FULL_QUANT_FLAGS = ["--quantize", "int4", "--vision-quantize", "int8", *SHIPPED_FLAGS[2:]]
# Phase 6's waves: the greedy wave in W4A16, then the same requests in W4A8
# (the only W4A8 launches of phase 6: the kernels line takes them from it).
FULL_QUANT_WAVES = ((0.0, 32), (0.0, 32, {"DOTS_INT4_ACT": "1"}))
# int4 kernel vs plain. W4A8: exact (integer group sums, each scaled with one
# rounding, added in the Pallas order on both sides). W4A16: the products
# are exact in float32 and only their summation order differs: 1 bf16 ulp of
# the output (<= 2^-7 |plain|) plus 1e-4 for the float32 order near zero.
INT4_TOL = {False: (1e-4, 2.0**-7), True: (0.0, 0.0)}
# The decoder's block linears (K, N) and the rows of a decode step, a k = 2
# verify step, the shipped 2,048-token prefill chunk and a 2-row chunk.
INT4_SHAPES = {"wq/wo": (1536, 1536), "wk/wv": (1536, 256), "gate/up": (1536, 8960),
               "down": (8960, 1536)}
INT4_ROWS = (64, 192, PREFILL_CHUNK, 4096)
# The W8A16 kernel's cases: the flagship's int8 linears (K, N) and its tied
# int8 lm_head (the unembed, q [N, K]), at the rows of a decode step of one
# slot and of 64, a k = 2 verify and the shipped prefill chunk (the lm_head
# takes a prefill's last rows only, never a chunk's). Kernel and plain
# version add the same exact float32 products in another order: a bf16
# output within one bf16 ulp of the plain value (2^-7 |plain|) plus 1e-4 for
# the order near zero; the float32 logits within 1e-5 |plain| + 1e-4.
W8A16_SHAPES = {"wq/wo": (1536, 1536), "wk/wv": (1536, 256), "gate/up": (1536, 8960),
                "down": (8960, 1536), "lm_head": (1536, 151936)}
W8A16_ROWS = (1, MAX_SLOTS, 3 * MAX_SLOTS, PREFILL_CHUNK)
# Rows that are not a multiple of 8 on either side of the tiles (the
# kernel's zero rows past M) and the first prefill row count.
W8A16_RAGGED = (7, 9, MAX_SLOTS + 1, 3 * MAX_SLOTS + 1)
W8A16_TOL = {False: (1e-4, 2.0**-7), True: (1e-4, 1e-5)}
# The vision block linears (K, N) at the packed 2-image batch.
VISION_T, VISION_SHAPES = 6656, {"wq/wk/wv/wo": (1536, 1536), "gate/up": (1536, 4224),
                                 "down": (4224, 1536)}
BF16_FLAGS = ["--quantize", "none", "--kv-cache-dtype", "bf16", "--speculate-k", "0",
              "--prefill-chunk-tokens", str(PREFILL_LIMIT)]
# Phase 10: the windowed encoder of deploy/shipping.env's VISION_WINDOW /
# VISION_FULL_LAYERS, int8 KV at page 64.
WINDOW_PATCHES, FULL_LAYERS = 16, (6, 13, 20, 27, 34, 41)
WINDOWED_FLAGS = ["--quantize", "int8", "--kv-cache-dtype", "int8", "--page-size", "64",
                  "--num-pages", "4096", "--speculate-k", "0",
                  "--prefill-chunk-tokens", str(PREFILL_CHUNK), "--vision-attn", "windowed",
                  "--vision-window-patches", str(WINDOW_PATCHES),
                  "--vision-full-layers", ",".join(map(str, FULL_LAYERS))]
# Kernel 3 at a 64-slot decode step: 2,048 tokens per row; and at phase
# 10's served shape: the three requests' rows (the page request's ~2.2k
# tokens, the receipt's, the text's) among 64 slots, a table of
# MAX_SEQ_TOKENS / 64 pages of 64.
V1_CONTEXT = 2048
V1_SERVED_LENGTHS, V1_SERVED_PAGE = (2200, 420, 40), 64
# Phase 11: the deployment file, and its serve flags by key (read as written).
SHIPPING_ENV = os.path.join(REPO, "deploy", "shipping.env")
SHIPPING_KEYS = {"PAGE_SIZE": "--page-size", "KV_DTYPE": "--kv-cache-dtype",
                 "QUANTIZE": "--quantize", "SPECULATE_K": "--speculate-k",
                 "PREFILL_CHUNK": "--prefill-chunk-tokens", "NUM_PAGES": "--num-pages",
                 "MAX_SLOTS": "--max-slots", "MAX_SEQ_TOKENS": "--max-seq-tokens",
                 "STEPS_PER_SYNC": "--steps-per-sync", "VISION_ATTN": "--vision-attn",
                 "WARMUP": "--warmup", "COMPILE_CACHE": "--compile-cache"}
# Phase 11's waves of the three requests, (temperature, max_tokens): the
# greedy wave of phases 4-10, then the same requests sampled for long
# enough that the engine's speculation gate (spec_min_tokens_per_iter,
# 1.5) sees the drafts of near-uniform samples fail for three chunks and
# turns speculation off, so plain decode steps (nq = 1) run too: on random
# weights greedy text repeats and its drafts are accepted (1.70 tokens per
# slot-iteration on the card), so a greedy wave runs verify steps only.
SHIPPING_WAVES = ((0.0, 32), (1.0, 128))
# Phases 4 and 12: the greedy wave, then the same requests for DRY_TOKENS
# tokens, with the engine's repetition guard off (it may stop a looping
# random-weight stream early, from 128 tokens on, and free its pages).
# Phase 12's pool (26 pages) holds the null page, the prompts (17 + 4 + 1
# pages), the watermark (1) and DRY_SLACK_PAGES more. The receipt and the
# text are sent first and the page request once both are admitted; it
# still fits if each of them has taken its next page meanwhile (a chunk
# reserves 48 tokens ahead: the text at 14 tokens, the receipt at 57).
# With all three admitted 3 pages are free, and each request needs 3 more
# pages before it can finish its DRY_TOKENS (the page its 18th at its first
# decode chunk). The first to finish would need all 3 free pages for
# itself while the page request takes one at once: so the pool runs dry
# before any request finishes, and the youngest is preempted, whatever the
# streams' speculation accepts and whenever the requests land.
DRY_TOKENS, DRY_SLACK_PAGES = 384, 2
# Phase 13's requests decode this many tokens each, so that deep chunks of
# 64 and the lookahead engage; its turns of (a) and (b).
PIPELINE_TOKENS, PIPELINE_TURNS = 256, ("a", "b", "b", "a")
# Phase 17: the graphed engine against the eager one, the three requests
# greedy for GRAPH_TOKENS tokens and sampled at temperature 1 with
# GRAPH_SEED; and phase 9's 64-slot step timed as one decode chunk of
# CHUNK_DEPTH iterations (shipping.env's STEPS_PER_SYNC).
GRAPH_TOKENS, GRAPH_SEED, CHUNK_DEPTH = 64, 1234, 16
SHIPPED_WAVES = ((0.0, 32), (0.0, DRY_TOKENS))
ADMIT_FREE_FRACTION = 0.05  # SchedulerConfig.admit_free_page_fraction
# The bound: NVIDIA H100 SXM data sheet (dense, 700 W): HBM 3.35 TB/s,
# 989 TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s float32 outside the tensor
# cores (the scalar rate the seeded draw is held to).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
REPS = 10
# Calls per timed sample: a kernel's time is taken over back-to-back calls,
# so that what is timed is the device's work rather than one call's host
# time before its launch.
INNER = 5
# A plain version slower than this (ms a call) is timed one call a sample:
# phase 3's slow plain versions (up to ~170 ms a call) took ~40 s of the run.
SLOW_CALL_MS = 10.0


T_START = time.perf_counter()


def log(msg: str = "") -> None:
    if msg.startswith("[") and "/20]" in msg[:8]:  # a phase's heading
        msg += f" (at {time.perf_counter() - T_START:.1f} s)"
    print(msg, flush=True)


def cuda_ms(fn, calls: int = 1) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def time_in_turns(fns: dict, inner: int = INNER, slow_ms: Optional[float] = None) -> dict:
    """Median CUDA-event ms per call of REPS samples of each function, a
    sample being ``inner`` calls back to back (so the wrapper's host time
    before each launch overlaps the previous call's device time), after
    one warm call, taking them in turns (the order reversed every other
    round). With ``slow_ms``, a function whose warm call took longer takes
    one call a sample (its host time is noise beside its device time)."""
    calls = {}
    for name, fn in fns.items():
        warm_ms = cuda_ms(fn)
        calls[name] = 1 if slow_ms is not None and warm_ms > slow_ms else inner
    times = {name: [] for name in fns}
    for r in range(REPS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_ms(fns[name], calls[name]) / calls[name])
    return {name: statistics.median(ts) for name, ts in times.items()}


def graph_ms(fn, calls: int = 10) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, the replay timed with CUDA events (median of REPS), so that the
    wrapper's host time before each launch is not in it."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ms = statistics.median(cuda_ms(graph.replay) / calls for _ in range(REPS))
    del graph
    return ms


def bound(flops: float, nbytes: float, kind: str = "bf16") -> dict:
    """The least time the card could take for work of ``flops`` operations
    (at the ``kind`` tensor-core peak) that must move ``nbytes`` (each
    input read once, each output written once) through HBM."""
    t_ops, t_bytes = flops / PEAK_OPS_PER_S[kind], nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "peak": kind}


def tight_errors(out, ref) -> dict:
    """``out`` against ``ref`` [..., D] by the bound of TIGHT_ROW and
    TIGHT_RMS: the relative RMS error, and the largest ratio of an
    element's error to its allowance (2^-7 |ref| + TIGHT_ROW * the RMS of
    ref over D there; inf where ref's row is 0 and out's is not). Passes
    when ``rel_rms_err`` <= TIGHT_RMS and ``tight_ratio`` <= 1."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    allow = 2.0**-7 * ref.abs() + TIGHT_ROW * ref.pow(2).mean(-1, keepdim=True).sqrt()
    ratio = torch.where(err > 0, err / allow, 0.0)
    return {"rel_rms_err": float(err.norm() / ref.norm().clamp_min(1e-30)),
            "tight_ratio": float(ratio.max())}


def _tight_pass(e: dict) -> bool:
    return e["rel_rms_err"] <= TIGHT_RMS and e["tight_ratio"] <= 1.0


def fp8_round(x):
    """``x`` rounded through float8 e4m3 and back: the tight bound's control."""
    import torch

    return x.to(torch.float8_e4m3fn).to(x.dtype)


def compare(name: str, kernel_fn, plain_fn, atol: float = ATOL, rtol: float = RTOL,
            work: dict = None, library_fn=None, extra: dict = None, control_fn=None,
            control: str = "plain on V through fp8") -> dict:
    """Run kernel and plain once, check |err| <= atol + rtol * |plain|, then
    time REPS runs of each in turns (with ``library_fn``, one PyTorch call
    that computes the same function, and the ``extra`` functions, timed in
    the same turns for comparison). ``work`` is the case's :func:`bound`.
    With ``control_fn`` (``control`` says what: by default the plain
    version on V rounded through fp8) the kernel must also pass
    :func:`tight_errors`' bound, the control must fail it, and REPEAT_CALLS
    more kernel calls must repeat the output bit for bit."""
    import torch

    out, ref = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    max_abs = float(err.max())
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    if not bool((err <= atol + rtol * ref.float().abs()).all()):
        raise AssertionError(f"{name}: kernel disagrees with plain (max abs err {max_abs})")
    del err
    tight = {}
    if control_fn is not None:
        tight = tight_errors(out, ref)
        ctrl = tight_errors(control_fn(), ref)
        same = sum(bool(torch.equal(kernel_fn(), out)) for _ in range(REPEAT_CALLS))
        log(f"  {name}: kernel rel RMS err {tight['rel_rms_err']:.3e} (tol {TIGHT_RMS:g}), max "
            f"err / (2^-7|ref| + {TIGHT_ROW:g} rms_D(ref)) {tight['tight_ratio']:.3f} (tol 1); "
            f"control, {control}: {ctrl['rel_rms_err']:.3e}, "
            f"{ctrl['tight_ratio']:.3f} (must fail); {same} of {REPEAT_CALLS} repeated "
            f"calls bit-identical")
        if same != REPEAT_CALLS:
            raise AssertionError(f"{name}: {REPEAT_CALLS - same} of {REPEAT_CALLS} repeated "
                                 f"calls differ from the first")
        if not _tight_pass(tight):
            raise AssertionError(f"{name}: kernel fails the tight bound ({tight})")
        if _tight_pass(ctrl):
            raise AssertionError(f"{name}: the control ({control}) passes the tight bound "
                                 f"({ctrl})")
        tight.update({f"control_{key}": value for key, value in ctrl.items()})
    del out, ref
    fns = {"ms": kernel_fn, "plain_ms": plain_fn, **(extra or {})}
    if library_fn is not None:
        fns["library_ms"] = library_fn
    times = time_in_turns(fns, slow_ms=SLOW_CALL_MS)
    res = {"case": name, "max_abs_err": max_abs, "library_ms": None, **tight, **times,
           **(work or {})}
    log(f"  {name}: max_abs_err {max_abs:.3e} (tol {atol:g} + {rtol:g}*|ref|), "
        f"kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
        + "".join(f"{k} {v:.3f} ms, " for k, v in times.items() if k not in ("ms", "plain_ms"))
        + (f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) " if work else "")
        + f"(median of {REPS} samples of {INNER} calls, of 1 over {SLOW_CALL_MS:g} ms)")
    torch.cuda.empty_cache()
    return res


def _flash_work(q, k, q_seg, kv_seg, causal=False, q_offset=0) -> dict:
    """Kernel 1's bound: 4 H D operations per (query, key) pair the masks
    keep (QK^T and PV), and q, k, v, out and the segment ids once."""
    import torch

    mask = (q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] >= 0)
    if causal:
        rows = torch.arange(q.shape[1], device=q.device) + q_offset
        mask &= torch.arange(k.shape[1], device=q.device)[None, None, :] <= rows[None, :, None]
    pairs = int(mask.sum())
    nbytes = 2 * (q.numel() + k.numel()) * 2 + 4 * (q_seg.numel() + kv_seg.numel())
    return bound(4.0 * pairs * q.shape[2] * q.shape[3], nbytes)


def _paged_work(q, lengths, kv_heads, int8: bool) -> dict:
    """Kernels 2 and 3's bound: 4 H D operations per live (query, token)
    pair; each row's live K and V read once (int8: one byte per value and
    a float32 scale per token and head), q and out once."""
    import torch

    batch, nq, heads, head_dim = q.shape if q.dim() == 4 else (q.shape[0], 1, *q.shape[1:])
    lens = lengths.long()
    seen = torch.where(lens > 0, lens + nq - 1, 0)
    pairs = int(sum(torch.where(lens > 0, lens + j, 0).sum() for j in range(nq)))
    per_token = kv_heads * (head_dim * (1 if int8 else 2) + (4 if int8 else 0))
    nbytes = 2 * int(seen.sum()) * per_token + 2 * 2 * q.numel() + 4 * lengths.numel()
    return bound(4.0 * pairs * heads * head_dim, nbytes, "int8" if int8 else "bf16")


def _sdpa(q, k, v, mask=None, causal=False):
    """One PyTorch call computing attention over [B, T, H, D] tensors (head
    axis moved by views, no copies): the library yardstick."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
        is_causal=causal, enable_gqa=q.shape[2] != k.shape[2])


def kernel_phase(dev) -> dict:
    import numpy as np
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import quantize_kv
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from dots_ocr_tpu_torch.ops.paged_attention import (
        int8_tile_walkers,
        paged_attention_int8_reference,
        paged_attention_multiquery_bf16,
        paged_attention_multiquery_int8,
        paged_attention_multiquery_reference,
        paged_int8_split_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    results = {"flash_attention": [], "paged_attention_multiquery": [],
               "paged_attention_multiquery_int8": []}
    # (a) vision: sample_page (5,040 patches) + sample_receipt (1,380)
    # packed, bucket-padded to 6,656 with -1; 12 heads x 128, non-causal.
    seg = np.full((1, 6656), -1, np.int32)
    seg[0, :5040], seg[0, 5040:6420] = 0, 1
    seg = torch.from_numpy(seg).to(dev)
    q, k, v = randn(1, 6656, 12, 128), randn(1, 6656, 12, 128), randn(1, 6656, 12, 128)
    block = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0))[:, None]
    results["flash_attention"].append(compare(
        "flash vision T=6656 (5040+1380 packed, -1 pad) H=12 D=128",
        lambda: flash_attention(q, k, v, seg, seg),
        lambda: flash_attention_reference(q, k, v, seg, seg),
        work=_flash_work(q, k, seg, seg), library_fn=lambda: _sdpa(q, k, v, block),
        control_fn=lambda: flash_attention_reference(q, k, fp8_round(v), seg, seg)))
    del block
    # (b) decoder prefill: B=4, T=2048, GQA 12q/2kv, causal, padded rows.
    lens = torch.tensor([2048, 1531, 800, 77], device=dev)
    seg = torch.where(torch.arange(2048, device=dev)[None] < lens[:, None], 0, -1).to(torch.int32)
    q, k, v = randn(4, 2048, 12, 128), randn(4, 2048, 2, 128), randn(4, 2048, 2, 128)
    results["flash_attention"].append(compare(
        "flash prefill B=4 T=2048 12q/2kv D=128 causal, rows 2048/1531/800/77",
        lambda: flash_attention(q, k, v, seg, seg, causal=True),
        lambda: flash_attention_reference(q, k, v, seg, seg, causal=True),
        work=_flash_work(q, k, seg, seg, causal=True),
        library_fn=lambda: _sdpa(q, k, v, causal=True),
        control_fn=lambda: flash_attention_reference(q, k, fp8_round(v), seg, seg,
                                                     causal=True)))
    # (g) a chunked-prefill chunk as decoder_prefill_extend_batched calls
    # it: B=2, C=2048 queries at positions 2048..4095 over the gathered
    # [0, 4096) prefix; prompts of 4,096 and 3,100 tokens (segment -1 past
    # each prompt, for queries and keys alike).
    plen = torch.tensor([4096, 3100], device=dev)
    pos = torch.arange(4096, device=dev)
    q_seg = torch.where(pos[None, 2048:] < plen[:, None], 0, -1).to(torch.int32)
    kv_seg = torch.where(pos[None, :] < plen[:, None], 0, -1).to(torch.int32)
    q, k, v = randn(2, 2048, 12, 128), randn(2, 4096, 2, 128), randn(2, 4096, 2, 128)
    chunk_mask = ((q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] >= 0)
                  & (pos[None, None, :] <= pos[None, 2048:, None]))[:, None]
    results["flash_attention"].append(compare(
        "flash prefill chunk B=2 C=2048 kv_hi=4096 q_offset=2048 12q/2kv, prompts 4096/3100",
        lambda: flash_attention(q, k, v, q_seg, kv_seg, causal=True, q_offset=2048),
        lambda: flash_attention_reference(q, k, v, q_seg, kv_seg, causal=True, q_offset=2048),
        work=_flash_work(q, k, q_seg, kv_seg, causal=True, q_offset=2048),
        library_fn=lambda: _sdpa(q, k, v, chunk_mask),
        control_fn=lambda: flash_attention_reference(q, k, fp8_round(v), q_seg, kv_seg,
                                                     causal=True, q_offset=2048)))
    del q, k, v, seg, q_seg, kv_seg, chunk_mask
    # (c, d) paged decode: 64 slots, page 128, table width 320, lengths
    # over 0..12k with zeros, shuffled distinct pages (sized for nq = 3).
    rng = np.random.RandomState(0)
    lengths = rng.randint(1, 12001, MAX_SLOTS)
    lengths[::8] = 0
    kp, vp, lens_t, table_t = _paged_pool(randn, rng, lengths, PAGE_SIZE, 128,
                                          MAX_SEQ_TOKENS // PAGE_SIZE, extra=2)
    live = int(lengths.sum())
    shape = (f"64 slots page 128 width 320, lengths 0..12k ({live} live tokens, "
             f"{int((lengths == 0).sum())} empty)")
    # (e, f) the int8 mode at the same shape: pools and scales from
    # quantize_kv of the same N(0, 1) data; the plain version at the
    # kernel's tile, split and warps. No single PyTorch call reads a paged
    # pool: no library time; the bf16 mode on the same rows is timed in the
    # same turns. The tight bound's control is the plain version on V's
    # int8 codes rounded to 4 bits (multiples of 16: ~10% of a code's RMS
    # at N(0, 1) data, the strength of fp8's 3 mantissa bits on bf16 V).
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    vq4 = (torch.round(vq.float() / 16) * 16).clamp(-127, 127).to(torch.int8)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for nq in (1, 3):
        qd = randn(MAX_SLOTS, nq, 12, 128)
        results["paged_attention_multiquery"].append(compare(
            f"paged decode nq={nq} bf16 {shape}",
            lambda: paged_attention_multiquery_bf16(qd, kp, vp, lens_t, table_t),
            lambda: paged_attention_multiquery_reference(qd, kp, vp, lens_t, table_t),
            work=_paged_work(qd, lens_t, 2, int8=False),
            control_fn=lambda: paged_attention_multiquery_reference(qd, kp, fp8_round(vp),
                                                                    lens_t, table_t)))
        chunk, n_split = paged_int8_split_plan(MAX_SLOTS, 2, 6 * nq, 128, MAX_SEQ_TOKENS,
                                               num_sms)
        results["paged_attention_multiquery_int8"].append(compare(
            f"paged decode nq={nq} int8 {shape}, {n_split} splits of {chunk}",
            lambda: paged_attention_multiquery_int8(qd, kq, vq, ks, vs, lens_t, table_t),
            lambda: paged_attention_int8_reference(qd, kq, vq, ks, vs, lens_t, table_t,
                                                   chunk=chunk, warps=int8_tile_walkers(6 * nq)),
            work=_paged_work(qd, lens_t, 2, int8=True),
            extra={"bf16_mode_ms": lambda: paged_attention_multiquery_bf16(qd, kp, vp, lens_t,
                                                                           table_t)},
            control_fn=lambda: paged_attention_int8_reference(
                qd, kq, vq4, ks, vs, lens_t, table_t, chunk=chunk,
                warps=int8_tile_walkers(6 * nq)),
            control="plain on V's codes rounded to 4 bits"))
    del kp, vp, kq, vq, vq4, ks, vs
    windows = window_cases(randn, dev)
    results["flash_attention"].append(windows.pop("flash_windowed"))
    results.update(windows)
    results.update(paged_v1_cases(randn, dev))
    results.update(int4_cases(randn, gen, dev))
    return results


# Phase 3's shard shapes of tensor-parallel serving (phase 19): the W8A16
# linears of a TP = 2 rank (wq N 768, wk/wv N 128, gate/up N 4,480, wo K 768,
# down K 4,480) and TP = 4's padded gate/up and down (2,304), at a decode
# step's, a verify step's and a prefill chunk's rows.
TP_W8A16_SHAPES = {"wq tp2": (1536, 768), "wk/wv tp2": (1536, 128), "gate/up tp2": (1536, 4480),
                   "wo tp2": (768, 1536), "down tp2": (4480, 1536),
                   "gate/up tp4 padded": (1536, 2304), "down tp4 padded": (2304, 1536)}
TP_W8A16_ROWS = (MAX_SLOTS, 3 * MAX_SLOTS, PREFILL_CHUNK)
# The row-parallel ones give their float32 partial sums to the all-reduce
# (models/layers.py::linear's reduce): float32 out, no bias.
TP_ROW_PARALLEL = ("wo tp2", "down tp2", "down tp4 padded")


def tp_shard_cases(dev) -> dict:
    """Kernels 1 and 2 and W8A16 at the per-rank shapes of TP = 2 and 4,
    against their plain versions with phase 3's bounds, controls and
    repeats: kernel 1 over the packed vision batch at 6 and 3 heads and a
    prefill chunk at 6q/1kv and 3q/1kv; kernel 2 over one KV head (bf16 at
    6 query heads, int8 at 3: the KV modes of phase 19 (a) and (b)) at nq =
    1 and 3; W8A16 at TP_W8A16_SHAPES x TP_W8A16_ROWS."""
    import numpy as np
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import quantize_kv
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from dots_ocr_tpu_torch.ops.paged_attention import (
        int8_tile_walkers,
        paged_attention_int8_reference,
        paged_attention_multiquery_bf16,
        paged_attention_multiquery_int8,
        paged_attention_multiquery_reference,
        paged_int8_split_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(19)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    results = {"flash_attention": [], "paged_attention_multiquery": [],
               "paged_attention_multiquery_int8": []}
    seg = np.full((1, 6656), -1, np.int32)
    seg[0, :5040], seg[0, 5040:6420] = 0, 1
    seg = torch.from_numpy(seg).to(dev)
    block = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0))[:, None]
    for heads, world in ((6, 2), (3, 4)):
        q, k, v = (randn(1, 6656, heads, 128) for _ in range(3))
        results["flash_attention"].append(compare(
            f"flash vision TP={world} shard T=6656 (5040+1380 packed) H={heads} D=128",
            lambda: flash_attention(q, k, v, seg, seg),
            lambda: flash_attention_reference(q, k, v, seg, seg),
            work=_flash_work(q, k, seg, seg), library_fn=lambda: _sdpa(q, k, v, block),
            control_fn=lambda: flash_attention_reference(q, k, fp8_round(v), seg, seg)))
    del q, k, v, block
    plen = torch.tensor([4096, 3100], device=dev)
    pos = torch.arange(4096, device=dev)
    q_seg = torch.where(pos[None, 2048:] < plen[:, None], 0, -1).to(torch.int32)
    kv_seg = torch.where(pos[None, :] < plen[:, None], 0, -1).to(torch.int32)
    chunk_mask = ((q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] >= 0)
                  & (pos[None, None, :] <= pos[None, 2048:, None]))[:, None]
    for heads, world in ((6, 2), (3, 4)):
        q, k, v = randn(2, 2048, heads, 128), randn(2, 4096, 1, 128), randn(2, 4096, 1, 128)
        results["flash_attention"].append(compare(
            f"flash prefill chunk TP={world} shard B=2 C=2048 kv_hi=4096 q_offset=2048 "
            f"{heads}q/1kv",
            lambda: flash_attention(q, k, v, q_seg, kv_seg, causal=True, q_offset=2048),
            lambda: flash_attention_reference(q, k, v, q_seg, kv_seg, causal=True,
                                              q_offset=2048),
            work=_flash_work(q, k, q_seg, kv_seg, causal=True, q_offset=2048),
            library_fn=lambda: _sdpa(q, k, v, chunk_mask),
            control_fn=lambda: flash_attention_reference(q, k, fp8_round(v), q_seg, kv_seg,
                                                         causal=True, q_offset=2048)))
    del q, k, v, chunk_mask
    rng = np.random.RandomState(19)
    lengths = rng.randint(1, 12001, MAX_SLOTS)
    lengths[::8] = 0
    kp, vp, lens_t, table_t = _paged_pool(randn, rng, lengths, PAGE_SIZE, 128,
                                          MAX_SEQ_TOKENS // PAGE_SIZE, extra=2)
    kp, vp = kp[:1].contiguous(), vp[:1].contiguous()
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    vq4 = (torch.round(vq.float() / 16) * 16).clamp(-127, 127).to(torch.int8)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shape = f"64 slots page 128 width 320, lengths 0..12k ({int(lengths.sum())} live tokens)"
    for nq in (1, 3):
        qd = randn(MAX_SLOTS, nq, 6, 128)
        results["paged_attention_multiquery"].append(compare(
            f"paged decode TP=2 shard nq={nq} bf16 6q/1kv {shape}",
            lambda: paged_attention_multiquery_bf16(qd, kp, vp, lens_t, table_t),
            lambda: paged_attention_multiquery_reference(qd, kp, vp, lens_t, table_t),
            work=_paged_work(qd, lens_t, 1, int8=False),
            control_fn=lambda: paged_attention_multiquery_reference(qd, kp, fp8_round(vp),
                                                                    lens_t, table_t)))
        # int8 KV at TP = 4's shape (phase 19 (b)); TP = 2's 6q over one head
        # runs the group of phase 3's 12q / 2kv int8 case on half its grid
        for heads, world in ((3, 4),):
            qh = qd[:, :, :heads].contiguous()
            chunk, n_split = paged_int8_split_plan(MAX_SLOTS, 1, heads * nq, 128,
                                                   MAX_SEQ_TOKENS, num_sms)
            warps = int8_tile_walkers(heads * nq)
            results["paged_attention_multiquery_int8"].append(compare(
                f"paged decode TP={world} shard nq={nq} int8 {heads}q/1kv {shape}, "
                f"{n_split} splits of {chunk}",
                lambda: paged_attention_multiquery_int8(qh, kq, vq, ks, vs, lens_t, table_t),
                lambda: paged_attention_int8_reference(qh, kq, vq, ks, vs, lens_t, table_t,
                                                       chunk=chunk, warps=warps),
                work=_paged_work(qh, lens_t, 1, int8=True),
                control_fn=lambda: paged_attention_int8_reference(
                    qh, kq, vq4, ks, vs, lens_t, table_t, chunk=chunk, warps=warps),
                control="plain on V's codes rounded to 4 bits"))
    del kp, vp, kq, vq, vq4, ks, vs
    torch.cuda.empty_cache()
    # torch._weight_int8pack_mm (context only) is timed at the full shapes
    results.update(w8a16_cases(dev, TP_W8A16_SHAPES, TP_W8A16_ROWS, int8pack_yardstick=False))
    return results


def tiny_call_phase(dev) -> dict:
    """The floor under every single-call time above: CUDA-event ms of one
    wrapper call at a tiny shape (kernel 1 over 128 tokens, kernel 2's bf16
    mode over one 16-token page), where the kernel's own work is a few
    microseconds and the wrapper's host time before the launch shows."""
    import torch

    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention
    from dots_ocr_tpu_torch.ops.paged_attention import paged_attention_multiquery_bf16

    q = torch.zeros(1, 128, 1, 128, dtype=torch.bfloat16, device=dev)
    seg = torch.zeros(1, 128, dtype=torch.int32, device=dev)
    pages = torch.zeros(1, 2, 16, 128, dtype=torch.bfloat16, device=dev)
    qd = torch.zeros(1, 1, 1, 128, dtype=torch.bfloat16, device=dev)
    lens = torch.full((1,), 16, dtype=torch.int32, device=dev)
    table = torch.ones(1, 1, dtype=torch.int32, device=dev)
    res = time_in_turns({
        "flash_attention": lambda: flash_attention(q, q, q, seg, seg),
        "paged_attention_multiquery": lambda: paged_attention_multiquery_bf16(
            qd, pages, pages, lens, table)}, inner=1)
    log("  one call at a tiny shape (median of "
        f"{REPS}): " + ", ".join(f"{name} {ms:.3f} ms" for name, ms in res.items()))
    return res


def _paged_pool(randn, rng, lengths, page_size, head_dim, width, extra=0):
    """bf16 N(0, 1) pools [2, pages, page_size, D] with shuffled distinct
    pages for each row's ``length + extra`` tokens, the int32 lengths and
    [rows, width] table (null page 0 past each row's end), on the device."""
    import numpy as np
    import torch

    need = [-(-(n + extra) // page_size) if n else 0 for n in lengths]
    pool_pages = sum(need) + 1
    perm = rng.permutation(pool_pages - 1) + 1
    table = np.zeros((len(lengths), width), np.int32)
    off = 0
    for row, n in enumerate(need):
        table[row, :n] = perm[off:off + n]
        off += n
    kp, vp = randn(2, pool_pages, page_size, head_dim), randn(2, pool_pages, page_size, head_dim)
    return (kp, vp, torch.from_numpy(np.asarray(lengths, np.int32)).to(kp.device),
            torch.from_numpy(table).to(kp.device))


def windowed_segments(dev):
    """The windowed vision batch's segment ids [nw, W] on ``dev`` and its
    packed token count: the demo page and receipt, smart-resized as the
    engine does, packed window-major with 16 x 16-patch windows (edge
    windows padded), plus a fully padded window of the bucket's tail."""
    import dataclasses

    import numpy as np
    import torch
    from PIL import Image

    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.preprocess import pack_images
    from dots_ocr_tpu_torch.utils.consts import MAX_PIXELS, MIN_PIXELS
    from dots_ocr_tpu_torch.utils.image_io import fetch_image

    vcfg = dataclasses.replace(DotsOCRConfig.flagship().vision, window_size=WINDOW_PATCHES,
                               full_attn_layers=FULL_LAYERS)
    images = [fetch_image(Image.open(os.path.join(REPO, "demo/assets", name)),
                          min_pixels=MIN_PIXELS, max_pixels=MAX_PIXELS)
              for name in ("sample_page.png", "sample_receipt.png")]
    packed = pack_images(images, vcfg)
    w = WINDOW_PATCHES**2
    # plus one window of the bucket's tail (segment -1 throughout), which a
    # bucket longer than the packed tokens adds (here they fill it exactly)
    seg = np.concatenate([packed.segment_ids, np.full(w, -1, np.int32)])
    return torch.from_numpy(seg.reshape(-1, w)).to(dev), packed.num_tokens


def window_cases(randn, dev) -> dict:
    """Kernel 4 at the windowed vision batch (:func:`windowed_segments`);
    12 heads x 128. Beside it, kernel 1 over the same tokens with each
    window as a segment (same function on the valid rows), and SDPA on the
    windows with the key mask."""
    import torch

    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
    from dots_ocr_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_reference,
    )

    seg, num_tokens = windowed_segments(dev)
    nw, w = seg.shape
    valid_keys = (seg >= 0).sum(dim=1)
    if not (((valid_keys > 0) & (valid_keys < w)).any() and (valid_keys == 0).any()):
        raise AssertionError("the windowed batch lacks a padded edge window or a padded "
                             "bucket window")
    q, k, v = randn(nw, w, 12, 128), randn(nw, w, 12, 128), randn(nw, w, 12, 128)
    # the function's pairs: each query row over its window's valid keys,
    # over every key where none is valid (the uniform average of V)
    pairs = int(torch.where(valid_keys > 0, valid_keys, w).sum()) * w
    work = bound(4.0 * pairs * 12 * 128, 4 * q.numel() * 2 + 4 * seg.numel())
    win_seg = torch.where(seg >= 0, torch.arange(nw, device=dev)[:, None], -1)
    win_seg = win_seg.reshape(1, -1).to(torch.int32)
    flat = [x.reshape(1, nw * w, 12, 128) for x in (q, k, v)]
    key_mask = (seg >= 0)[:, None, None, :]
    out = window_attention(q, k, v, seg).reshape(1, nw * w, 12, 128)
    flash = flash_attention(*flat, win_seg, win_seg)
    rows = win_seg[0] >= 0
    diff = float((out[0, rows].float() - flash[0, rows].float()).abs().max())
    log(f"  window kernel vs flash with the windows as segments, valid rows: max abs "
        f"diff {diff:.3e}")
    if not diff <= ATOL + RTOL * float(flash[0, rows].float().abs().max()):
        raise AssertionError(f"window kernel and flash disagree on valid rows ({diff})")
    res = compare(
        f"window attention nw={nw} W={w} H=12 D=128 ({num_tokens} packed tokens of "
        f"{nw * w}, {int((valid_keys == 0).sum())} padded window(s))",
        lambda: window_attention(q, k, v, seg),
        lambda: window_attention_reference(q, k, v, seg), work=work,
        library_fn=lambda: _sdpa(q, k, v, key_mask),
        extra={"flash_same_windows_ms": lambda: flash_attention(*flat, win_seg, win_seg)},
        control_fn=lambda: window_attention_reference(q, k, fp8_round(v), seg))
    # Kernel 1's own case on these windows (its tile list skips the other
    # windows' tiles): the valid rows' pairs only (a padded window's rows
    # are -1 and give zeros here).
    del out, flash
    flash_res = compare(
        f"flash windowed segments {nw} x {w} as segment ids, T={nw * w} H=12 D=128",
        lambda: flash_attention(*flat, win_seg, win_seg),
        lambda: flash_attention_reference(*flat, win_seg, win_seg),
        work=_flash_work(flat[0], flat[1], win_seg, win_seg),
        library_fn=lambda: _sdpa(q, k, v, key_mask),
        control_fn=lambda: flash_attention_reference(flat[0], flat[1], fp8_round(flat[2]),
                                                     win_seg, win_seg))
    return {"window_attention": [res], "flash_windowed": flash_res}


def v1_inputs(randn, rng, lengths, page_size, head_dim, width, int8: bool):
    """Kernel 3's arguments over :func:`_paged_pool`'s pools as the middle
    layer of a 3-layer stack (int8: quantize_kv's codes and scales), with
    q [rows, 12, D]; and the bf16 pools."""
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import quantize_kv

    def stack(x):
        flat = x.reshape(1, x.shape[0], -1, *x.shape[3:])
        return torch.cat([torch.zeros_like(flat), flat, torch.zeros_like(flat)]).contiguous()

    kp, vp, lens_t, table_t = _paged_pool(randn, rng, lengths, page_size, head_dim, width)
    qd = randn(len(lengths), 12, head_dim)
    if int8:
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        pools, scales = (stack(kq), stack(vq)), (stack(ks), stack(vs))
    else:
        pools, scales = (stack(kp), stack(vp)), (None, None)
    return (qd, *pools, 1, lens_t, table_t, page_size, *scales), (kp, vp)


def v1_split(args) -> tuple:
    """Kernel 3's plan (chunk, n_split) for these arguments on this card."""
    import torch

    from dots_ocr_tpu_torch.ops.paged_attention import paged_v1_split_plan

    qd, k_all, _, _, _, table_t, page_size = args[:7]
    return paged_v1_split_plan(qd.shape[0], k_all.shape[1], qd.shape[1] // k_all.shape[1],
                               qd.shape[2], table_t.shape[1] * page_size, page_size,
                               torch.cuda.get_device_properties(qd.device).multi_processor_count)


def fp8_codes(codes):
    """int8 codes rounded through float8 e4m3 (3 mantissa bits, as fp8_round
    does to bf16 values): the tight bound's control in int8 mode."""
    import torch

    return fp8_round(codes.float()).clamp(-127, 127).to(torch.int8)


def paged_v1_cases(randn, dev) -> dict:
    """Kernel 3 against its plain version in the kernel's order (its split):
    64 slots x 2,048 tokens, 12q/2kv, D 128, pages of 64 and 128 in both
    modes, D 64 in bf16 (the JAX rule's head_dim case), and int8 at phase
    10's served shape (V1_SERVED_LENGTHS among 64 slots, table width
    MAX_SEQ_TOKENS / 64); the pool is the middle layer of a 3-layer stack.
    Each is held to the tight bound, with the control on V rounded through
    fp8 (int8 mode: V's codes). No single PyTorch call reads a paged pool:
    no library time."""
    import numpy as np

    from dots_ocr_tpu_torch.ops.paged_attention import (
        paged_attention_multiquery_bf16,
        paged_attention_stacked,
        paged_attention_v1_reference,
    )

    results = {"paged_attention_v1": [], "paged_attention_v1_int8": []}
    rng = np.random.RandomState(1)
    full = np.full(MAX_SLOTS, V1_CONTEXT)
    served = np.zeros(MAX_SLOTS, np.int64)
    served[:len(V1_SERVED_LENGTHS)] = V1_SERVED_LENGTHS
    cases = [(64, 128, False, full), (64, 128, True, full), (128, 128, False, full),
             (128, 128, True, full), (64, 64, False, full), (V1_SERVED_PAGE, 128, True, served)]
    for page_size, head_dim, int8, lengths in cases:
        width = (MAX_SEQ_TOKENS if lengths is served else V1_CONTEXT) // page_size
        args, (kp, vp) = v1_inputs(randn, rng, lengths, page_size, head_dim, width, int8)
        chunk, n_split = v1_split(args)
        control = list(args)
        if int8:
            control[2] = fp8_codes(args[2])
        else:
            control[2] = fp8_round(args[2])
        # Kernel 2's bf16 mode on the same rows, timed in the same turns
        # (the JAX rule sends bf16 decode at head_dim 128 to kernel 2).
        extra = {}
        if page_size == 128 and not int8:
            qd, lens_t, table_t = args[0], args[4], args[5]

            def k2():
                return paged_attention_multiquery_bf16(qd[:, None], kp, vp, lens_t, table_t)[:, 0]
            # held to the tight bound against each other
            out2, out3 = k2(), paged_attention_stacked(*args)
            diff = float((out2.float() - out3.float()).abs().max())
            cross = tight_errors(out2, out3)
            log(f"  kernel 2 bf16 vs kernel 3 bf16 at 64 x {V1_CONTEXT}, page 128: max abs "
                f"diff {diff:.3e}, rel RMS diff {cross['rel_rms_err']:.3e} (tol "
                f"{TIGHT_RMS:g}), tight ratio {cross['tight_ratio']:.3f} (tol 1)")
            if not (diff <= ATOL and _tight_pass(cross)):
                raise AssertionError(f"kernels 2 and 3 disagree ({diff}, {cross})")
            del out2, out3
            extra = {"kernel2_bf16_ms": k2}
        rows = (f"rows {'/'.join(map(str, V1_SERVED_LENGTHS))} of {MAX_SLOTS} slots, width "
                f"{width}" if lengths is served else f"{MAX_SLOTS} slots x {V1_CONTEXT}")
        results["paged_attention_v1_int8" if int8 else "paged_attention_v1"].append(compare(
            f"paged v1 {'int8' if int8 else 'bf16'} {rows} page {page_size} 12q/2kv "
            f"D={head_dim}, {n_split} splits of {chunk}",
            lambda: paged_attention_stacked(*args),
            lambda: paged_attention_v1_reference(*args, chunk=chunk),
            work=_paged_work(args[0], args[4], 2, int8=int8), extra=extra,
            control_fn=lambda: paged_attention_v1_reference(*control, chunk=chunk),
            control="plain on V's codes through fp8" if int8 else "plain on V through fp8"))
        del args, control, kp, vp
    return results


def int4_yardsticks(x, packed, scales) -> tuple:
    """Library calls computing W4A16's function at x's shape, timed beside
    kernel 5 and used nowhere in the port: cuBLAS bf16 on the dequantized
    weight (bf16(q s)), and, where the card's torch has it,
    ``torch._weight_int4pack_mm`` (tinygemm: 128-row groups, zero point 0,
    scales rounded to bf16) on the same int4 values, packed once here.
    Returns ({name: fn}, the int4pack call's max abs difference from cuBLAS
    on bf16-rounded scales, or the reason it is missing)."""
    import torch

    from dots_ocr_tpu_torch.ops.int4_matmul import GROUP, unpack_int4

    q = unpack_int4(packed)  # [K, N]
    k, n = q.shape
    per_group = q.float().reshape(k // GROUP, GROUP, n)
    w = (per_group * scales[:, None, :]).reshape(k, n).to(torch.bfloat16)
    fns = {"cublas_bf16": lambda: x @ w}
    try:
        u = (q.to(torch.int32) + 8).t().contiguous()  # [N, K], 0..15
        w4 = torch._convert_weight_to_int4pack((u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
        sz = torch.stack([scales.to(torch.bfloat16), torch.zeros_like(scales, dtype=torch.bfloat16)],
                         dim=-1).contiguous()
        got = torch._weight_int4pack_mm(x, w4, GROUP, sz).float()
    except (AttributeError, RuntimeError) as exc:
        return fns, f"torch._weight_int4pack_mm unavailable: {str(exc).splitlines()[0][:120]}"
    w_bf = (per_group * scales.to(torch.bfloat16).float()[:, None, :]).reshape(k, n)
    check = float((got - (x.float() @ w_bf)).abs().max())
    fns["int4pack_mm"] = lambda: torch._weight_int4pack_mm(x, w4, GROUP, sz)
    return fns, check


def int4_cases(randn, gen, dev) -> dict:
    """Kernel 5 in both modes against its plain version at the decoder's
    linear shapes: weights from quantize_kernel_int4 of N(0, 0.02) bf16,
    activations N(0, 1). The library time of W4A16 is
    ``torch._weight_int4pack_mm``'s (:func:`int4_yardsticks`; its scales
    are bf16), with cuBLAS bf16 on the dequantized weight beside it; W4A8
    has none: for context, cuBLAS bf16 and ``torch._int_mm`` on the
    quantized rows and the unpacked int8 weight (the same int8 products, no
    group scales) are timed beside it, and REPEAT_CALLS more calls must
    repeat its output bit for bit."""
    import torch

    from dots_ocr_tpu_torch.models.quantize import quantize_kernel_int4
    from dots_ocr_tpu_torch.ops.int4_matmul import (
        int4_matmul,
        int4_matmul_plain,
        quantize_rows,
        unpack_int4,
    )

    results = {"int4_matmul": [], "int4_matmul_w4a8": []}
    for label, (k, n) in INT4_SHAPES.items():
        qk = quantize_kernel_int4(randn(k, n) * 0.02)
        packed, scales = qk["qint4"], qk["scale4"]
        q8 = unpack_int4(packed)
        for rows in INT4_ROWS:
            x = randn(rows, k)
            xq = quantize_rows(x)[0].to(torch.int8)
            # x and out bf16, the packed nibbles and float32 group scales
            nbytes = 2 * rows * k + packed.numel() + 4 * scales.numel() + 2 * rows * n
            fns, check = int4_yardsticks(x, packed, scales)
            for act, key in ((False, "int4_matmul"), (True, "int4_matmul_w4a8")):
                atol, rtol = INT4_TOL[act]
                library, extra = None, {"cublas_bf16_ms": fns["cublas_bf16"]}
                if act:
                    extra["int_mm_ms"] = lambda: torch._int_mm(xq, q8)
                    first = int4_matmul(x, packed, scales, True)
                    same = sum(bool(torch.equal(int4_matmul(x, packed, scales, True), first))
                               for _ in range(REPEAT_CALLS))
                    log(f"  int4 W4A8 {label} M={rows}: {same} of {REPEAT_CALLS} repeated calls "
                        f"bit-identical")
                    if same != REPEAT_CALLS:
                        raise AssertionError(f"int4 W4A8 {label} M={rows}: "
                                             f"{REPEAT_CALLS - same} repeated calls differ")
                    del first
                else:
                    library = fns.get("int4pack_mm")
                    log(f"  int4 {label} M={rows}: torch._weight_int4pack_mm vs cuBLAS on "
                        f"bf16-rounded scales: "
                        + (f"max abs diff {check:.3e}" if library else check))
                results[key].append(compare(
                    f"int4 {'W4A8' if act else 'W4A16'} {label} K={k} N={n} M={rows}",
                    lambda: int4_matmul(x, packed, scales, act),
                    lambda: int4_matmul_plain(x, packed, scales, act), atol, rtol,
                    work=bound(2.0 * rows * k * n, nbytes, "int8" if act else "bf16"),
                    library_fn=library, extra=extra))
                del library, extra
            del fns, xq
    return results


def w8a16_int8pack(x, q, scale, unembed: bool):
    """``torch._weight_int8pack_mm`` on the card for the same product (x .
    q^T [N, K] times the per-column scale, cast), with its weight laid out
    once beforehand, as (fn, None), or (None, "none: <why>") where this
    torch has no CUDA kernel for it. Timed beside the kernel, never called
    by the port."""
    import torch

    w = (q if unembed else q.t()).contiguous()
    s = scale.to(x.dtype)
    try:
        got = torch._weight_int8pack_mm(x, w, s)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as exc:
        return None, f"none: {str(exc).splitlines()[0][:120]}"
    if got.shape != (x.shape[0], w.shape[0]):
        return None, f"none: returned shape {tuple(got.shape)}"
    return (lambda: torch._weight_int8pack_mm(x, w, s)), None


def w8a16_cases(dev, shapes=None, rows_list=None, int8pack_yardstick: bool = True) -> dict:
    """The W8A16 kernel (csrc/int8_matmul.cuh) against its plain version
    (the per-call bf16 copy of the weight, then cuBLAS: the int8 path
    before the kernel) at W8A16_SHAPES x (W8A16_ROWS + W8A16_RAGGED):
    weights from quantize_kernel of N(0, 0.02) bf16 (the lm_head:
    quantize_embedding of N(0, 1)), wq/wo and wk/wv with a bf16 bias as the
    model's q/k/v projections carry, activations N(0, 1); each case's plan
    printed. The library time is one cuBLAS bf16 call on the weight
    converted once beforehand (``matmul_f32``: what bf16 weights cost,
    without the scale, bias and cast); ``torch._weight_int8pack_mm`` (the
    same int8 product and scale, its weight laid out once) is timed in the
    same turns where this torch has a CUDA kernel for it, else recorded as
    "none". REPEAT_CALLS more calls must repeat the output bit for bit;
    ``graph_ms`` holds the device time per call of the kernel, the plain
    version and the library (CUDA graphs of 10 calls)."""
    import torch

    from dots_ocr_tpu_torch.models.quantize import quantize_embedding, quantize_kernel
    from dots_ocr_tpu_torch.ops.int8_matmul import (
        int8_linear_reference,
        int8_unembed_reference,
        matmul_f32,
        w8a16_matmul,
        w8a16_plan,
    )

    gen = torch.Generator(device=dev).manual_seed(12)
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = []
    shapes = W8A16_SHAPES if shapes is None else shapes
    rows_list = sorted(W8A16_ROWS + W8A16_RAGGED) if rows_list is None else rows_list
    for label, (k, n) in shapes.items():
        unembed = label == "lm_head"
        if unembed:
            qk = quantize_embedding(torch.randn(n, k, generator=gen, device=dev).to(torch.bfloat16))
        else:
            qk = quantize_kernel((torch.randn(k, n, generator=gen, device=dev) * 0.02)
                                 .to(torch.bfloat16))
        q, scale = qk["qint8"], qk["scale"]
        bias = (torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
                if label.split()[0] in ("wq/wo", "wk/wv", "wq") else None)
        w_bf16 = q.to(torch.bfloat16)  # the library's weight, converted once
        w_lib = w_bf16.t() if unembed else w_bf16
        out_f32 = label in TP_ROW_PARALLEL
        atol, rtol = W8A16_TOL[unembed or out_f32]
        for rows in rows_list:
            if unembed and rows > 3 * MAX_SLOTS:
                continue
            x = torch.randn(rows, k, generator=gen, device=dev).to(torch.bfloat16)
            plan = w8a16_plan(rows, k, n, num_sms, unembed)

            def kernel_fn():
                return w8a16_matmul(x, q, scale, bias, transposed=unembed, out_f32=out_f32)

            def plain_fn():
                return (int8_unembed_reference(x, q, scale) if unembed
                        else int8_linear_reference(x, q, scale, bias, out_f32))

            def library_fn():
                return matmul_f32(x, w_lib)

            int8pack, int8pack_none = (w8a16_int8pack(x, q, scale, unembed) if int8pack_yardstick
                                       else (None, "not timed at this shape"))
            first = kernel_fn()
            same = sum(bool(torch.equal(kernel_fn(), first)) for _ in range(REPEAT_CALLS))
            del first
            if same != REPEAT_CALLS:
                raise AssertionError(f"w8a16 {label} M={rows}: {REPEAT_CALLS - same} repeated "
                                     f"calls differ")
            # x and q read once, the scale (and bias) once, the output written once
            nbytes = (q.numel() + 2 * rows * k + 4 * n + (2 * n if bias is not None else 0)
                      + (4 if unembed or out_f32 else 2) * rows * n)
            name = (f"w8a16 {label} {'[N, K] unembed' if unembed else '[K, N] linear'} K={k} "
                    f"N={n} M={rows}, {plan.regime} {plan.rows_tile} rows x {plan.cols_tile} "
                    f"columns, {plan.consumers} warpgroup{'s' if plan.consumers > 1 else ''}"
                    f"{' splitting K' if plan.split == 'contraction' else ''}, {plan.cluster} ranks")
            log(f"  {name}: plan {plan}")
            res = compare(name, kernel_fn, plain_fn, atol, rtol,
                          work=bound(2.0 * rows * k * n, nbytes), library_fn=library_fn,
                          extra={"int8pack_ms": int8pack} if int8pack else None)
            res["graph_ms"] = {key: graph_ms(fn) for key, fn in
                               (("ms", kernel_fn), ("plain_ms", plain_fn),
                                ("library_ms", library_fn))}
            if int8pack:
                try:  # a library call that cannot be captured is timed back to back only
                    res["graph_ms"]["int8pack_ms"] = graph_ms(int8pack)
                except RuntimeError as exc:
                    torch.cuda.synchronize()
                    res["graph_ms"]["int8pack_ms"] = f"not captured: {str(exc)[:80]}"
            else:
                res["int8pack_ms"] = res["graph_ms"]["int8pack_ms"] = int8pack_none
            res.update(repeats=REPEAT_CALLS, repeats_bit_identical=same, rows=rows,
                       plan=plan._asdict())
            log(f"  {name}: {same} of {REPEAT_CALLS} repeats bit-identical; as CUDA graphs "
                + ", ".join(f"{key} {ms:.4f}" if isinstance(ms, float) else f"{key} {ms}"
                            for key, ms in res["graph_ms"].items()) + " ms")
            out.append(res)
            del x, int8pack
        del q, scale, w_bf16, w_lib, qk, bias
        torch.cuda.empty_cache()
    return {"w8a16_matmul": out}


def w8a8_vision_phase(dev) -> dict:
    """For context: the W8A8 vision linear (per-row int8 activations,
    torch._int_mm, scales) against the bf16 linear at the vision shapes."""
    import torch

    from dots_ocr_tpu_torch.models.layers import linear
    from dots_ocr_tpu_torch.models.quantize import quantize_kernel_act

    gen = torch.Generator(device=dev).manual_seed(1)
    res = {}
    for label, (k, n) in VISION_SHAPES.items():
        x = torch.randn(VISION_T, k, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(k, n, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        qk = quantize_kernel_act(w)
        res[label] = time_in_turns({"w8a8_ms": lambda: linear(x, qk),
                                    "bf16_ms": lambda: linear(x, w)})
        log(f"  vision linear {label} T={VISION_T} K={k} N={n}: W8A8 "
            f"{res[label]['w8a8_ms']:.3f} ms, bf16 {res[label]['bf16_ms']:.3f} ms "
            f"(median of {REPS} samples of {INNER} calls)")
    return res


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http(url: str, body=None, timeout: float = 600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, resp.read().decode()


def _counters():
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention
    from dots_ocr_tpu_torch.ops.int4_matmul import int4_matmul
    from dots_ocr_tpu_torch.ops.int8_matmul import w8a16_matmul
    from dots_ocr_tpu_torch.ops.paged_attention import (
        paged_attention_multiquery_bf16,
        paged_attention_multiquery_int8,
        paged_attention_stacked,
    )
    from dots_ocr_tpu_torch.ops.sampling import gumbel_argmax, threefry_grid
    from dots_ocr_tpu_torch.ops.window_attention import window_attention

    return {"gumbel_argmax": (gumbel_argmax, "launches"),
            "threefry2x32": (threefry_grid, "launches"),
            "w8a16_matmul": (w8a16_matmul, "launches"),
            "w8a16_matmul (decode)": (w8a16_matmul, "decode_launches"),
            "w8a16_matmul (prefill)": (w8a16_matmul, "prefill_launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention (q_offset > 0)": (flash_attention, "offset_launches"),
            "paged_attention_multiquery": (paged_attention_multiquery_bf16, "launches"),
            "paged_attention_multiquery (nq > 1)": (paged_attention_multiquery_bf16,
                                                    "verify_launches"),
            "paged_attention_multiquery_int8": (paged_attention_multiquery_int8, "launches"),
            "paged_attention_multiquery_int8 (nq > 1)": (paged_attention_multiquery_int8,
                                                         "verify_launches"),
            "paged_attention_v1": (paged_attention_stacked, "launches"),
            "paged_attention_v1_int8": (paged_attention_stacked, "int8_launches"),
            "window_attention": (window_attention, "launches"),
            "int4_matmul": (int4_matmul, "launches"),
            "int4_matmul_w4a8": (int4_matmul, "w4a8_launches"),
            "int4_matmul_w4a8 (split)": (int4_matmul, "w4a8_split_launches"),
            "int4_matmul_w4a8 (wgmma)": (int4_matmul, "w4a8_wgmma_launches")}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def serve_phase(dev, flags, label: str, required, base_flags=None, waves=((0.0, 32),),
                replies=None, one_more: bool = False, page_last: bool = False,
                before_serve=None, probe=None):
    """Build the engine through the server's entry point with ``flags``
    (after ``base_flags``, by default the shipping geometry of phases 4-10),
    serve it, and drive three concurrent requests per wave, one wave after
    the other, each wave's requests at its (temperature, max_tokens[, env]):
    a wave's env entries are set in os.environ around it (the server runs in
    this process) and restored after. Every
    counter named in ``required`` must move during the served run (all
    waves). ``replies``, a list, receives each wave's {request name: (text,
    usage)}; with ``one_more`` a further text request is served after the
    waves and must come back HTTP 200; with ``page_last`` a wave's first
    request (the page) is posted once /metrics shows the other two
    prefilled. ``before_serve(engine)`` runs before the server starts (the
    engine to itself, on this thread); ``probe(post, read_metrics, state)``
    after the waves, with its result as ``state``: ``post(body)`` returns
    (HTTP status, the decoded JSON reply) for any status. Returns (engine,
    the launch counts of the run, /metrics as a dict, the page image)."""
    import torch
    from PIL import Image

    from dots_ocr_tpu_torch.serve import server as torch_server

    if base_flags is None:
        base_flags = ["--num-pages", str(NUM_PAGES), "--page-size", str(PAGE_SIZE),
                      "--max-slots", str(MAX_SLOTS), "--max-seq-tokens", str(MAX_SEQ_TOKENS),
                      "--steps-per-sync", "16", "--vision-attn", "config"]
    args = torch_server.build_parser().parse_args([
        "--random-flagship", "--platform", str(dev), *base_flags, *flags,
    ])
    t0 = time.perf_counter()
    engine = torch_server.build_engine(args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  [{label}] flagship engine built (random weights, {args.quantize} quantization, "
        f"vision {args.vision_quantize}, {args.kv_cache_dtype} KV pool) in "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{args.num_pages} pages x {args.page_size}, {args.max_slots} slots, table width "
        f"{engine.sched.max_pages_per_seq}, speculate_k {engine.sched.speculate_k}, "
        f"prefill chunk {engine.sched.prefill_chunk_tokens}, vision window "
        f"{engine.config.vision.window_size} (full layers {engine.config.vision.full_attn_layers})")

    if args.warmup:
        warm = torch_server.start_warmup(engine, args)
        log(f"  [{label}] --warmup {args.warmup}: {warm}")
    state = before_serve(engine) if before_serve is not None else None
    graphs_before = graph_counts(engine)
    with running_server(engine) as base:
        status, body = _http(f"{base}/health")
        if status != 200:
            raise AssertionError(f"/health -> {status} {body}")
        log(f"  [{label}] /health -> {status} {body}")
        page = Image.open(os.path.join(REPO, "demo/assets/sample_page.png"))
        requests = chat_requests()

        finishes = []  # the finish reasons of every reply in the run

        def post(item):
            name, body = item
            t = time.perf_counter()
            status, text = _http(f"{base}/v1/chat/completions", body)
            data = json.loads(text)
            finishes.extend(c.get("finish_reason") for c in data.get("choices", ()))
            return name, status, data, time.perf_counter() - t

        def read_metrics():
            return engine_metrics(base)

        stops_before = read_metrics()[1].get("repetition_stops", 0)
        reset_counts()
        for wave, (temperature, max_tokens, *wave_env) in enumerate(waves):
            env = wave_env[0] if wave_env else {}
            wave_label = label if len(waves) == 1 else f"{label} wave {wave + 1}"
            wave_label += "".join(f", {key}={value}" for key, value in env.items())
            batch = [(name, {**body, "temperature": temperature, "max_tokens": max_tokens})
                     for name, body in requests]
            others_admitted = None
            if page_last:
                before = read_metrics()[1].get("prefills", 0)

                def others_admitted(before=before):
                    return read_metrics()[1].get("prefills", 0) >= before + len(batch) - 1
            saved = {key: os.environ.get(key) for key in env}
            os.environ.update(env)
            try:
                answers = _serve_wave(post, batch, wave_label, temperature, others_admitted)
            finally:
                for key, value in saved.items():
                    if value is None:
                        os.environ.pop(key, None)
                    else:
                        os.environ[key] = value
            if replies is not None:
                replies.append(answers)
        if probe is not None:
            def post_any(body):
                try:
                    status, text = _http(f"{base}/v1/chat/completions", body)
                except urllib.error.HTTPError as err:
                    status, text = err.code, err.read().decode()
                data = json.loads(text)
                finishes.extend(c.get("finish_reason") for c in data.get("choices", ()))
                return status, data

            probe(post_any, lambda: read_metrics()[1], state)
        if one_more:
            _serve_wave(post, [("one more text request",
                                {**requests[2][1], "temperature": 0.0, "max_tokens": 8})],
                        f"{label}, afterwards", 0.0)
        launches = read_counts()
        status, metrics = read_metrics()
        if status != 200 or metrics.get("prefills", 0) < 3:
            raise AssertionError(f"/metrics shows fewer than 3 prefills: {metrics}")
        shown = ("prefills", "prefill_chunks", "steps", "spec_chunks", "spec_emitted",
                 "spec_slot_iters", "spec_auto_disabled", "preemptions", "pipelined_chunks",
                 "chunk_input_rebuilds", "graph_captures", "graph_replays", "t_admit_s",
                 "t_prefill_s", "t_decode_s", "t_fetch_wait_s")
        log(f"  [{label}] /metrics: " + ", ".join(f"{k} {metrics.get(k)}" for k in shown))
        log(f"  [{label}] kernel launches during the served run: {launches}")
        stops = metrics.get("repetition_stops", 0) - stops_before
        log(f"  [{label}] repetition guard {'on' if engine.sched.repetition_min_repeats else 'off'}"
            f": {stops:g} stop(s), {finishes.count('repetition')} of {len(finishes)} replies "
            f"finished \"repetition\"")
        if stops != finishes.count("repetition"):
            raise AssertionError(f"{label}: {stops:g} repetition stops in /metrics for "
                                 f"{finishes.count('repetition')} replies that finished on one")
        delta = require_replays(engine, graphs_before, label)
        if args.warmup == "full" and probe is None and delta["graph_captures"]:
            raise AssertionError(f"{label}: {delta['graph_captures']} graphs captured while "
                                 "serving after --warmup full")
        for name in required:
            if launches[name] < 1:
                raise AssertionError(f"{name} was not launched on the {label} path")
    return engine, launches, metrics, page


def graph_counts(engine) -> dict:
    return {key: engine.metrics[key] for key in ("steps", "graph_captures", "graph_replays")}


def require_replays(engine, before: dict, label: str) -> dict:
    """Every decode and verify chunk the engine ran since ``before``
    (:func:`graph_counts`) was a CUDA graph replay. Returns the deltas."""
    after = graph_counts(engine)
    delta = {key: after[key] - before[key] for key in after}
    log(f"  [{label}] decode chunks {delta['steps']}, graph replays {delta['graph_replays']}, "
        f"graphs captured {delta['graph_captures']} ({after['graph_captures']} in the engine)")
    if delta["steps"] < 1 or delta["graph_replays"] != delta["steps"]:
        raise AssertionError(f"{label}: {delta['graph_replays']} graph replays for "
                             f"{delta['steps']} decode chunks")
    return delta


def release() -> None:
    """Free a dropped engine's device memory, its graphs' pool included."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def chat_requests():
    """The three requests of the serving phases as (name, chat body): the
    demo page with prompt_layout_all_en, the receipt with prompt_ocr, and a
    text prompt."""
    from PIL import Image

    from dots_ocr_tpu_torch.utils.image_io import pil_to_base64
    from dots_ocr_tpu_torch.utils.prompts import dict_promptmode_to_prompt as prompts

    def chat(img, text):
        content = [{"type": "text", "text": text}]
        if img is not None:
            content = [{"type": "image_url", "image_url": {"url": pil_to_base64(img)}},
                       {"type": "text", "text": "<|img|><|imgpad|><|endofimg|>" + text}]
        return {"model": "flagship-random", "messages": [{"role": "user", "content": content}]}

    page = Image.open(os.path.join(REPO, "demo/assets/sample_page.png"))
    receipt = Image.open(os.path.join(REPO, "demo/assets/sample_receipt.png"))
    return [("page/prompt_layout_all_en", chat(page, prompts["prompt_layout_all_en"])),
            ("receipt/prompt_ocr", chat(receipt, prompts["prompt_ocr"])),
            ("text", chat(None, "Summarize the layout rules of a scanned invoice."))]


def _serve_wave(post, batch, label: str, temperature: float, others_admitted=None) -> dict:
    """Post the wave's requests concurrently (with ``others_admitted``, all
    but the first, and the first once that returns true); each must come
    back HTTP 200 with completion tokens. Logs each request and the wave's
    wall. Returns {request name: (text, usage)}."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(batch)) as pool:
        futures = [pool.submit(post, item) for item in batch[1:]]
        while others_admitted is not None and not others_admitted():
            if time.perf_counter() - t0 > 120:
                raise AssertionError(f"{label}: the first requests were not admitted in 120 s")
            time.sleep(0.01)
        futures.insert(0, pool.submit(post, batch[0]))
        results = [f.result() for f in futures]
    wall = time.perf_counter() - t0
    total_tokens = 0
    for name, status, data, secs in results:
        if status != 200:
            raise AssertionError(f"{name}: HTTP {status} {data}")
        usage = data["usage"]
        n = usage["completion_tokens"]
        if n < 1:
            raise AssertionError(f"{name}: no completion tokens")
        total_tokens += n
        lat = usage.get("latency", {})
        decode_s = lat.get("decode_ms", 0.0) / 1e3
        rate = (n - 1) / decode_s if decode_s > 0 else float("nan")
        log(f"  [{label}] {name}: HTTP {status}, prompt {usage['prompt_tokens']} tokens, "
            f"completion {n} tokens, finish {data['choices'][0]['finish_reason']}, "
            f"latency {secs * 1e3:.0f} ms (engine: ttft {lat.get('ttft_ms')} ms, "
            f"decode {lat.get('decode_ms')} ms -> {rate:.1f} tok/s after the first)")
    log(f"  [{label}] {len(batch)} concurrent request(s) at temperature {temperature:g}: wall "
        f"{wall:.2f} s, {total_tokens} completion tokens -> {total_tokens / wall:.1f} tok/s")
    return {name: (data["choices"][0]["message"]["content"], data["usage"])
            for name, _, data, _ in results}


def _page_inputs(engine, page, dev):
    """The page request's prompt ids and packed vision inputs, as the
    engine prepares them, with their device tensors."""
    import numpy as np
    import torch

    from dots_ocr_tpu_torch.utils.prompts import dict_promptmode_to_prompt as prompts
    from dots_ocr_tpu_torch.models.vlm import build_scatter_indices

    cfg = engine.config
    prep = engine.prepare(prompts["prompt_layout_all_en"], [page])
    ids = np.asarray([prep.prompt_ids], np.int64)
    sb, sp = build_scatter_indices(ids, cfg.special.imgpad_id, prep.packed.patches.shape[0] // 4,
                                   valid_rows=prep.packed.merged_valid_rows(4))

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    return prep.packed, ids, put, dict(scatter_batch=put(sb), scatter_pos=put(sp))


def _report(paths, what_first: str, same_argmax: bool = False) -> None:
    for i, (kl, rl) in enumerate(zip(paths["kernel"]["logits"], paths["reference"]["logits"])):
        diff, std = (kl - rl).abs(), float(rl.std())
        ratio = float(diff.max()) / std
        what = what_first if i == 0 else f"decode step {i}"
        same = bool((kl.argmax(-1) == rl.argmax(-1)).all())
        log(f"  {what}: max|logit diff| / std(plain logits) = {ratio:.4f} "
            f"(tol {LOGIT_TOL}), mean {float(diff.mean()) / std:.4f}, std {std:.4f}, "
            f"same argmax: {same}")
        if not ratio <= LOGIT_TOL or (same_argmax and not same):
            raise AssertionError(f"{what}: kernel path and plain path disagree "
                                 f"({ratio}, same argmax {same})")


@contextlib.contextmanager
def int4_impl(impl: str):
    """Point the int4 linears at ``int4_matmul.IMPLEMENTATIONS[impl]`` (the
    model reaches them through the "kernel" entry) for the duration."""
    from dots_ocr_tpu_torch.ops import int4_matmul

    saved = int4_matmul.IMPLEMENTATIONS["kernel"]
    int4_matmul.IMPLEMENTATIONS["kernel"] = int4_matmul.IMPLEMENTATIONS[impl]
    try:
        yield
    finally:
        int4_matmul.IMPLEMENTATIONS["kernel"] = saved


def consistency_chunked_phase(engine, page, dev, w8a8_vision: bool = False) -> None:
    """The page request of the shipped, the fully quantized, the windowed
    page-64 or the shipping.env path through the kernels and through the
    plain versions (int4 linears switched with :func:`int4_impl`) at the
    engine's page size, KV dtype and vision config: the chunked prefill
    (2,048-token chunks), then four decode steps fed the same tokens
    (kernel 2 in the engine's KV mode, or at page 64 int8 kernel 3, and
    their plain versions).

    With ``w8a8_vision`` both decoder passes take the kernel path's image
    embeddings, and the argmax must agree too. W8A8 re-quantizes every
    vision activation row to int8, so the flash kernel's bf16 rounding
    flips int8 codes and the encoder amplifies it (on random weights the
    page's logits then move by ~0.95 std where bf16 vision moves them by
    0.18 on an H100; PERF.md). The encoder is held instead to the noise of its
    own activation quantization: its kernel and plain outputs may differ
    by no more than W8A8 differs from the same integer weights applied to
    bf16 activations, both through the kernels."""
    import numpy as np
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import PageAllocator, PagedKV
    from dots_ocr_tpu_torch.models.decoder import (
        decoder_decode_step_paged,
        decoder_prefill_extend_batched,
        embed_tokens,
        logits_from_hidden,
    )
    from dots_ocr_tpu_torch.models.rope import vision_rope_device
    from dots_ocr_tpu_torch.models.vision import encode_images
    from dots_ocr_tpu_torch.models.vlm import splice_vision_embeddings

    cfg, params = engine.config, engine.params
    page_size = engine.sched.page_size
    packed, ids, put, scatter = _page_inputs(engine, page, dev)
    t = ids.shape[1]
    ct = PREFILL_CHUNK
    bucket = -(-t // ct) * ct
    padded = np.full((1, bucket), cfg.special.pad_token_id, np.int64)
    padded[0, :t] = ids[0]
    steps = 4
    alloc = PageAllocator(-(-(t + steps) // page_size) + 1, page_size,
                          -(-(bucket + steps) // page_size))
    alloc.allocate(0, t + steps)
    table = put(alloc.padded_table(0)[None])
    cos, sin = vision_rope_device(put(packed.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    paths = {}
    with torch.no_grad():
        visions = {impl: encode_images(params["vision"], cfg.vision, put(packed.patches), cos,
                                       sin, put(packed.segment_ids), attn_impl=impl)
                   for impl in ("kernel", "reference")}
        if w8a8_vision:
            _w8a8_vision_noise(params["vision"], cfg, visions, put(packed.patches), cos, sin,
                               put(packed.segment_ids))
        for impl in ("kernel", "reference"):
            with int4_impl(impl):
                vision = visions["kernel" if w8a8_vision else impl]
                embeds = splice_vision_embeddings(embed_tokens(params["decoder"], put(padded)),
                                                  vision, scatter["scatter_batch"],
                                                  scatter["scatter_pos"])
                paged = PagedKV.create(cfg.decoder, alloc.num_pages, page_size, cfg.torch_dtype,
                                       dev, quantized=engine.sched.kv_cache_dtype == "int8")
                for start in range(0, bucket, ct):
                    n_valid = min(ct, t - start)
                    slots = np.zeros((1, ct), np.int64)
                    slots[0, :n_valid] = alloc.slot_mapping(0, start, n_valid)
                    hidden = decoder_prefill_extend_batched(
                        params["decoder"], cfg.decoder, embeds[:, start:start + ct],
                        start + torch.arange(ct, device=dev), put(np.array([t])), paged.k,
                        paged.v, table[:, :(start + ct) // page_size], put(slots), page_size,
                        start + ct, start, attn_impl=impl, k_scales=paged.k_scale,
                        v_scales=paged.v_scale)
                last = hidden[:, t - 1 - (bucket - ct)]
                paths[impl] = {"logits": [logits_from_hidden(params["decoder"], cfg.decoder,
                                                             last)], "paged": paged}
        token = paths["kernel"]["logits"][0].argmax(-1)
        for step in range(steps):
            pos = t + step
            for impl, path in paths.items():
                with int4_impl(impl):
                    hidden = decoder_decode_step_paged(
                        params["decoder"], cfg.decoder, embed_tokens(params["decoder"], token),
                        put(np.array([pos])), path["paged"].k, path["paged"].v, table,
                        put(np.array([pos + 1], np.int32)), put(alloc.slot_mapping(0, pos, 1)),
                        page_size, attn_impl=impl, k_scales=path["paged"].k_scale,
                        v_scales=path["paged"].v_scale)
                path["logits"].append(logits_from_hidden(params["decoder"], cfg.decoder, hidden))
            token = paths["kernel"]["logits"][-1].argmax(-1)
    log(f"  page request: {t} prompt tokens ({packed.num_merged} image tokens), "
        f"{bucket // ct} chunks of {ct}"
        + (", the kernel path's image embeddings in both" if w8a8_vision else ""))
    _report(paths, "chunked prefill", same_argmax=w8a8_vision)


def _w8a8_vision_noise(vparams, cfg, visions, patches, cos, sin, segment_ids) -> None:
    """The W8A8 encoder's kernel-vs-plain difference against the noise of
    its activation quantization (see consistency_chunked_phase)."""
    import torch

    from dots_ocr_tpu_torch.models.quantize import BLOCK_KERNELS
    from dots_ocr_tpu_torch.models.vision import encode_images

    blocks = dict(vparams["blocks"])
    for group, name in BLOCK_KERNELS:
        k = blocks[group][name]
        blocks[group] = {**blocks[group], name: (k["qint8_act"].to(torch.float32)
                                                 * k["scale"][..., None, :]).to(cfg.torch_dtype)}
    dense = encode_images({**vparams, "blocks": blocks}, cfg.vision, patches, cos, sin,
                          segment_ids)
    kern = visions["kernel"].float()
    gap = float((kern - visions["reference"].float()).abs().max())
    noise = float((kern - dense.float()).abs().max())
    log(f"  W8A8 vision: kernel vs plain path max|diff| {gap:.4f}; W8A8 vs the same integer "
        f"weights on bf16 activations {noise:.4f} (image embeddings: std {float(kern.std()):.3f})")
    if not (torch.isfinite(kern).all() and gap <= noise):
        raise AssertionError(f"W8A8 vision: kernel vs plain {gap} exceeds the activation "
                             f"quantization noise {noise}")


def consistency_phase(engine, page, dev) -> None:
    """The bf16 path's page request through the kernels and through the
    plain versions: prefill logits, then four paged decode steps fed the
    same tokens."""
    import numpy as np
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import PageAllocator, PagedKV, write_prefill_kv
    from dots_ocr_tpu_torch.models.decoder import (
        decoder_decode_step_paged,
        embed_tokens,
        logits_from_hidden,
    )
    from dots_ocr_tpu_torch.models.rope import vision_rope_device
    from dots_ocr_tpu_torch.models.vlm import vlm_prefill

    cfg, params = engine.config, engine.params
    packed, ids, put, scatter = _page_inputs(engine, page, dev)
    t = ids.shape[1]
    cos, sin = vision_rope_device(put(packed.pos2d), cfg.vision.head_dim, cfg.vision.rope_theta)
    steps = 4
    alloc = PageAllocator(-(-(t + steps) // PAGE_SIZE) + 1, PAGE_SIZE, 64)
    alloc.allocate(0, t + steps)
    table = put(alloc.padded_table(0)[None])
    paths = {}
    with torch.no_grad():
        for impl in ("kernel", "reference"):
            logits, cache = vlm_prefill(
                params, cfg, put(ids), put(np.arange(t)[None]), put(np.array([t])),
                patches=put(packed.patches), rope_cos=cos, rope_sin=sin,
                segment_ids=put(packed.segment_ids), attn_impl=impl, last_logit_only=True,
                **scatter)
            paged = PagedKV.create(cfg.decoder, alloc.num_pages, PAGE_SIZE,
                                   cfg.torch_dtype, dev)
            write_prefill_kv(paged, cache.k, cache.v, put(alloc.slot_mapping(0, 0, t)))
            paths[impl] = {"logits": [logits], "paged": paged}
        token = paths["kernel"]["logits"][0].argmax(-1)
        for step in range(steps):
            pos = t + step
            for impl, path in paths.items():
                hidden = decoder_decode_step_paged(
                    params["decoder"], cfg.decoder, embed_tokens(params["decoder"], token),
                    put(np.array([pos])), path["paged"].k, path["paged"].v, table,
                    put(np.array([pos + 1], np.int32)), put(alloc.slot_mapping(0, pos, 1)),
                    PAGE_SIZE, attn_impl=impl)
                path["logits"].append(logits_from_hidden(params["decoder"], cfg.decoder, hidden))
            token = paths["kernel"]["logits"][-1].argmax(-1)
    log(f"  page request: {t} prompt tokens ({packed.num_merged} image tokens)")
    _report(paths, "prefill")


def decode_cost_phase(engine, dev):
    """One decode step for 64 slots at 2,048-token contexts: the engine's
    bf16 weights and their int8 quantization (the W8A16 kernel) over a
    bf16 pool, the shipped pair (int8
    weights over an int8 pool), int4 weights over an int8 pool in both of
    the kernel's modes (``DOTS_INT4_ACT``), and the bf16 step with
    ``attn_impl="v1"`` (kernel 3's bf16 mode on every layer, the JAX
    decoder's ``paged_v1``). Medians of REPS CUDA-event timings, taken in
    turns. Returns (the medians, the launch counts of the timed runs)."""
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import PagedKV
    from dots_ocr_tpu_torch.models.decoder import (
        decoder_decode_step_paged,
        embed_tokens,
        logits_from_hidden,
    )
    from dots_ocr_tpu_torch.models.quantize import (
        quantize_decoder_params,
        quantize_decoder_params_int4,
    )

    cfg = engine.config
    ctx, pages_per_row = 2048, 2048 // PAGE_SIZE + 1
    pools = {dtype: PagedKV.create(cfg.decoder, MAX_SLOTS * pages_per_row + 1, PAGE_SIZE,
                                   cfg.torch_dtype, dev, quantized=dtype == "int8")
             for dtype in ("bf16", "int8")}
    table = (1 + torch.arange(MAX_SLOTS * pages_per_row, device=dev, dtype=torch.int32)
             ).reshape(MAX_SLOTS, pages_per_row)
    pos = torch.full((MAX_SLOTS,), ctx, dtype=torch.int64, device=dev)
    slots = table[:, ctx // PAGE_SIZE].long() * PAGE_SIZE + ctx % PAGE_SIZE
    lens = (pos + 1).to(torch.int32)
    tokens = (torch.arange(MAX_SLOTS, device=dev) * 7 + 100) % cfg.decoder.vocab_size
    weights = {"bf16": engine.params["decoder"],
               "int8": quantize_decoder_params(engine.params["decoder"]),
               "int4": quantize_decoder_params_int4(engine.params["decoder"])}

    def step(p, paged, w4a8=False, attn_impl="kernel"):
        def run():
            os.environ["DOTS_INT4_ACT"] = "1" if w4a8 else "0"
            try:
                with torch.no_grad():
                    h = decoder_decode_step_paged(p, cfg.decoder, embed_tokens(p, tokens), pos,
                                                  paged.k, paged.v, table, lens, slots, PAGE_SIZE,
                                                  attn_impl=attn_impl, k_scales=paged.k_scale,
                                                  v_scales=paged.v_scale)
                    return logits_from_hidden(p, cfg.decoder, h)
            finally:
                del os.environ["DOTS_INT4_ACT"]
        return run

    fns = {"bf16 weights, bf16 KV": step(weights["bf16"], pools["bf16"]),
           "int8 weights, bf16 KV": step(weights["int8"], pools["bf16"]),
           "int8 weights, int8 KV": step(weights["int8"], pools["int8"]),
           "int4 weights, int8 KV": step(weights["int4"], pools["int8"]),
           "int4 W4A8 weights, int8 KV": step(weights["int4"], pools["int8"], w4a8=True),
           "bf16 weights, bf16 KV, v1 kernel": step(weights["bf16"], pools["bf16"],
                                                    attn_impl="v1")}
    reset_counts()
    res = time_in_turns(fns, inner=1)
    launches = read_counts()
    log(f"  decode step, {MAX_SLOTS} slots x {ctx} context (median of {REPS}): "
        + ", ".join(f"{name} {ms:.3f} ms" for name, ms in res.items()))
    log(f"  kernel launches during the timed steps: {launches}")
    for name in ("int4_matmul", "int4_matmul_w4a8", "paged_attention_multiquery_int8",
                 "paged_attention_v1", "w8a16_matmul"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched in the decode steps")
    return res, launches


def guard_off(engine) -> None:
    """The engine's repetition guard off, where a phase compares token
    streams whose chunks land at different steps: phase 12 (a dry pool, so
    preemptions move the chunk boundaries) against phase 4's DRY_TOKENS
    wave, hence phase 4 too, and phase 13's two arms. The guard reads a
    request's tail when a chunk lands, so it would stop the same looping
    random-weight stream at different tokens. Phases 11 and 13's HTTP wave
    serve with it on, and :func:`serve_phase` holds its stops to the
    replies that finished on it."""
    import dataclasses

    engine.sched = dataclasses.replace(engine.sched, repetition_min_repeats=0)


def dry_pool_pages(prompt_tokens, page_size: int) -> int:
    """A pool that admits all the prompts and little more: the null page,
    each prompt's pages (its tokens and the first generated one),
    DRY_SLACK_PAGES, and the admission watermark (ADMIT_FREE_FRACTION of
    the pool, kept free at admission)."""
    need = sum(-(-(n + 1) // page_size) for n in prompt_tokens) + DRY_SLACK_PAGES
    pages = need + 1
    while pages - 1 - int(pages * ADMIT_FREE_FRACTION) < need:
        pages += 1
    return pages


def dry_pool_phase(dev, roomy: dict, label: str = "dry pool"):
    """Phase 12: phase 4's flags on a pool cut to :func:`dry_pool_pages` of
    the three prompts, the requests of ``roomy`` (phase 4's DRY_TOKENS
    wave on the full pool: {name: (text, usage)}) again at DRY_TOKENS, the
    page request last. All HTTP 200, at least one preemption, the same
    greedy text, one more request served afterwards. Returns the run's
    launch counts and metrics."""
    pages = dry_pool_pages([usage["prompt_tokens"] for _, usage in roomy.values()], PAGE_SIZE)
    log(f"  prompts of {[usage['prompt_tokens'] for _, usage in roomy.values()]} tokens: a pool "
        f"of {pages} pages x {PAGE_SIZE} (the full pool has {NUM_PAGES}), {DRY_TOKENS} tokens "
        f"each")
    replies = []
    engine, launches, metrics, _ = serve_phase(
        dev, [*SHIPPED_FLAGS, "--num-pages", str(pages)], label,
        required=("flash_attention", "paged_attention_multiquery_int8"),
        waves=((0.0, DRY_TOKENS),), replies=replies, one_more=True, page_last=True,
        before_serve=guard_off)
    if metrics.get("preemptions", 0) < 1:
        raise AssertionError(f"{label}: no preemption on a pool of {pages} pages ({metrics})")
    for name, (text, usage) in replies[0].items():
        want, want_usage = roomy[name]
        same = text == want and usage["completion_tokens"] == want_usage["completion_tokens"]
        log(f"  [{label}] {name}: {usage['completion_tokens']} completion tokens, text equal to "
            f"the full pool's: {same}")
        if not same:
            raise AssertionError(f"{label}: {name} differs from the full pool's answer:\n"
                                 f"{text!r}\nvs\n{want!r}")
    if engine.has_work() or engine.allocator.free_pages != pages - 1:
        raise AssertionError(f"{label}: the engine did not drain "
                             f"({engine.allocator.free_pages} of {pages - 1} pages free)")
    log(f"  [{label}] {int(metrics['preemptions'])} preemption(s), every request HTTP 200 with "
        f"the full pool's text, one more request served, the pool drained")
    return launches, metrics


def pipeline_ab_phase(dev, env_flags) -> dict:
    """Phase 13: the pipelined decode A/B at full width. Two flagship
    engines of ``env_flags`` with speculation off on one set of weights,
    each warmed first (``warmup_decode``, then one short wave): (a)
    synchronous chunks of steps_per_sync (the decode loop before the port's
    pipeline), (b) the defaults (deep chunks of max_steps_per_sync,
    lookahead-1). In turns PIPELINE_TURNS, the engine of the turn serves
    the three requests, greedy, PIPELINE_TOKENS new tokens each, in this
    process. Every run must give the same token ids, from graph replays
    captured before the turns; (b) must pipeline and upload its chunk
    inputs on fewer chunks than it runs, (a) must not pipeline. Returns the
    runs' numbers by turn."""
    import dataclasses

    import torch

    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine
    from dots_ocr_tpu_torch.serve import server as torch_server
    from dots_ocr_tpu_torch.serve.openai_server import parse_chat_messages

    args = torch_server.build_parser().parse_args([
        "--random-flagship", "--platform", str(dev), *env_flags, "--speculate-k", "0"])
    t0 = time.perf_counter()
    base = torch_server.build_engine(args)
    torch.cuda.synchronize()
    prepared = []
    for name, body in chat_requests():
        prompt, images, system = parse_chat_messages(body["messages"])
        prepared.append((name, base.prepare(prompt, images, system_prompt=system)))
    # The repetition guard off in both arms: it reads a request's tail when a
    # chunk lands, so (a)'s 16-step chunks and (b)'s deep ones stop a looping
    # random-weight stream at different tokens; without it both run every
    # request to PIPELINE_TOKENS and must emit the same ids.
    guard_off(base)
    scheds = {"a": dataclasses.replace(base.sched, pipeline_decode=False,
                                       max_steps_per_sync=base.sched.steps_per_sync),
              "b": base.sched}
    log(f"  flagship engine built in {time.perf_counter() - t0:.1f} s ({args.quantize} weights, "
        f"{args.kv_cache_dtype} KV, speculate_k 0, repetition guard off); (a) pipeline_decode False, "
        f"max_steps_per_sync {scheds['a'].max_steps_per_sync}; (b) pipeline_decode "
        f"{scheds['b'].pipeline_decode}, max_steps_per_sync {scheds['b'].max_steps_per_sync}; "
        f"steps_per_sync {base.sched.steps_per_sync}; turns {PIPELINE_TURNS}")

    engines = {"a": ContinuousBatchingEngine(base.params, base.config, dev, sched=scheds["a"]),
               "b": base}

    def serve(eng, max_new):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids = [eng.submit("", max_new_tokens=max_new, temperature=0.0, prepared=prep)
               for _, prep in prepared]
        eng.run()
        torch.cuda.synchronize()
        return [eng.finished_request(i) for i in ids], time.perf_counter() - t

    for label, eng in engines.items():
        # Out of the timed turns: every decode graph the turns dispatch, and
        # the first calls of every kernel and cuBLAS shape.
        t = time.perf_counter()
        eng.warmup_decode(nucleus_variants=(False,))
        serve(eng, 16)
        log(f"  ({label}) warmed in {time.perf_counter() - t:.1f} s: "
            f"{eng.metrics['graph_captures']} graphs")
    runs, tokens = [], None
    for turn, label in enumerate(PIPELINE_TURNS):
        eng = engines[label]
        before = dict(eng.metrics)
        reset_counts()
        reqs, wall = serve(eng, PIPELINE_TOKENS)
        launches = read_counts()
        m = {key: eng.metrics[key] - before[key] for key in before}
        if tokens is None:
            tokens = [r.output_ids for r in reqs]
        same = [r.output_ids for r in reqs] == tokens
        rates = {name: (len(r.output_ids) - 1) / (r.timing()["decode_ms"] / 1e3)
                 for (name, _), r in zip(prepared, reqs)}
        run = dict(label=label, wall_s=wall, decode_tok_s=rates, t_decode_s=m["t_decode_s"],
                   steps=m["steps"], chunk_input_rebuilds=m["chunk_input_rebuilds"],
                   pipelined_chunks=m["pipelined_chunks"],
                   fetch_wait_ms_per_chunk=1e3 * m["t_fetch_wait_s"] / max(1, m["steps"]),
                   completion_tokens=[len(r.output_ids) for r in reqs],
                   kernel2_launches=launches["paged_attention_multiquery"],
                   flash_launches=launches["flash_attention"],
                   w8a16_launches=launches["w8a16_matmul"])
        log(f"  [13 turn {turn + 1}: ({label})] wall {wall:.2f} s; decode tok/s after the first "
            + ", ".join(f"{name} {rate:.1f}" for name, rate in rates.items())
            + f"; t_decode_s {m['t_decode_s']:.2f}; steps {m['steps']}; chunk_input_rebuilds "
            f"{m['chunk_input_rebuilds']}; pipelined_chunks {m['pipelined_chunks']}; fetch wait "
            f"{run['fetch_wait_ms_per_chunk']:.2f} ms a chunk; completion tokens "
            f"{run['completion_tokens']} (finish {[r.finished_reason for r in reqs]}); kernel 2 "
            f"bf16 {run['kernel2_launches']}, flash {run['flash_launches']}, W8A16 "
            f"{run['w8a16_launches']} launches; token ids equal to turn 1's: {same}")
        if not same:
            raise AssertionError(f"phase 13: turn {turn + 1} ({label}) emitted other token ids")
        if label == "a" and m["pipelined_chunks"] != 0:
            raise AssertionError(f"phase 13: (a) pipelined {m['pipelined_chunks']} chunks")
        if label == "b" and not (m["pipelined_chunks"] > 0
                                 and m["chunk_input_rebuilds"] < m["steps"]):
            raise AssertionError(f"phase 13: (b) pipelined {m['pipelined_chunks']} chunks, "
                                 f"{m['chunk_input_rebuilds']} rebuilds in {m['steps']} steps")
        if min(run["kernel2_launches"], run["flash_launches"], run["w8a16_launches"]) < 1:
            raise AssertionError(f"phase 13: turn {turn + 1} launched no kernel 2, flash or "
                                 "W8A16")
        if require_replays(eng, before, f"13 turn {turn + 1}")["graph_captures"]:
            raise AssertionError(f"phase 13: turn {turn + 1} captured a graph after the warmup")
        runs.append(run)
    del engines, eng, base
    release()
    for label in ("a", "b"):
        mine = [r for r in runs if r["label"] == label]
        log(f"  [13] ({label}) over its turns: wall "
            + " / ".join(f"{r['wall_s']:.2f}" for r in mine) + " s; fetch wait "
            + " / ".join(f"{r['fetch_wait_ms_per_chunk']:.2f}" for r in mine) + " ms a chunk")
    return {"turns": runs}


def first_text_token(engine):
    """Phase 14's reference, before its server starts: the text request's
    first greedy token and its logprob, from the engine itself."""
    from dots_ocr_tpu_torch.serve.openai_server import parse_chat_messages

    prompt, images, system = parse_chat_messages(chat_requests()[2][1]["messages"])
    rid = engine.submit(prompt, images, max_new_tokens=1, temperature=0.0, logprobs=True,
                        system_prompt=system)
    engine.run()
    req = engine.finished_request(rid)
    engine.take_finished(rid)
    return req.output_ids[0], req.output_logprobs[0]


def logit_options_probe(post, metrics, first) -> None:
    """Phase 14, on the server of deploy/shipping.env as written after phase
    13's pipelined wave (which must have pipelined): logprobs, logit_bias,
    penalties and seed over HTTP, each request alone on the engine."""
    log("[14/20] the logit options over HTTP on the shipping.env server")
    text = chat_requests()[2][1]

    def ask(max_tokens, **options):
        status, data = post({**text, "temperature": 0.0, "max_tokens": max_tokens, **options})
        if status != 200:
            raise AssertionError(f"phase 14: {options} -> HTTP {status} {data}")
        return data

    before = metrics()
    if before.get("pipelined_chunks", 0) < 1:
        raise AssertionError(f"phase 13: the k = 2 wave pipelined no chunk ({before})")
    ask(32)  # control: a plain greedy request speculates
    plain = metrics()
    if plain["spec_chunks"] <= before["spec_chunks"]:
        raise AssertionError("phase 14: the plain control request ran no verify chunk")
    data = ask(32, logprobs=True)
    content = data["choices"][0]["logprobs"]["content"]
    lps = [entry["logprob"] for entry in content]
    after_lp = metrics()
    log(f"  logprobs: {len(lps)} for {data['usage']['completion_tokens']} tokens, max "
        f"{max(lps):.4f}, min {min(lps):.4f}; the first {lps[0]:.6f} (the engine's own before "
        f"the server started: {first[1]:.6f}); spec_chunks {plain['spec_chunks']:.0f} -> "
        f"{after_lp['spec_chunks']:.0f} (the plain control: {before['spec_chunks']:.0f} -> "
        f"{plain['spec_chunks']:.0f})")
    if (len(lps) != data["usage"]["completion_tokens"]
            or not all(lp <= 0.0 and lp == lp and abs(lp) != float("inf") for lp in lps)
            or abs(lps[0] - first[1]) > 1e-3 or after_lp["spec_chunks"] != plain["spec_chunks"]):
        raise AssertionError("phase 14: logprobs")
    # The banned token's biased logprob is at most its unbiased margin - 100,
    # so a first logprob above -50 is another token's.
    banned = ask(4, logprobs=True, logit_bias={str(first[0]): -100})
    lp_banned = banned["choices"][0]["logprobs"]["content"][0]["logprob"]
    log(f"  logit_bias {{{first[0]}: -100}} (the unbiased first token): the first token's "
        f"logprob {lp_banned:.4f} (unbiased {lps[0]:.4f})")
    if not lp_banned > -50.0:
        raise AssertionError("phase 14: the banned token came first")
    boosted = ask(6, logit_bias={str(ord("A")): 100})
    log(f"  logit_bias {{{ord('A')}: +100}}: {boosted['choices'][0]['message']['content']!r}, "
        f"finish {boosted['choices'][0]['finish_reason']}")
    if boosted["choices"][0]["message"]["content"] != "A" * 6:
        raise AssertionError("phase 14: the boosted token was not every token")
    before_pen, verify_before = metrics(), read_counts()["paged_attention_multiquery (nq > 1)"]
    penalized = ask(32, frequency_penalty=2.0, presence_penalty=1.0)
    after_pen = metrics()
    verify_after = read_counts()["paged_attention_multiquery (nq > 1)"]
    log(f"  frequency_penalty 2.0, presence_penalty 1.0: {penalized['usage']['completion_tokens']} "
        f"tokens; spec_chunks {before_pen['spec_chunks']:.0f} -> {after_pen['spec_chunks']:.0f}, "
        f"verify launches {verify_before} -> {verify_after}")
    if after_pen["spec_chunks"] != before_pen["spec_chunks"] or verify_after != verify_before:
        raise AssertionError("phase 14: a penalized request ran verify steps")
    # Sampled tokens of random weights are mostly ids the byte tokenizer
    # decodes to nothing: the streams are compared by their logprobs.
    def stream(seed):
        data = ask(16, temperature=1.0, seed=seed, logprobs=True)
        return [entry["logprob"] for entry in data["choices"][0]["logprobs"]["content"]]

    launches = read_counts()["gumbel_argmax"]
    seeded, other = [stream(1), stream(1)], stream(2)
    draws = read_counts()["gumbel_argmax"] - launches
    log(f"  seed 1 twice at temperature 1, logprobs {seeded[0][:4]} / {seeded[1][:4]}; seed 2: "
        f"{other[:4]}; {draws} launches of the draw kernel")
    if seeded[0] != seeded[1] or seeded[0] == other or draws < 1:
        raise AssertionError("phase 14: seeded sampling over HTTP")


# The seeded draw kernel's cases: the full vocabulary and the nucleus pool
# at 64 rows (a 64-slot decode step), with the rows' keys given or folded
# in the kernel from the slot keys and positions (the scheduler's calls).
# Both bounds count the operations the function needs, reckoned from its
# definition (not from the kernel's instructions, which add addressing and
# loop control), at one operation a lane a clock: the instruction rate
# behind the float32 67 TFLOP/s of the data sheet, an FMA counted once
# (33.5 T/s). threefry2x32: 73 an element (20 rounds of add, rotate and
# xor, 5 key injections of two adds, the counter's add, the output's xor).
# A draw's column: its threefry, the uniform from the bits (shift, or,
# subtract, multiply-add, max: 5), two accurate logf (25 each: 4 for a
# subnormal argument, 5 for the exponent split and its float, 2 for the
# reduced argument and its square, 9 polynomial multiply-adds and one for
# the exponent times ln 2, 4 for the special cases), the add and the
# argmax's compare and two selects (4), and with temperatures an IEEE
# division (7: the reciprocal, five multiply-adds, the range check); a
# row's key folds cost one threefry each.
INSTRUCTIONS_PER_S = PEAK_OPS_PER_S["fp32"] / 2
THREEFRY_OPS_PER_ELEMENT = 73
DRAW_OPS_PER_COLUMN = THREEFRY_OPS_PER_ELEMENT + 5 + 2 * 25 + 4
DRAW_DIVIDE_OPS = 7
DRAW_REPEATS = 20


def sass_loop_instructions(function: str):
    """({opcode: count}, total) of the column loop of ``function`` (a
    substring of its name) in the built kernel library's SASS: of its loops,
    the one with the most FFMA (logf's polynomial), or None where cuobjdump
    is missing or no loop has one. A diagnostic beside the bound."""
    import collections
    import re
    import shutil

    from dots_ocr_tpu_torch.ops import kernel_lib

    tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None or kernel_lib.lib_path is None:
        return None
    sass = subprocess.run([tool, "-sass", kernel_lib.lib_path], capture_output=True, text=True,
                          timeout=120).stdout
    body = next((f for f in re.split(r"\n\s*Function : ", sass)
                 if function in f.split("\n", 1)[0]), None)
    if body is None:
        return None
    ins = [(int(m.group(1), 16), m.group(2).strip()) for m in
           (re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?);", ln) for ln in body.splitlines()) if m]
    loops = []
    for addr, text in ins:
        target = re.search(r"BRA\s+(0x[0-9a-f]+)", text)
        if target and int(target.group(1), 16) <= addr:
            loop = [t for a, t in ins if int(target.group(1), 16) <= a <= addr]
            loops.append(collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0] for t in loop))
    loop = max(loops, key=lambda ops: ops["FFMA"], default=None)
    if loop is None or loop["FFMA"] == 0:
        return None
    return dict(loop.most_common()), sum(loop.values())


def threefry_cases(dev) -> dict:
    """The threefry entry (csrc/threefry_sample.cu) at the main path's
    calls, bit for bit against its plain version (``threefry_grid_reference``
    on the same card), DRAW_REPEATS repeats bit-identical, timed in turns
    and as CUDA graphs: the verify's step keys (64 slot keys folded with
    their positions), its acceptance uniforms (64 keys x 2, minval 1e-20)
    and a split of one key into 64. No PyTorch call computes threefry: no
    library time."""
    import torch

    from dots_ocr_tpu_torch.engine.sampling import prng_key
    from dots_ocr_tpu_torch.ops.sampling import (
        UNIFORM,
        fold_in,
        split,
        threefry_grid_reference,
        uniform,
    )

    key = prng_key(2**32 + 5).to(dev)
    keys = threefry_grid_reference(key[0], key[1], 0, 0, MAX_SLOTS)
    pos = torch.arange(MAX_SLOTS, device=dev) * 7919 + 40000
    cases = [
        (f"threefry fold_in [{MAX_SLOTS}, 2] keys x positions (the verify's step keys)",
         lambda: fold_in(keys, pos),
         lambda: threefry_grid_reference(keys[:, 0], keys[:, 1], 0, pos), MAX_SLOTS, 16 + 8 + 16),
        (f"threefry uniform [{MAX_SLOTS}, 2] minval 1e-20 (the verify's acceptance)",
         lambda: uniform(keys, 2, 1e-20),
         lambda: threefry_grid_reference(keys[:, 0:1], keys[:, 1:2], 0, 0, 2, UNIFORM, 1e-20),
         2 * MAX_SLOTS, 16 + 2 * 4),
        (f"threefry split of one key into {MAX_SLOTS}", lambda: split(key, MAX_SLOTS),
         lambda: threefry_grid_reference(key[0], key[1], 0, 0, MAX_SLOTS), MAX_SLOTS, 16),
    ]
    out = []
    for name, kernel_fn, plain_fn, elements, row_bytes in cases:
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        as_int = (lambda t: t.view(torch.int32)) if got.dtype == torch.float32 else (lambda t: t)
        if got.shape != want.shape or not torch.equal(as_int(got), as_int(want)):
            raise AssertionError(f"{name}: differs from the plain version")
        same = sum(bool(torch.equal(as_int(kernel_fn()), as_int(got)))
                   for _ in range(DRAW_REPEATS))
        if same != DRAW_REPEATS:
            raise AssertionError(f"{name}: {DRAW_REPEATS - same} repeated calls differ")
        times = time_in_turns({"ms": kernel_fn, "plain_ms": plain_fn})
        ops, nbytes = elements * THREEFRY_OPS_PER_ELEMENT, MAX_SLOTS * row_bytes
        work = {"bound_ms": max(ops / INSTRUCTIONS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
                "bound_by": "operations" if ops / INSTRUCTIONS_PER_S >= nbytes / HBM_BYTES_PER_S
                else "bytes", "flops": float(ops), "bytes": float(nbytes), "peak": "instruction rate"}
        res = {"case": name, "max_abs_err": 0.0, "library_ms": None, **times, **work,
               "graph_ms": {"ms": graph_ms(kernel_fn), "plain_ms": graph_ms(plain_fn)}}
        log(f"  {name}: bit-equal, {same} of {DRAW_REPEATS} repeats bit-identical; kernel "
            f"{res['ms']:.4f} ms, plain {res['plain_ms']:.3f} ms; as CUDA graphs kernel "
            f"{res['graph_ms']['ms']:.4f}, plain {res['graph_ms']['plain_ms']:.4f} ms; bound "
            f"{res['bound_ms']:.6f} ms")
        out.append(res)
    return {"threefry2x32": out}


def draw_cases(dev) -> dict:
    """The fused seeded draw (csrc/threefry_sample.cu) against its plain
    version: tokens and Gumbel noise bit for bit, DRAW_REPEATS repeated
    calls bit-identical, then both timed in turns, and the kernel as a CUDA
    graph (its device time). No single PyTorch call draws threefry
    Gumbel-max: no library time. The first case is the main path's: slot
    keys and positions folded in the kernel, temperatures fused."""
    import numpy as np
    import torch

    from dots_ocr_tpu_torch.engine.sampling import prng_key, split
    from dots_ocr_tpu_torch.ops.sampling import (
        fold_keys_reference,
        gumbel_argmax,
        gumbel_argmax_reference,
        gumbel_noise,
    )

    sass = sass_loop_instructions("gumbel_argmax_kernel")
    log(f"  the draw's bound: {DRAW_OPS_PER_COLUMN} operations a column "
        f"(+{DRAW_DIVIDE_OPS} with temperatures), {THREEFRY_OPS_PER_ELEMENT} a key fold, at "
        f"{INSTRUCTIONS_PER_S / 1e12:.1f} T/s; the kernel's column loop (2 columns an "
        f"iteration): " + (f"{sass[1]} SASS instructions {sass[0]}" if sass else "not read"))
    rng = np.random.RandomState(7)
    vocab = 151936
    temps = torch.from_numpy(rng.uniform(0.05, 1.5, MAX_SLOTS).astype(np.float32)).to(dev)
    temps[::5] = 0.1  # the parser's default temperature
    logits = torch.from_numpy((rng.randn(MAX_SLOTS, vocab) * 3).astype(np.float32)).to(dev)
    masked = logits.clone()
    masked[:, rng.rand(vocab) < 0.3] = float("-inf")
    masked[3] = float("-inf")  # a row of only -inf: token 0
    pool = torch.from_numpy(np.sort(rng.randn(MAX_SLOTS, 256).astype(np.float32) * 3,
                                    axis=1)[:, ::-1].copy()).to(dev)
    keep = torch.arange(256, device=dev)[None] < torch.from_numpy(
        rng.randint(1, 257, MAX_SLOTS)).to(dev)[:, None]
    pool = pool.masked_fill(~keep, float("-inf"))
    shared, per_row = prng_key(11).to(dev), split(prng_key(12), MAX_SLOTS).to(dev)
    pos = torch.from_numpy(rng.randint(0, 40960, MAX_SLOTS).astype(np.int64)).to(dev)
    cases = [
        (f"draw [64, {vocab}] slot keys + positions folded in the kernel, temperatures fused",
         logits, per_row, temps, {"positions": pos}),
        (f"draw [64, {vocab}] slot keys + positions + tag 1 folded in the kernel (nucleus "
         f"sampler, full vocabulary)", logits, per_row, None, {"positions": pos, "tag": 1}),
        ("draw [64, 256] nucleus pool, slot keys + positions + tag 0 folded in the kernel, -inf "
         "past each kept prefix", pool, per_row, None, {"positions": pos, "tag": 0}),
        (f"draw [64, {vocab}] shared key, temperatures fused", logits, shared, temps, {}),
        (f"draw [64, {vocab}] per-row keys, mixed temperatures, 30% -inf, one -inf row",
         masked, per_row, temps, {}),
    ]
    out = []
    for name, x, keys, t, fold in cases:
        b, v = x.shape
        noise = torch.empty_like(x)
        got = gumbel_argmax(x, keys, t, noise_out=noise, **fold)
        want = gumbel_argmax_reference(x, keys, t, **fold)
        want_noise = gumbel_noise(fold_keys_reference(keys, **fold), b, v)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"{name}: {bad} of {b} tokens differ from the plain version")
        if not torch.equal(noise.view(torch.int32), want_noise.view(torch.int32)):
            raise AssertionError(f"{name}: the Gumbel noise differs from the plain version")
        if name.endswith("one -inf row") and int(got[3]) != 0:
            raise AssertionError(f"{name}: the all -inf row drew {int(got[3])}, not 0")
        same = sum(bool(torch.equal(gumbel_argmax(x, keys, t, **fold), got))
                   for _ in range(DRAW_REPEATS))
        if same != DRAW_REPEATS:
            raise AssertionError(f"{name}: {DRAW_REPEATS - same} repeated calls differ")
        del noise, want_noise
        times = time_in_turns({"ms": lambda: gumbel_argmax(x, keys, t, **fold),
                               "plain_ms": lambda: gumbel_argmax_reference(x, keys, t, **fold)})
        device_ms = graph_ms(lambda: gumbel_argmax(x, keys, t, **fold))
        nbytes = (x.numel() * 4 + b * 8 + (b * 4 if t is not None else 0) + keys.numel() * 8
                  + (b * 8 if "positions" in fold else 0))
        per_column = DRAW_OPS_PER_COLUMN + (DRAW_DIVIDE_OPS if t is not None else 0)
        folds = ("positions" in fold) + ("tag" in fold)
        ops = x.numel() * per_column + b * folds * THREEFRY_OPS_PER_ELEMENT
        work = {"bound_ms": max(ops / INSTRUCTIONS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
                "bound_by": "operations" if ops / INSTRUCTIONS_PER_S >= nbytes / HBM_BYTES_PER_S
                else "bytes", "flops": float(ops), "bytes": float(nbytes), "peak": "instruction rate",
                "operations_per_column": per_column}
        res = {"case": name, "max_abs_err": 0.0, "library_ms": None, **times, **work,
               "graph_ms": {"ms": device_ms}, "sass_loop": sass[0] if sass else None}
        log(f"  {name}: tokens and noise bit-equal, {same} of {DRAW_REPEATS} repeats "
            f"bit-identical; kernel {res['ms']:.4f} ms ({device_ms:.4f} ms as a CUDA graph), "
            f"plain {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']})")
        out.append(res)
    del logits, masked, pool
    torch.cuda.empty_cache()
    return {"gumbel_argmax": out}


# Phases 15 and 16: the parser. Its seed (page i samples with SEED + i),
# its page cap, and the PDF's page size in points (at the parser's 200 dpi:
# 1,000 x 667 pixels, ~850 vision tokens a page).
PARSE_SEED, PARSE_TOKENS, PARSE_MEDIA = 1234, 64, (360, 240)


def _pdf_bytes(pages) -> bytes:
    """A hand-built PDF (tests/test_ingest.py's writer, one content stream
    a page): Helvetica text and a filled rectangle, PARSE_MEDIA points."""
    import io
    import zlib

    n = len(pages)
    objs = [b"<< /Type /Catalog /Pages 2 0 R >>",
            b"<< /Type /Pages /Kids [" + b" ".join(f"{3 + 2 * i} 0 R".encode() for i in range(n))
            + b"] /Count " + str(n).encode() + b" >>"]
    font = 3 + 2 * n
    for i, content in enumerate(pages):
        stream = zlib.compress(content)
        objs.append(b"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 "
                    + f"{PARSE_MEDIA[0]} {PARSE_MEDIA[1]}".encode()
                    + b"] /Resources << /Font << /F1 " + str(font).encode()
                    + b" 0 R >> >> /Contents " + str(4 + 2 * i).encode() + b" 0 R >>")
        objs.append(b"<< /Length " + str(len(stream)).encode()
                    + b" /Filter /FlateDecode >>\nstream\n" + stream + b"\nendstream")
    objs.append(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
    out = io.BytesIO()
    out.write(b"%PDF-1.4\n")
    offsets = []
    for i, body in enumerate(objs, start=1):
        offsets.append(out.tell())
        out.write(f"{i} 0 obj\n".encode() + body + b"\nendobj\n")
    xref_pos = out.tell()
    out.write(f"xref\n0 {len(objs) + 1}\n".encode())
    out.write(b"0000000000 65535 f \n")
    for off in offsets:
        out.write(f"{off:010d} 00000 n \n".encode())
    out.write(f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\nstartxref\n{xref_pos}\n"
              f"%%EOF".encode())
    return out.getvalue()


def _write_inputs(workdir: str):
    """The parser's inputs: a 2-page PDF and the repo's sample page PNG."""
    pages = [
        b"0.9 0.1 0.1 rg 20 180 100 40 re f\nBT /F1 24 Tf 0 0 0 rg 30 120 Td (Page one) Tj ET\n"
        b"BT /F1 12 Tf 30 90 Td [(kerned) -200 (body text)] TJ ET\n",
        b"0.1 0.1 0.9 rg 200 20 120 60 re f\nBT /F1 20 Tf 0 0 0 rg 30 150 Td (Second page) Tj ET\n"
        b"BT /F1 10 Tf 30 120 Td (A table: 1 2 3) Tj ET\n",
    ]
    pdf = os.path.join(workdir, "doc.pdf")
    with open(pdf, "wb") as f:
        f.write(_pdf_bytes(pages))
    return pdf, os.path.join(REPO, "demo/assets/sample_page.png")


def _artifacts(out_dir: str) -> dict:
    """{relative path: bytes} of a parse's artifacts (.jpg as pixels), then
    the directory is removed: repeated parses write to the same path, which
    the .jsonl manifest records."""
    import shutil

    import numpy as np
    from PIL import Image

    snap = {}
    for root, _, files in os.walk(out_dir):
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, out_dir)
            if name.endswith(".jpg"):
                snap[rel] = np.asarray(Image.open(path)).tobytes()
            else:
                with open(path, "rb") as f:
                    snap[rel] = f.read()
    shutil.rmtree(out_dir)
    return snap


def _page_texts(snap: dict) -> dict:
    """{page artifact stem: its .md text} of a parse (one .md a page)."""
    return {k[:-3]: v for k, v in snap.items() if k.endswith(".md") and not k.endswith("_nohf.md")}


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def local_parse_phase(dev, workdir: str) -> tuple:
    """Phase 15: random flagship weights (full width and depth, from a seed)
    written as a synthetic HF checkpoint (config.json + bf16 safetensors,
    through export_hf_state_dict); the parser's local mode loads it
    (InferenceEngine.from_pretrained on the card, via DOTS_OCR_WEIGHTS) and
    parses the 2-page PDF with a seed, twice: byte-identical artifacts.
    Then the batched PDF path over a continuous engine on the same weights
    (engine=), twice. Returns (checkpoint dir, launches, numbers)."""
    import torch

    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.models.loader import save_checkpoint
    from dots_ocr_tpu_torch.parser import DotsOCRParser

    ckpt = os.path.join(workdir, "ckpt")
    config = DotsOCRConfig.flagship()
    t0 = time.perf_counter()
    params = init_params(config, dev, torch.Generator(device=dev).manual_seed(0))
    save_checkpoint(ckpt, params, config, dtype=torch.bfloat16)
    del params
    _sync(dev)
    size = sum(os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt))
    write_s = time.perf_counter() - t0
    log(f"  synthetic checkpoint: {size / 1e9:.2f} GB (config.json + bf16 safetensors) "
        f"written in {write_s:.1f} s")
    pdf, _ = _write_inputs(workdir)
    os.environ["DOTS_OCR_WEIGHTS"] = ckpt
    reset_counts()
    t0 = time.perf_counter()
    parser = DotsOCRParser(use_local=True, seed=PARSE_SEED, device=str(dev),
                           max_completion_tokens=PARSE_TOKENS, output_dir=workdir)
    _sync(dev)
    load_s = time.perf_counter() - t0
    engine = parser._engine
    log(f"  InferenceEngine.from_pretrained on the card: {load_s:.1f} s, attn_impl "
        f"{engine.attn_impl}, {engine.config.decoder.num_layers} decoder / "
        f"{engine.config.vision.num_layers} vision layers")
    snaps, stats = [], []
    for run in range(2):
        out = os.path.join(workdir, "local")
        t0 = time.perf_counter()
        results = parser.parse_file(pdf, output_dir=out)
        wall = time.perf_counter() - t0
        stats.append((wall, engine.last_stats))
        snaps.append(_artifacts(out))
        log(f"  local parse {run}: {len(results)} pages in {wall:.2f} s; last page "
            f"{engine.last_stats.prompt_tokens} prompt / {engine.last_stats.vision_tokens} "
            f"vision / {engine.last_stats.completion_tokens} completion tokens, "
            f"{engine.last_stats.completion_tokens / engine.last_stats.decode_seconds:.1f} tok/s "
            f"(prefill included)")
    if snaps[0] != snaps[1] or len(_page_texts(snaps[0])) != 2:
        raise AssertionError("phase 15: the two seeded local parses differ "
                             f"({sorted(snaps[0])} / {sorted(snaps[1])})")
    counts = read_counts()
    log(f"  byte-identical artifacts ({len(snaps[0])} files); launches: flash "
        f"{counts['flash_attention']}, draw {counts['gumbel_argmax']}")
    for name in ("flash_attention", "gumbel_argmax"):
        if counts[name] < 1:
            raise AssertionError(f"phase 15: {name} was not launched by the local parse")
    batch_counts = counts
    cont = ContinuousBatchingEngine(
        engine.params, engine.config, dev, tokenizer=engine.tokenizer,
        sched=SchedulerConfig(num_pages=512, page_size=PAGE_SIZE, max_slots=8,
                              max_pages_per_seq=MAX_SEQ_TOKENS // PAGE_SIZE,
                              prefill_chunk_tokens=PREFILL_CHUNK))
    reset_counts()
    batched = []
    for run in range(2):
        out = os.path.join(workdir, "batched")
        t0 = time.perf_counter()
        DotsOCRParser(engine=cont, seed=PARSE_SEED, max_completion_tokens=PARSE_TOKENS,
                      output_dir=workdir).parse_file(pdf, output_dir=out)
        batched.append(_artifacts(out))
        log(f"  batched PDF path (continuous engine, engine=) {run}: "
            f"{time.perf_counter() - t0:.2f} s")
    counts = read_counts()
    if batched[0] != batched[1] or counts["gumbel_argmax"] < 1 or counts["flash_attention"] < 1:
        raise AssertionError(f"phase 15: batched PDF parses differ or launched no kernel "
                             f"({counts})")
    log(f"  batched PDF path: byte-identical artifacts; launches: flash "
        f"{counts['flash_attention']}, kernel 2 {counts['paged_attention_multiquery']}, draw "
        f"{counts['gumbel_argmax']}")
    require_replays(cont, dict.fromkeys(("steps", "graph_captures", "graph_replays"), 0),
                    "batched PDF path")
    del parser, engine, cont
    _sync(dev)
    return ckpt, batch_counts, {"checkpoint_gb": size / 1e9, "write_s": write_s,
                                "load_s": load_s, "parse_s": [w for w, _ in stats],
                                "tok_s": stats[-1][1].completion_tokens
                                / stats[-1][1].decode_seconds}


def server_parse_phase(dev, ckpt: str, workdir: str, env_flags) -> tuple:
    """Phase 16: the port's server with deploy/shipping.env's flags and
    --weights (the phase 15 checkpoint), in this process; the port's CLI
    (python -m dots_ocr_tpu_torch) as subprocesses with --seed: the PDF and
    the PNG parsed serially twice each (identical artifacts), then the PDF
    with its pages co-batched (--num_thread 2; the share of pages whose text
    equals the serial parse is reported, not asserted). Returns (launches,
    numbers)."""
    from dots_ocr_tpu_torch.serve import server as torch_server

    args = torch_server.build_parser().parse_args([*env_flags, "--weights", ckpt,
                                                   "--platform", str(dev)])
    t0 = time.perf_counter()
    engine = torch_server.build_engine(args)
    _sync(dev)
    log(f"  server engine from --weights in {time.perf_counter() - t0:.1f} s ({args.quantize} "
        f"weights, {args.kv_cache_dtype} KV, speculate_k {engine.sched.speculate_k})")
    pdf, png = _write_inputs(workdir)

    def cli(path, tag, threads=1):
        out = os.path.join(workdir, "served")
        engine.recent_timings.clear()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "dots_ocr_tpu_torch", path, "--ip", "127.0.0.1",
             "--port", port, "--seed", str(PARSE_SEED), "--output", out,
             "--max_completion_tokens", str(PARSE_TOKENS), "--num_thread", str(threads)],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"phase 16: the CLI on {path} exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        pages = [t["total_ms"] for t in engine.recent_timings]
        log(f"  CLI {tag}: {wall:.2f} s wall; per page (server, submit to finish) "
            + ", ".join(f"{ms:.0f} ms" for ms in pages))
        return _artifacts(out), pages

    with running_server(engine, "flagship-ckpt") as base:
        port = base.rsplit(":", 1)[1]
        reset_counts()
        graphs_before = graph_counts(engine)
        pdf_a, lat_a = cli(pdf, "cli_pdf_a")
        pdf_b, _ = cli(pdf, "cli_pdf_b")
        png_a, lat_png = cli(png, "cli_png_a")
        png_b, _ = cli(png, "cli_png_b")
        counts = read_counts()
        cobatched, _ = cli(pdf, "cli_pdf_cobatched", threads=2)
        require_replays(engine, graphs_before, "served parse")
    if pdf_a != pdf_b or png_a != png_b or len(_page_texts(pdf_a)) != 2:
        raise AssertionError("phase 16: two serial seeded CLI parses gave different artifacts")
    serial, cob = _page_texts(pdf_a), _page_texts(cobatched)
    share = sum(serial[k] == cob.get(k) for k in serial) / len(serial)
    log(f"  serial parses byte-identical (PDF: {len(pdf_a)} files, PNG: {len(png_a)}); "
        f"co-batched (--num_thread 2): {share:.2f} of pages with the serial text; launches "
        f"(serial runs): flash {counts['flash_attention']}, kernel 2 "
        f"{counts['paged_attention_multiquery']} ({counts['paged_attention_multiquery (nq > 1)']} "
        f"at nq = 3), draw {counts['gumbel_argmax']}")
    for name in ("flash_attention", "paged_attention_multiquery", "gumbel_argmax"):
        if counts[name] < 1:
            raise AssertionError(f"phase 16: {name} was not launched by the served parses")
    del engine
    _sync(dev)
    return counts, {"page_ms": lat_a, "png_ms": lat_png, "cobatched_same_text_share": share}


@contextlib.contextmanager
def running_server(engine, model_name: str = "flagship-random"):
    """The port's OpenAIServer over ``engine`` on 127.0.0.1 in a thread of
    this process; yields its base URL."""
    from aiohttp import web

    from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer

    port = _free_port()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(OpenAIServer(engine, model_name=model_name).build_app())
    ready = threading.Event()

    def serve():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
        ready.set()
        loop.run_forever()

    thread = threading.Thread(target=serve, daemon=True)
    thread.start()
    if not ready.wait(120):
        raise RuntimeError("server did not start")
    try:
        yield f"http://127.0.0.1:{port}"
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)


def engine_metrics(base: str) -> tuple:
    """(HTTP status, {name: value}) of the server's dots_ocr_engine_* lines."""
    status, text = _http(f"{base}/metrics")
    return status, {line.split()[0][len("dots_ocr_engine_"):]: float(line.split()[1])
                    for line in text.splitlines()
                    if line.startswith("dots_ocr_engine_") and len(line.split()) == 2}


def graph_tokens_phase(dev, env_flags) -> tuple:
    """Phase 17, first part: deploy/shipping.env's engine (graphs on, the
    default) warmed by ``--warmup full`` (seconds, graphs, pool bytes),
    and the same engine with ``cuda_graphs=False`` on its weights: the
    three requests greedy for GRAPH_TOKENS tokens, then sampled at
    temperature 1 with GRAPH_SEED, through each. The token ids must be
    identical; every decode and verify chunk of the graphed engine is a
    replay of a graph the warmup captured. Returns (the graphed engine,
    its numbers)."""
    import dataclasses

    import torch

    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine
    from dots_ocr_tpu_torch.serve import server as torch_server
    from dots_ocr_tpu_torch.serve.openai_server import parse_chat_messages

    args = torch_server.build_parser().parse_args(
        ["--random-flagship", "--platform", str(dev), *env_flags])
    graphed = torch_server.build_engine(args)
    warm = torch_server.warm_up(graphed)
    log(f"  --warmup full: {warm['seconds']:.2f} s (one vision and one text request, then "
        f"{warm['thunks']} warmup thunks); {warm['graphs']} graphs captured; graph pool "
        f"{warm['pool_bytes']} bytes ({(warm['pool_bytes'] or 0) / 2**30:.2f} GiB)")
    if warm["graphs"] < 1 or not warm["pool_bytes"]:
        raise AssertionError(f"phase 17: --warmup full captured nothing ({warm})")
    eager = ContinuousBatchingEngine(graphed.params, graphed.config, dev,
                                     tokenizer=graphed.tokenizer,
                                     sched=dataclasses.replace(graphed.sched, cuda_graphs=False))
    # The same warm requests, so that both engines start from one scheduler
    # state (the speculation gate's running average, the key chain).
    torch_server.warm_requests(eager)
    prepared = []
    for name, body in chat_requests():
        prompt, images, system = parse_chat_messages(body["messages"])
        prepared.append((name, graphed.prepare(prompt, images, system_prompt=system)))
    waves = (("greedy", dict(temperature=0.0)),
             ("sampled", dict(temperature=1.0, seed=GRAPH_SEED)))
    ids, walls, launches = {}, {}, {}
    for label, eng in (("graphed", graphed), ("eager", eager)):
        before = graph_counts(eng)
        ids[label], walls[label] = [], []
        reset_counts()
        for wave, options in waves:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rids = [eng.submit("", max_new_tokens=GRAPH_TOKENS, prepared=prep, **options)
                    for _, prep in prepared]
            eng.run()
            torch.cuda.synchronize()
            walls[label].append(time.perf_counter() - t0)
            reqs = [eng.finished_request(r) for r in rids]
            ids[label].append([r.output_ids for r in reqs])
            log(f"  [{label}, {wave}] wall {walls[label][-1]:.2f} s; completion tokens "
                f"{[len(r.output_ids) for r in reqs]} (finish "
                f"{[r.finished_reason for r in reqs]}); engine so far: "
                + ", ".join(f"{k} {eng.metrics[k]}" for k in (
                    "steps", "spec_chunks", "spec_emitted", "spec_auto_disabled",
                    "pipelined_chunks", "chunk_input_rebuilds")))
        launches[label] = read_counts()
        log(f"  [{label}] W8A16 launches {launches[label]['w8a16_matmul']} (decode "
            f"{launches[label]['w8a16_matmul (decode)']}, prefill "
            f"{launches[label]['w8a16_matmul (prefill)']}), draws {launches[label]['gumbel_argmax']}, "
            f"threefry {launches[label]['threefry2x32']}")
        if min(launches[label]["w8a16_matmul"], launches[label]["w8a16_matmul (decode)"],
               launches[label]["gumbel_argmax"]) < 1:
            raise AssertionError(f"phase 17: the {label} engine launched no W8A16 decode kernel "
                                 "or no draw")
        if label == "graphed":
            delta = require_replays(eng, before, "17 graphed")
            if delta["graph_captures"]:
                raise AssertionError(f"phase 17: {delta['graph_captures']} graphs captured "
                                     "after --warmup full")
        elif eng.metrics["graph_replays"] or eng.metrics["graph_captures"]:
            raise AssertionError("phase 17: the eager engine ran graphs")
    for w, (wave, _) in enumerate(waves):
        for (name, _), got, want in zip(prepared, ids["graphed"][w], ids["eager"][w]):
            if got != want:
                at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                          min(len(got), len(want)))
                raise AssertionError(f"phase 17: {wave} {name}: graphed and eager token ids "
                                     f"differ at token {at}: {got[at:at + 4]} vs "
                                     f"{want[at:at + 4]}")
    log(f"  token ids of the graphed and the eager engine identical in both waves "
        f"({sum(len(t) for w in ids['graphed'] for t in w)} tokens)")
    del eager
    release()
    return graphed, {"warmup_full": warm, "walls_s": walls, "launches": launches}


def _chunk_state(engine, dev, spec_k: int):
    """Phase 9's step as one chunk's inputs: 64 slots at 2,048 tokens of
    context, greedy, page tables that cover the chunk's positions (a k = 2
    verify advances a row by up to 3 tokens an iteration), over the
    engine's own pool. Returns (the mode's fixed buffers, their values)."""
    import torch

    s, ctx = MAX_SLOTS, 2048
    dev_in = engine._mode_inputs((spec_k > 0, False, False))
    pages_per_row = -(-(ctx + CHUNK_DEPTH * (spec_k + 1) + 1) // PAGE_SIZE)
    state = {"tokens": (torch.arange(s, device=dev) * 7 + 100) % engine.config.decoder.vocab_size,
             "positions": torch.full((s,), ctx, dtype=torch.int64, device=dev),
             "budgets": torch.full((s,), 10**6, dtype=torch.int64, device=dev),
             "tables": torch.zeros_like(dev_in.tables),
             "active": torch.ones(s, dtype=torch.bool, device=dev),
             "temps": torch.zeros(s, device=dev), "top_ps": torch.ones(s, device=dev),
             "keys": torch.zeros((s, 2), dtype=torch.int64, device=dev)}
    state["tables"][:, :pages_per_row] = (
        1 + torch.arange(s * pages_per_row, device=dev, dtype=torch.int32)).reshape(s, -1)
    if spec_k:  # a zeroed history from the context on: drafts repeat the current token
        state["buf"] = torch.zeros_like(dev_in.buf)
        state["gen_start"] = torch.full((s,), ctx, dtype=torch.int64, device=dev)
    dev_in.any_sampled = dev_in.nucleus = False
    return dev_in, state


PROFILE_TRIES = 2


def profiled_ops(run, tries: int = PROFILE_TRIES) -> tuple:
    """``run()`` (it returns its ms) under torch.profiler ``tries`` times:
    (ms, [(name, count, device ms)] of the device operations with device
    time, the operation count of every try). A graph replays the same
    kernels every time, so a try that shows fewer operations lost profiler
    records (CUPTI dropped 25 of a sampled chunk's 26,499 once): the try
    with the most operations is kept."""
    from torch.profiler import ProfilerActivity, profile

    best, counts = None, []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ms = run()
        ops = [(e.key, e.count, (getattr(e, "self_device_time_total", 0) or 0) / 1e3)
               for e in prof.key_averages()]
        ops = [op for op in ops if op[2] > 0]
        counts.append(sum(op[1] for op in ops))
        if best is None or counts[-1] > sum(op[1] for op in best[1]):
            best = (ms, ops)
    return best[0], best[1], counts


def _time_chunk(engine, dev, dev_in, state, key) -> dict:
    """One chunk of ``key`` over ``dev_in`` (refilled from ``state`` before
    every run), replayed from its graph and run eagerly, in turns: ms a
    step (CUDA events), the host's ms to dispatch the chunk, and each run's
    device busy share (the sum of its kernels' device time over the
    chunk's event time, torch.profiler; None where the profiler shows no
    device time) with the device time of the W8A16 kernels, the
    direct_copy_kernel launches, the draw and the threefry entry."""
    import torch

    program = engine._chunk_program(dev_in, key)

    def restore():
        for name, value in state.items():
            getattr(dev_in, name).copy_(value)

    fns = {"graph": lambda: engine._graphs.run(key, program),
           "eager": lambda: program(CHUNK_DEPTH, True)}
    times = {name: [] for name in fns}
    host = {name: [] for name in fns}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn):
        restore()
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end), host_ms

    for fn in fns.values():
        timed(fn)
    for r in range(REPS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            ms, host_ms = timed(fns[name])
            times[name].append(ms)
            host[name].append(host_ms)
    out = {}
    for name, fn in fns.items():
        # the graphed chunk's counts are checked: profile its replay twice
        ms, ops, tries = profiled_ops(lambda: timed(fn)[0], PROFILE_TRIES if name == "graph" else 1)
        ops = sorted(ops, key=lambda op: -op[2])
        device_ms = sum(op[2] for op in ops)

        def share(word):
            mine = [op for op in ops if word in op[0]]
            return {"launches": sum(op[1] for op in mine), "ms": sum(op[2] for op in mine)}

        busy = {"share": device_ms / ms if device_ms else None, "device_ms": device_ms,
                "chunk_ms": ms, "device_ops": sum(op[1] for op in ops),
                "w8a16": share("w8a16"), "direct_copy_kernel": share("direct_copy_kernel"),
                "draw": share("gumbel_argmax"), "threefry": share("threefry_grid"),
                "top": [(k[:70], count, round(t, 3)) for k, count, t in ops[:10]],
                "profiled_ops_by_try": tries}
        out[name] = {"ms_per_step": statistics.median(times[name]) / CHUNK_DEPTH,
                     "chunk_ms": statistics.median(times[name]),
                     "host_dispatch_ms": statistics.median(host[name]), "busy": busy}
    return out


def chunk_speed_phase(engine, dev) -> dict:
    """Phase 17, second part: phase 9's step (64 slots at 2,048 tokens of
    context, the engine's weights over its own pool) as one decode chunk of
    CHUNK_DEPTH iterations, greedy, and the same slots as one k = 2 verify
    chunk (deploy/shipping.env's step: 192 rows a linear), each replayed
    from the graph the warmup captured and run eagerly, in turns
    (:func:`_time_chunk`). Every int8 linear and the tied lm_head of every
    step must go through the W8A16 kernel in the profiled graphed chunks."""
    import torch

    cfg = engine.config.decoder
    per_step = 7 * cfg.num_layers + 1  # the int8 linears of a step and the lm_head
    out = {}
    for label, spec_k in (("decode", 0), ("verify", 2)):
        dev_in, state = _chunk_state(engine, dev, spec_k)
        key = engine._chunk_key(dev_in, spec_k, CHUNK_DEPTH, False)
        captured = key in engine._graphs
        res = _time_chunk(engine, dev, dev_in, state, key)
        log(f"  one {'decode (nq = 1)' if not spec_k else f'k = {spec_k} verify (nq = {spec_k + 1})'}"
            f" chunk, {MAX_SLOTS} slots x 2048 context, depth {CHUNK_DEPTH}, greedy (the warmup's "
            f"graph: {captured}; median of {REPS}, in turns): "
            + "; ".join(f"{name} {o['ms_per_step']:.3f} ms a step ({o['chunk_ms']:.2f} ms a "
                        f"chunk), host dispatch {o['host_dispatch_ms']:.3f} ms, device busy share "
                        f"{o['busy']['share']} ({o['busy']['device_ops']} device ops, "
                        f"{o['busy']['device_ms']:.2f} of {o['busy']['chunk_ms']:.2f} ms)"
                        for name, o in res.items()))
        graphed = res["graph"]["busy"]
        log(f"  the graphed {label} chunk's device time by operation (name, count, ms): "
            + "; ".join(f"{k} x{count} {t:.2f}" for k, count, t in graphed["top"]))
        log(f"  the graphed {label} chunk ({CHUNK_DEPTH} steps): W8A16 kernels "
            f"x{graphed['w8a16']['launches']} {graphed['w8a16']['ms']:.2f} ms "
            f"({graphed['w8a16']['ms'] / CHUNK_DEPTH:.3f} ms a step, "
            f"{graphed['w8a16']['ms'] / max(1, graphed['w8a16']['launches']) * 1e3:.2f} us a "
            f"launch); direct_copy_kernel x{graphed['direct_copy_kernel']['launches']} "
            f"{graphed['direct_copy_kernel']['ms']:.2f} ms; draw x{graphed['draw']['launches']}, "
            f"threefry x{graphed['threefry']['launches']}; operations profiled by try "
            f"{graphed['profiled_ops_by_try']}")
        if graphed["w8a16"]["launches"] != CHUNK_DEPTH * per_step:
            raise AssertionError(f"phase 17: the profiled {label} chunk ran "
                                 f"{graphed['w8a16']['launches']} W8A16 kernels, not "
                                 f"{CHUNK_DEPTH} x {per_step} (every int8 linear and the "
                                 f"lm_head of every step)")
        out[label] = res
    out.update(graph=out["decode"]["graph"], eager=out["decode"]["eager"])
    # The decode chunk sampled (temperature 1 on every row, no nucleus: the
    # graph the warmup captured for sampled chunks), profiled once: the
    # device operations of a sampled step, the draw and its keys included.
    s = MAX_SLOTS
    dev_in, state = _chunk_state(engine, dev, 0)
    state["temps"] = torch.ones(s, device=dev)
    state["keys"] = (torch.arange(2 * s, device=dev, dtype=torch.int64) * 7919).reshape(s, 2)
    dev_in.any_sampled, dev_in.nucleus = True, False
    skey = engine._chunk_key(dev_in, 0, CHUNK_DEPTH, False)
    sprogram = engine._chunk_program(dev_in, skey)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def sampled_run():
        for name, value in state.items():
            getattr(dev_in, name).copy_(value)
        torch.cuda.synchronize()
        start.record()
        engine._graphs.run(skey, sprogram)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    sampled_run()
    ms, sops, tries = profiled_ops(sampled_run)
    sampled = {"chunk_ms": ms, "device_ops": sum(op[1] for op in sops),
               "profiled_ops_by_try": tries,
               "device_ms": sum(op[2] for op in sops),
               "draw": {"launches": sum(op[1] for op in sops if "gumbel_argmax" in op[0]),
                        "ms": sum(op[2] for op in sops if "gumbel_argmax" in op[0])},
               "threefry": sum(op[1] for op in sops if "threefry_grid" in op[0])}
    log(f"  the decode chunk sampled (temperature 1, no nucleus; graph captured by the warmup: "
        f"{skey in engine._graphs}): {sampled['chunk_ms'] / CHUNK_DEPTH:.3f} ms a step, "
        f"{sampled['device_ops'] / CHUNK_DEPTH:.1f} device operations a step against "
        f"{out['graph']['busy']['device_ops'] / CHUNK_DEPTH:.1f} greedy; draw launches "
        f"{sampled['draw']['launches']} ({sampled['draw']['ms'] / CHUNK_DEPTH:.4f} ms a step), "
        f"threefry launches {sampled['threefry']}; operations profiled by try {tries}")
    if sampled["draw"]["launches"] != CHUNK_DEPTH:
        raise AssertionError(f"phase 17: {sampled['draw']['launches']} draw launches in a "
                             f"sampled chunk of {CHUNK_DEPTH} steps (one a step)")
    engine._dev = None
    out["sampled"] = sampled
    return out


def background_warmup_phase(dev, env_flags) -> dict:
    """Phase 17, third part: deploy/shipping.env's server with ``--warmup
    background`` (its ``--warmup-pages`` default): /health answers while
    warm thunks are pending, a request sent then comes back HTTP 200, and
    ``dots_ocr_engine_warm_pending`` reaches 0."""
    from dots_ocr_tpu_torch.serve import server as torch_server

    args = torch_server.build_parser().parse_args(
        ["--random-flagship", "--platform", str(dev), *env_flags, "--warmup", "background"])
    engine = torch_server.build_engine(args)
    torch_server.start_warmup(engine, args)
    queued = engine.warm_pending
    t0 = time.perf_counter()
    with running_server(engine) as base:
        status, body = _http(f"{base}/health")
        health_s = time.perf_counter() - t0
        pending_at_health = engine_metrics(base)[1]["warm_pending"]
        text = dict(chat_requests()[2][1], temperature=0.0, max_tokens=16)
        status_req, reply = _http(f"{base}/v1/chat/completions", text)
        request_s = time.perf_counter() - t0
        pending_after = engine_metrics(base)[1]["warm_pending"]
        while True:
            metrics = engine_metrics(base)[1]
            if metrics["warm_pending"] == 0 or time.perf_counter() - t0 > 600:
                break
            time.sleep(0.25)
        drained_s = time.perf_counter() - t0
    out = dict(queued=queued, health_status=status, health_s=health_s,
               pending_at_health=pending_at_health, request_status=status_req,
               request_s=request_s, pending_after_request=pending_after,
               drained_s=drained_s, warm_pending=metrics["warm_pending"],
               graph_captures=metrics["graph_captures"],
               graph_replays=metrics["graph_replays"], steps=metrics["steps"])
    log(f"  --warmup background: {queued} thunks queued; /health {status} after "
        f"{health_s:.2f} s with {pending_at_health:g} pending; a text request sent then: HTTP "
        f"{status_req} after {request_s:.2f} s ({json.loads(reply)['usage']['completion_tokens']} "
        f"tokens), {pending_after:g} pending; warm_pending {metrics['warm_pending']:g} after "
        f"{drained_s:.2f} s; graphs captured {metrics['graph_captures']:g}")
    if (status != 200 or pending_at_health < 1 or status_req != 200
            or metrics["warm_pending"] != 0 or metrics["graph_captures"] < 1):
        raise AssertionError(f"phase 17: background warmup {out}")
    del engine
    release()
    return out


def compile_cache_phase(env) -> dict:
    """Phase 17, last part: ``--compile-cache``. A fresh process sets an
    empty cache directory the way the flag does
    (``server.apply_compile_cache``) and loads the kernels: nvcc builds
    them. A second fresh process, with no nvcc on its PATH or under
    CUDA_HOME, loads them from that directory. Also, phase 11's server
    (deploy/shipping.env's COMPILE_CACHE) left the library in its cache."""
    import shutil

    from dots_ocr_tpu_torch.ops import kernel_lib

    code = ("import json, sys, time\n"
            "t0 = time.perf_counter()\n"
            "from dots_ocr_tpu_torch.ops import kernel_lib\n"
            "from dots_ocr_tpu_torch.serve.server import apply_compile_cache\n"
            "t1 = time.perf_counter()\n"
            "apply_compile_cache(sys.argv[1])\n"
            "kernel_lib.load()\n"
            "t2 = time.perf_counter()\n"
            "print(json.dumps({'import_s': t1 - t0, 'load_s': t2 - t1, "
            "'built': kernel_lib.built, 'lib': kernel_lib.lib_path}))\n")
    cache = tempfile.mkdtemp(prefix="dots_kernel_cache_")
    no_nvcc = dict(os.environ, CUDA_HOME=os.path.join(cache, "no-cuda"), PATH=os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))))
    runs = {}
    try:
        for label, env_vars in (("cold", os.environ), ("cached, no nvcc", no_nvcc)):
            proc = subprocess.run([sys.executable, "-c", code, cache], cwd=REPO, env=env_vars,
                                  capture_output=True, text=True, timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"phase 17: the {label} process exited "
                                     f"{proc.returncode}:\n{proc.stderr[-3000:]}")
            runs[label] = json.loads(proc.stdout.strip().splitlines()[-1])
            log(f"  --compile-cache, {label} process: import {runs[label]['import_s']:.2f} s, "
                f"kernels loaded in {runs[label]['load_s']:.2f} s (nvcc ran: "
                f"{runs[label]['built']}) from {runs[label]['lib']}")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    shipped = os.path.join(REPO, env["COMPILE_CACHE"], os.path.basename(kernel_lib.lib_path))
    if (not runs["cold"]["built"] or runs["cached, no nvcc"]["built"]
            or runs["cold"]["lib"] != runs["cached, no nvcc"]["lib"]
            or not os.path.exists(shipped)):
        raise AssertionError(f"phase 17: compile cache {runs}; {shipped} exists: "
                             f"{os.path.exists(shipped)}")
    log(f"  deploy/shipping.env's COMPILE_CACHE holds the library phase 11's server used: "
        f"{shipped}")
    return runs


# Phase 18: training. (a) the trainer's CLI at the flagship's full width and
# depth, text-only synthetic batches (TRAIN_CLI_STEPS steps of
# TRAIN_BATCH x TRAIN_SEQ tokens, --remat); (b) in this process,
# TRAIN_STEPS steps on one fixed batch with TRAIN_VISION_TOKENS image tokens
# a row at lr TRAIN_LR: the loss must fall by TRAIN_LOSS_DROP or more (a
# random model memorizing 4,096 tokens: each Adam step moves an embedding
# row by ~lr per element along its positions' hidden states, ~1 logit a
# step); (c) consistency at full width, TRAIN_CONSISTENCY_LAYERS vision and
# decoder layers, float32 with TF32 off: one train_step on the card against
# the port on the CPU, then a checkpoint round trip on the card whose next
# step must equal, bit for bit, the step taken without it (deterministic
# algorithms on, in a subprocess that sets CUBLAS_WORKSPACE_CONFIG first).
TRAIN_CLI_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 2, 2048
TRAIN_STEPS, TRAIN_VISION_TOKENS, TRAIN_LR, TRAIN_LOSS_DROP = 10, 256, 1e-4, 1.0
TRAIN_CONSISTENCY_LAYERS, TRAIN_CONSISTENCY_SEQ, TRAIN_CONSISTENCY_VISION = 2, 256, 64
# (c)'s tolerances, card float32 against CPU float32 (the same products
# summed in other orders): loss and grad_norm 1e-4 relative. The updated
# parameters: a first Adam step moves an element by lr * g / (|g| + 1e-8),
# about +-lr, so an element whose gradient is rounding noise on either side
# (the key biases, whose exact gradient is 0: the softmax cancels a shift
# shared by all keys) may move by 2 lr apart; every element within
# 2 lr + 1e-5 |p|, and outside the key biases all but TRAIN_OUTLIER_SHARE of
# the elements within 1e-2 lr + 1e-5 |p|.
TRAIN_REL_TOL, TRAIN_OUTLIER_SHARE = 1e-4, 1e-5
TRAIN_STEP_LINE = ("step=(\\d+) loss=(\\S+) acc=(\\S+) grad_norm=(\\S+) ms_per_step=(\\S+) "
                   "tokens_per_s=(\\S+)")


def train_cli_phase(smi: str) -> dict:
    """Phase 18 (a): ``python -m dots_ocr_tpu_torch.train.cli`` at the
    flagship's full width and depth, text-only synthetic batches, remat."""
    import re

    argv = ["--synthetic", str(TRAIN_CLI_STEPS), "--size", "flagship", "--steps",
            str(TRAIN_CLI_STEPS), "--batch-size", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ),
            "--remat", "--device", "cuda", "--log-every", "1"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "dots_ocr_tpu_torch.train.cli", *argv],
                          cwd=REPO, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 18: the trainer's CLI exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    steps = [m.groups() for m in re.finditer(TRAIN_STEP_LINE, proc.stderr)]
    peak = re.search(r"peak_memory_allocated=(\d+)", proc.stderr)
    if [int(s[0]) for s in steps] != list(range(1, TRAIN_CLI_STEPS + 1)) or peak is None:
        raise AssertionError(f"phase 18: the CLI logged steps {[s[0] for s in steps]}:\n"
                             f"{proc.stderr[-3000:]}")
    losses = [float(s[1]) for s in steps]
    norms = [float(s[3]) for s in steps]
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"phase 18: non-finite loss or grad_norm: {losses}, {norms}")
    ms = [float(s[4]) for s in steps[1:]]
    tps = [float(s[5]) for s in steps[1:]]
    out = {"steps": TRAIN_CLI_STEPS, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ, "remat": True,
           "loss": losses, "grad_norm": norms, "ms_per_step": ms,
           "ms_per_step_median": statistics.median(ms), "tokens_per_s_median":
           statistics.median(tps), "peak_memory_bytes": int(peak.group(1)), "wall_s": wall,
           "device": smi}
    log(f"  (a) train.cli --size flagship --batch-size {TRAIN_BATCH} --seq-len {TRAIN_SEQ} "
        f"--remat: losses {['%.4f' % x for x in losses]}, grad_norm "
        f"{['%.3f' % x for x in norms]}; steps 2-{TRAIN_CLI_STEPS}: "
        f"{', '.join('%.1f' % x for x in ms)} ms a step (median {out['ms_per_step_median']:.1f}),"
        f" {out['tokens_per_s_median']:.0f} tokens/s; peak memory "
        f"{out['peak_memory_bytes'] / 2**30:.2f} GiB; {wall:.1f} s wall; {smi}")
    return out


def train_vision_phase(dev, smi: str) -> dict:
    """Phase 18 (b): TRAIN_STEPS train_steps with vision at the flagship's
    full width and depth (bf16, remat) on one fixed batch; every leaf's
    gradient nonzero, the loss falling by TRAIN_LOSS_DROP, no kernel
    launched (training runs the JAX loss's "xla" path)."""
    import torch

    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        loss_fn,
        make_dummy_batch,
        make_optimizer,
        train_step,
        tree_from_items,
        tree_items,
    )

    cfg = DotsOCRConfig.flagship()
    torch.cuda.reset_peak_memory_stats(dev)
    params = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    batch = make_dummy_batch(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                             vision_tokens=TRAIN_VISION_TOKENS, seed=0, device=dev)
    patches = batch.patches.shape[0]
    reset_counts()
    items = tree_items(params)
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    loss, _ = loss_fn(tree_from_items(zip((n for n, _ in items), leaves)), cfg, batch, True)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    zero = [name for (name, _), g in zip(items, grads)
            if g is None or not bool(g.abs().amax() > 0)]
    del loss, grads, leaves
    if zero:
        raise AssertionError(f"phase 18: leaves without a gradient: {zero}")
    optimizer = make_optimizer(learning_rate=TRAIN_LR)
    state = init_train_state(params, optimizer)
    losses, ms = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch, cfg, optimizer, remat=True)
        losses.append(float(metrics["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v for k, v in counts.items() if v}
    if launched:
        raise AssertionError(f"phase 18: kernels launched on the training path: {launched}")
    if not all(math.isfinite(x) for x in losses) or losses[-1] > losses[0] - TRAIN_LOSS_DROP:
        raise AssertionError(f"phase 18: the loss on a fixed batch went {losses} (must fall by "
                             f">= {TRAIN_LOSS_DROP})")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    out = {"steps": TRAIN_STEPS, "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "vision_tokens_per_row": TRAIN_VISION_TOKENS, "patches": patches, "lr": TRAIN_LR,
           "loss": losses, "ms_per_step": ms, "ms_per_step_median": statistics.median(ms[1:]),
           "tokens_per_s_median": tokens / statistics.median(ms[1:]) * 1e3,
           "peak_memory_bytes": peak, "leaves_with_gradient": len(items), "device": smi}
    log(f"  (b) {TRAIN_STEPS} train_steps, flagship bf16 with vision ({TRAIN_BATCH} x "
        f"{TRAIN_SEQ} tokens, {TRAIN_VISION_TOKENS} image tokens a row, {patches} patches "
        f"packed), remat, lr {TRAIN_LR:g}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; all "
        f"{len(items)} leaves with a nonzero gradient; steps 2-{TRAIN_STEPS} median "
        f"{out['ms_per_step_median']:.1f} ms a step, {out['tokens_per_s_median']:.0f} tokens/s;"
        f" peak memory {peak / 2**30:.2f} GiB; kernels launched: none; {smi}")
    del state, params, batch
    release()
    return out


def _copy_tree(tree: dict, device) -> dict:
    return {k: _copy_tree(v, device) if isinstance(v, dict) else v.to(device, copy=True)
            for k, v in tree.items()}


def hold_train_step(metrics, params, ref_metrics, ref_params) -> dict:
    """Phase 18 (c)'s rule for a step against its reference (whole trees,
    any devices): loss and grad_norm within TRAIN_REL_TOL relative; every
    updated element within 2 lr + 1e-5 |p|; outside the key biases at most
    TRAIN_OUTLIER_SHARE of the elements past 1e-2 lr + 1e-5 |p|."""
    from dots_ocr_tpu_torch.train.train_step import tree_items

    rel = {k: abs(float(metrics[k]) - float(ref_metrics[k])) / abs(float(ref_metrics[k]))
           for k in ("loss", "grad_norm")}
    worst, outliers, elements, by_leaf = 0.0, 0, 0, {}
    for (name, a), (_, b) in zip(tree_items(params), tree_items(ref_params)):
        diff = (a.to(b.device) - b).abs()
        slack = 1e-5 * b.abs()
        worst = max(worst, float(((diff - slack) / TRAIN_LR).max()))
        if not name.endswith("attn.bk"):
            count = int((diff > 1e-2 * TRAIN_LR + slack).sum())
            outliers += count
            elements += diff.numel()
            if count:
                by_leaf[name] = count
    ok = (all(v <= TRAIN_REL_TOL for v in rel.values()) and worst <= 2.0
          and outliers <= TRAIN_OUTLIER_SHARE * elements)
    return {"rel_err": rel, "param_worst_over_lr": worst, "param_outliers": outliers,
            "param_elements": elements, "outliers_by_leaf": by_leaf, "ok": ok}


def train_consistency(workdir: str, device: str = "cuda", diagnose: bool = False) -> dict:
    """Phase 18 (c), run in a subprocess with deterministic algorithms on:
    the full-width model cut to TRAIN_CONSISTENCY_LAYERS vision and decoder
    layers, float32, TF32 off; one train_step on the card and on the CPU
    from the same weights and batch; then save_checkpoint on the card,
    restore_checkpoint, and one more step, which must equal bit for bit the
    step taken from the state kept in memory. Returns the numbers.

    Every warning raised (those of ``use_deterministic_algorithms`` among
    them) and the outliers leaf by leaf are returned. ``diagnose``
    (``--train-repeat``) skips the checkpoint and adds a digest of each
    updated leaf on either side (compared across runs by the caller) and a
    second CPU step from the same state, held to the first bit for bit,
    with the CPU's thread count."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = _train_consistency(workdir, device, diagnose)
    out["warnings"] = sorted({f"{w.category.__name__}: {str(w.message)[:300]}"
                              for w in caught})
    return out


def _digests(tree) -> dict:
    """A short sha1 of each leaf's bytes, by dotted name."""
    import hashlib

    import torch

    from dots_ocr_tpu_torch.train.train_step import tree_items

    return {name: hashlib.sha1(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                               .numpy().tobytes()).hexdigest()[:16]
            for name, t in tree_items(tree)}


def _consistency_settings() -> None:
    """Float32 products without TF32, and deterministic implementations
    wherever torch has one (an op without one warns; the bit-equalities
    are the check). cuBLAS's workspace must be set before the process
    starts (CUBLAS_WORKSPACE_CONFIG)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)


def consistency_config():
    """Phase 18 (c)'s model: the flagship's width, TRAIN_CONSISTENCY_LAYERS
    vision and decoder layers, float32."""
    import dataclasses

    from dots_ocr_tpu_torch.models.config import DotsOCRConfig

    flagship = DotsOCRConfig.flagship()
    return flagship.replace(
        vision=dataclasses.replace(flagship.vision, num_layers=TRAIN_CONSISTENCY_LAYERS),
        decoder=dataclasses.replace(flagship.decoder, num_layers=TRAIN_CONSISTENCY_LAYERS),
        dtype="float32")


def _train_consistency(workdir: str, device: str, diagnose: bool) -> dict:
    import torch

    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
    from dots_ocr_tpu_torch.train.train_step import (
        AdamState,
        TrainState,
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        train_step,
        tree_items,
    )

    _consistency_settings()
    dev, cpu = torch.device(device), torch.device("cpu")
    cfg = consistency_config()
    host = init_params(cfg, cpu, torch.Generator(device=cpu).manual_seed(0))
    optimizer = make_optimizer(learning_rate=TRAIN_LR)
    batches = [make_dummy_batch(cfg, batch_size=1, seq_len=TRAIN_CONSISTENCY_SEQ,
                                vision_tokens=TRAIN_CONSISTENCY_VISION, seed=seed, device=d)
               for seed, d in ((0, cpu), (0, dev), (1, dev))]
    t0 = time.perf_counter()
    card, m_card = train_step(init_train_state(_copy_tree(host, dev), optimizer), batches[1],
                              cfg, optimizer)
    _sync(dev)
    card_s = time.perf_counter() - t0
    again = _copy_tree(host, cpu) if diagnose else None
    t0 = time.perf_counter()
    ref, m_ref = train_step(init_train_state(host, optimizer), batches[0], cfg, optimizer)
    cpu_s = time.perf_counter() - t0
    held = hold_train_step(m_card, card.params, m_ref, ref.params)
    out = {"loss": [float(m_card["loss"]), float(m_ref["loss"])],
           "grad_norm": [float(m_card["grad_norm"]), float(m_ref["grad_norm"])],
           "cpu_ok": held.pop("ok"), **held, "card_step_s": card_s, "cpu_step_s": cpu_s}
    if diagnose:
        again_state, m_again = train_step(init_train_state(again, optimizer), batches[0], cfg,
                                          optimizer)
        out["cpu_twice_bit_equal"] = (
            all(torch.equal(m_again[k], m_ref[k]) for k in ("loss", "grad_norm"))
            and all(torch.equal(a, b) for (_, a), (_, b) in
                    zip(tree_items(again_state.params), tree_items(ref.params))))
        out.update(cpu_threads=torch.get_num_threads(), card_digests=_digests(card.params),
                   cpu_digests=_digests(ref.params))
        return out

    ckpt = os.path.join(workdir, "ckpt")
    kept = TrainState(_copy_tree(card.params, dev),
                      AdamState(card.opt_state.count.clone(), _copy_tree(card.opt_state.mu, dev),
                                _copy_tree(card.opt_state.nu, dev)), card.step.clone())
    t0 = time.perf_counter()
    save_checkpoint(ckpt, card, cfg)
    restored, cfg2 = restore_checkpoint(ckpt, dev)
    ckpt_s = time.perf_counter() - t0
    ahead, m_ahead = train_step(kept, batches[2], cfg, optimizer)
    resumed, m_resumed = train_step(restored, batches[2], cfg, optimizer)

    def leaves(state):
        return [t for tree in (state.params, state.opt_state.mu, state.opt_state.nu)
                for _, t in tree_items(tree)]

    out["checkpoint_bit_equal"] = (
        cfg2 == cfg and int(resumed.step) == 2
        and all(torch.equal(m_ahead[k], m_resumed[k]) for k in ("loss", "grad_norm"))
        and all(torch.equal(a, b) for a, b in zip(leaves(ahead), leaves(resumed))))
    out.update(checkpoint_bytes=sum(os.path.getsize(os.path.join(r, f))
                                    for r, _, fs in os.walk(ckpt) for f in fs),
               checkpoint_s=ckpt_s)
    return out


def _train_consistency_run(diagnose: bool = False, env_extra=None) -> dict:
    """:func:`train_consistency` in a subprocess (cuBLAS's deterministic
    workspace is set before it starts; ``env_extra`` adds variables)."""
    with tempfile.TemporaryDirectory(prefix="dots_train_") as workdir:
        code = ("import json, sys; sys.path.insert(0, {repo!r}); import chip_smoke; "
                "print(json.dumps(chip_smoke.train_consistency({workdir!r}, diagnose={diag})))"
                ).format(repo=REPO, workdir=workdir, diag=diagnose)
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", **(env_extra or {}))
        proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"phase 18 (c) exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


TRAIN_CPU_VARIANTS = (
    ("4 threads", {"OMP_NUM_THREADS": "4", "MKL_NUM_THREADS": "4"}),
    ("16 threads", {"OMP_NUM_THREADS": "16", "MKL_NUM_THREADS": "16"}),
    ("AVX2", {"ATEN_CPU_CAPABILITY": "avx2", "MKL_ENABLE_INSTRUCTIONS": "AVX2",
              "DNNL_MAX_CPU_ISA": "AVX2"}),
)


def train_repeat_phase(runs: int, smi: str) -> dict:
    """``--train-repeat N``: phase 18 (c)'s card-against-CPU step N times,
    each in its own subprocess as the phase runs it (no checkpoint), with
    :func:`train_consistency`'s diagnostics. Prints each run, which leaves'
    digests changed between runs on either side, and fails if any run
    fails phase 18 (c)'s rule or two CPU steps in one run differ."""
    runs_out = []
    for i in range(runs):
        out = _train_consistency_run(diagnose=True)
        runs_out.append(out)
        log(f"  run {i + 1}/{runs}: outliers {out['param_outliers']} of {out['param_elements']} "
            f"(tol {TRAIN_OUTLIER_SHARE * out['param_elements']:.0f}), worst "
            f"{out['param_worst_over_lr']:.3f} lr, rel loss {out['rel_err']['loss']:.2e} / "
            f"grad_norm {out['rel_err']['grad_norm']:.2e}, ok {out['cpu_ok']}; by leaf "
            f"{out['outliers_by_leaf']}; CPU twice bit-equal {out['cpu_twice_bit_equal']} at "
            f"{out['cpu_threads']} threads; warnings {out['warnings']}")
    changed = {side: sorted({name for out in runs_out[1:]
                             for name, d in out[f"{side}_digests"].items()
                             if d != runs_out[0][f"{side}_digests"][name]})
               for side in ("card", "cpu")}
    failed = [i + 1 for i, out in enumerate(runs_out)
              if not out["cpu_ok"] or not out["cpu_twice_bit_equal"]]
    log(f"  {runs} runs on {smi}: failed {failed or 'none'}; leaves whose updated values "
        f"changed between runs: card {changed['card'] or 'none'}, CPU {changed['cpu'] or 'none'}")
    summary = {"runs": runs, "failed": failed, "changed_between_runs": changed,
               "outliers": [out["param_outliers"] for out in runs_out],
               "warnings": sorted({w for out in runs_out for w in out["warnings"]}),
               "device": smi, "cpu_variants": {}}
    # The same step with the CPU reference computed another way: its thread
    # count, and the instruction set of its vectorized kernels (as on a host
    # without AVX-512). Reported, not held: they show how far the CPU's own
    # summation order moves the count.
    for label, extra in TRAIN_CPU_VARIANTS:
        out = _train_consistency_run(diagnose=True, env_extra=extra)
        moved = sorted(name for name, d in out["cpu_digests"].items()
                       if d != runs_out[0]["cpu_digests"][name])
        summary["cpu_variants"][label] = {
            "outliers": out["param_outliers"], "ok": out["cpu_ok"],
            "cpu_threads": out["cpu_threads"], "by_leaf": out["outliers_by_leaf"],
            "cpu_leaves_moved": moved,
            "card_same": out["card_digests"] == runs_out[0]["card_digests"]}
        log(f"  CPU variant {label} ({extra}): outliers {out['param_outliers']} (tol "
            f"{TRAIN_OUTLIER_SHARE * out['param_elements']:.0f}), ok {out['cpu_ok']}, "
            f"{out['cpu_threads']} threads; by leaf {out['outliers_by_leaf']}; CPU leaves moved "
            f"from run 1: {moved or 'none'}; card unchanged "
            f"{summary['cpu_variants'][label]['card_same']}")
    if failed:
        raise AssertionError(f"--train-repeat: runs {failed} failed: {summary}")
    return summary


def train_consistency_phase(smi: str) -> dict:
    """Phase 18 (c): :func:`train_consistency` in a subprocess."""
    out = _train_consistency_run()
    out["device"] = smi
    log(f"  (c) full width, {TRAIN_CONSISTENCY_LAYERS} + {TRAIN_CONSISTENCY_LAYERS} layers, "
        f"float32, TF32 off, 1 x {TRAIN_CONSISTENCY_SEQ} tokens, {TRAIN_CONSISTENCY_VISION} "
        f"image tokens: card vs CPU loss {out['loss'][0]:.6f} / {out['loss'][1]:.6f}, "
        f"grad_norm {out['grad_norm'][0]:.6f} / {out['grad_norm'][1]:.6f} (rel "
        f"{out['rel_err']['loss']:.2e} / {out['rel_err']['grad_norm']:.2e}, tol "
        f"{TRAIN_REL_TOL:g}); updated params: worst {out['param_worst_over_lr']:.3f} lr past "
        f"1e-5 |p| (tol 2), {out['param_outliers']} of {out['param_elements']} elements past "
        f"1e-2 lr outside the key biases (tol {TRAIN_OUTLIER_SHARE:g} of them), by leaf "
        f"{out['outliers_by_leaf']}; warnings {out['warnings'] or 'none'}; step "
        f"{out['card_step_s'] * 1e3:.0f} ms card, {out['cpu_step_s']:.1f} s CPU; checkpoint "
        f"({out['checkpoint_bytes'] / 1e9:.2f} GB) saved and restored in "
        f"{out['checkpoint_s']:.1f} s, next step bit-equal to the one without the round trip: "
        f"{out['checkpoint_bit_equal']}; {smi}")
    if not out["cpu_ok"] or not out["checkpoint_bit_equal"]:
        raise AssertionError(f"phase 18 (c) failed: {out}")
    return out


# Phase 19: tensor-parallel serving. NCCL refuses two ranks on one device,
# so on one card the ranks share it over gloo (collectives staged through
# the host, decode chunks eager); NCCL with CUDA graphs runs where there is
# a GPU a rank. TP_TAIL: the teacher-forced positions held to TP = 1; the
# step timing: phase 9's 64-slot x 2,048-token decode step, eager, TP_STEPS
# times after a warm step; TP_REDUCES all-reduces of a row-parallel
# linear's [64, 1,536] float32 product timed alone.
TP_TAIL = 64
TP_STEPS = 10
TP_REDUCES = 50
TP4_LAYERS = 2
# (d): TP = 2 where decode takes kernel 3's route (int8 KV, page % 128 != 0).
TP_V1_PAGE = 64


def _tp_counts() -> dict:
    from dots_ocr_tpu_torch.ops.tp import tp_all_reduce

    return {**read_counts(), "tp_all_reduce": tp_all_reduce.launches}


def _tp_reset() -> None:
    from dots_ocr_tpu_torch.ops.tp import tp_all_reduce

    reset_counts()
    tp_all_reduce.launches = 0


def _tp_engine(task: dict, dev, tp):
    """The rank's engine (``tp`` None: TP = 1): through the server's
    ``build_engine`` with ``task["flags"]``, or, with ``task["layers"]``,
    the flagship cut to that many vision and decoder layers, built as
    ``build_engine`` builds it (seeded random weights, int8 decoder)."""
    import dataclasses

    import torch

    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.models.quantize import quantize_decoder_params
    from dots_ocr_tpu_torch.parallel.sharding import shard_params
    from dots_ocr_tpu_torch.serve import server as torch_server

    world = 1 if tp is None else tp.world
    if not task.get("layers"):
        args = torch_server.build_parser().parse_args([
            "--random-flagship", "--platform", dev.type, *task["flags"],
            "--tensor-parallel-size", str(world), "--tp-backend", task["backend"]])
        return torch_server.build_engine(args, tp)
    cfg = getattr(DotsOCRConfig, task.get("config", "flagship"))()
    n = task["layers"]
    cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, num_layers=n),
                      decoder=dataclasses.replace(cfg.decoder, num_layers=n))
    params = quantize_decoder_params(
        init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0)))
    if tp is not None:
        params, tp.plan = shard_params(params, cfg, tp.rank, tp.world)
    page = task.get("page_size", PAGE_SIZE)
    sched = SchedulerConfig(num_pages=NUM_PAGES * PAGE_SIZE // page, page_size=page,
                            max_slots=MAX_SLOTS, max_pages_per_seq=MAX_SEQ_TOKENS // page,
                            steps_per_sync=16, prefill_chunk_tokens=PREFILL_CHUNK,
                            speculate_k=task.get("speculate_k", 2), kv_cache_dtype="int8")
    return ContinuousBatchingEngine(params, cfg, dev, sched=sched, tp=tp)


def _tp_teacher_forced(engine, dev, tp) -> "object":
    """The last TP_TAIL positions' logits (float32, on the host) of one
    monolithic forward over the page request's prompt (vision spliced)."""
    import torch

    from dots_ocr_tpu_torch.models.decoder import decoder_prefill, logits_from_hidden
    from dots_ocr_tpu_torch.models.rope import vision_rope_device
    from dots_ocr_tpu_torch.models.vlm import vlm_embed
    from PIL import Image

    page = Image.open(os.path.join(REPO, "demo/assets/sample_page.png"))
    packed, ids, put, scatter = _page_inputs(engine, page, dev)
    cfg = engine.model_config
    with torch.no_grad():
        cos, sin = vision_rope_device(put(packed.pos2d), cfg.vision.head_dim,
                                      cfg.vision.rope_theta)
        x = vlm_embed(engine.params, cfg, put(ids), patches=put(packed.patches), rope_cos=cos,
                      rope_sin=sin, segment_ids=put(packed.segment_ids), tp=tp, **scatter)
        t = ids.shape[1]
        pos = torch.arange(t, device=dev)[None]
        hidden, _ = decoder_prefill(engine.params["decoder"], cfg.decoder, x, pos,
                                    torch.tensor([t], device=dev), tp=tp)
        logits = logits_from_hidden(engine.params["decoder"], cfg.decoder, hidden[0, -TP_TAIL:])
    return logits.float().cpu()


def _tp_paged_logits(engine, dev, tp) -> "object":
    """Phase 19 (d)'s decode route: the page request's prompt written into
    the engine's pool by one prefill-extend chunk up to its last three
    tokens, then a k = 2 verify step over those three (nq = 3: the plain
    reference, where kernel 2 does not fit) and a decode step of the last
    one (nq = 1: kernel 3 where kernel 2 does not fit). Their four rows of
    logits (float32, on the host)."""
    import torch

    from dots_ocr_tpu_torch.models.decoder import (
        decoder_decode_step_paged,
        decoder_prefill_extend_batched,
        decoder_spec_step_paged,
        logits_from_hidden,
    )
    from dots_ocr_tpu_torch.models.rope import vision_rope_device
    from dots_ocr_tpu_torch.models.vlm import vlm_embed
    from PIL import Image

    page = Image.open(os.path.join(REPO, "demo/assets/sample_page.png"))
    packed, ids, put, scatter = _page_inputs(engine, page, dev)
    cfg, ps, paged = engine.model_config, engine.sched.page_size, engine.paged
    p = engine.params["decoder"]
    scales = dict(k_scales=paged.k_scale, v_scales=paged.v_scale)
    t = ids.shape[1]
    n = t - 3
    table = (1 + torch.arange(-(-t // ps), device=dev, dtype=torch.int32))[None]

    def slots(pos):
        return table[0, pos // ps].long() * ps + pos % ps

    def lens(x):
        return torch.tensor([x], device=dev, dtype=torch.int32)

    with torch.no_grad():
        cos, sin = vision_rope_device(put(packed.pos2d), cfg.vision.head_dim,
                                      cfg.vision.rope_theta)
        x = vlm_embed(engine.params, cfg, put(ids), patches=put(packed.patches), rope_cos=cos,
                      rope_sin=sin, segment_ids=put(packed.segment_ids), tp=tp, **scatter)
        pos = torch.arange(t, device=dev)
        decoder_prefill_extend_batched(p, cfg.decoder, x[:, :n], pos[:n], lens(n), paged.k,
                                       paged.v, table, slots(pos[:n])[None], ps,
                                       -(-n // ps) * ps, 0, tp=tp, **scales)
        verify = decoder_spec_step_paged(p, cfg.decoder, x[:, n:], pos[None, n:], paged.k,
                                         paged.v, table, lens(n + 1), slots(pos[n:])[None], ps,
                                         tp=tp, **scales)[0]
        decode = decoder_decode_step_paged(p, cfg.decoder, x[:, -1], pos[-1:], paged.k, paged.v,
                                           table, lens(t), slots(pos[-1:]), ps, tp=tp, **scales)
        logits = logits_from_hidden(p, cfg.decoder, torch.cat([verify, decode]))
    return logits.float().cpu()


def _tp_step_ms(engine, dev, tp) -> dict:
    """Phase 9's decode step (64 slots x 2,048 tokens of context) on the
    engine's pool and weights (the rank's shard), eager: ms a step (median
    of TP_STEPS), the all-reduces a step, and one all-reduce of the step's
    [64, 1,536] bf16 timed alone (ms, median of TP_REDUCES host-timed calls:
    under gloo a call returns when the sum is back on the card)."""
    import torch

    from dots_ocr_tpu_torch.models.decoder import (
        decoder_decode_step_paged,
        embed_tokens,
        logits_from_hidden,
    )
    from dots_ocr_tpu_torch.ops.tp import tp_all_reduce

    cfg, ctx = engine.model_config, 2048
    pages_per_row = ctx // PAGE_SIZE + 1
    table = (1 + torch.arange(MAX_SLOTS * pages_per_row, device=dev, dtype=torch.int32)
             ).reshape(MAX_SLOTS, pages_per_row)
    pos = torch.full((MAX_SLOTS,), ctx, dtype=torch.int64, device=dev)
    slots = table[:, ctx // PAGE_SIZE].long() * PAGE_SIZE + ctx % PAGE_SIZE
    lens = (pos + 1).to(torch.int32)
    tokens = (torch.arange(MAX_SLOTS, device=dev) * 7 + 100) % cfg.decoder.vocab_size
    p, paged = engine.params["decoder"], engine.paged

    def step():
        with torch.no_grad():
            h = decoder_decode_step_paged(p, cfg.decoder, embed_tokens(p, tokens), pos, paged.k,
                                          paged.v, table, lens, slots, PAGE_SIZE,
                                          k_scales=paged.k_scale, v_scales=paged.v_scale, tp=tp)
            return logits_from_hidden(p, cfg.decoder, h)

    step()
    torch.cuda.synchronize()
    before = tp_all_reduce.launches
    times = [cuda_ms(step) for _ in range(TP_STEPS)]
    out = {"step_ms": statistics.median(times),
           "reduces_a_step": (tp_all_reduce.launches - before) / TP_STEPS}
    if tp is not None:
        # a row-parallel linear's float32 product at a decode step's rows
        x = torch.randn(MAX_SLOTS, cfg.decoder.hidden_size, device=dev)
        tp_all_reduce(x, tp)
        torch.cuda.synchronize()
        ms = []
        for _ in range(TP_REDUCES):
            t0 = time.perf_counter()
            tp_all_reduce(x, tp)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["all_reduce_ms"] = statistics.median(ms)
    return out


def _pool_bytes(engine) -> int:
    tensors = engine.paged.k + engine.paged.v + (
        (engine.paged.k_scale + engine.paged.v_scale) if engine.paged.quantized else [])
    return sum(t.numel() * t.element_size() for t in tensors)


def tp_rank_main(rank: int, world: int, workdir: str, task: dict) -> None:
    """One rank of phase 19 (a spawned process): join the group, build the
    rank's engine, serve (rank 0 over HTTP: task["waves"] of the three
    requests; the others through ``follow``), then the teacher-forced
    logits and the timed step in lockstep. Writes its numbers to
    ``workdir/rank{rank}.json`` (rank 0's logits to ``logits.pt``), or the
    traceback."""
    import traceback

    sys.path.insert(0, REPO)
    out = {"rank": rank}
    try:
        import torch

        from dots_ocr_tpu_torch.models.quantize import param_bytes
        from dots_ocr_tpu_torch.parallel.distributed import destroy, initialize_distributed
        from dots_ocr_tpu_torch.serve.async_engine import follow

        dev = torch.device(task.get("device", "cuda"), rank if task["backend"] == "nccl" else 0)
        tp = initialize_distributed(task["backend"], rank, world, f"file://{workdir}/store",
                                    device=dev, timeout_s=600)
        t0 = time.perf_counter()
        engine = _tp_engine(task, dev, tp)
        guard_off(engine)
        torch.cuda.synchronize()
        out.update(build_s=time.perf_counter() - t0, param_bytes=param_bytes(engine.params),
                   pool_bytes=_pool_bytes(engine), kv_width=engine.paged.k[0].shape[0],
                   kv_replication=engine._kv_rep, decoder_pad=tp.plan.decoder_pad,
                   shard=dict(heads=engine.model_config.decoder.num_heads,
                              kv_heads=engine.model_config.decoder.num_kv_heads,
                              intermediate=engine.model_config.decoder.intermediate_size,
                              vision_heads=engine.model_config.vision.num_heads),
                   cuda_graphs=engine.sched.cuda_graphs,
                   row_parallel=sorted(tp.plan.row_parallel))
        _tp_reset()
        t0 = time.perf_counter()
        if rank == 0:
            with running_server(engine) as base:
                replies = []
                for temperature, max_tokens in task["waves"]:
                    batch = [(name, {**body, "temperature": temperature,
                                     "max_tokens": max_tokens})
                             for name, body in chat_requests()]

                    def post(item):
                        name, body = item
                        t = time.perf_counter()
                        status, text = _http(f"{base}/v1/chat/completions", body)
                        return name, status, json.loads(text), time.perf_counter() - t

                    answers = _serve_wave(post, batch, f"TP={world} rank 0", temperature)
                    replies.append({name: text for name, (text, _) in answers.items()})
                out["replies"] = replies
                out["metrics"] = engine_metrics(base)[1]
        else:
            follow(engine)
        torch.cuda.synchronize()
        out.update(serve_s=time.perf_counter() - t0, launches=_tp_counts(),
                   engine_metrics={k: v for k, v in engine.metrics.items()
                                   if not k.startswith("t_")})
        logits = _tp_teacher_forced(engine, dev, tp)
        if rank == 0:
            torch.save(logits, os.path.join(workdir, "logits.pt"))
        if task.get("page_size"):
            logits = _tp_paged_logits(engine, dev, tp)
            if rank == 0:
                torch.save(logits, os.path.join(workdir, "paged_logits.pt"))
        out["step"] = _tp_step_ms(engine, dev, tp)
        destroy(tp)
    except BaseException:  # noqa: BLE001 - the parent reports it
        out["error"] = traceback.format_exc()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _tp_reference(task: dict, dev) -> tuple:
    """TP = 1 on the same seeded weights: the teacher-forced logits and the
    eager step."""
    from dots_ocr_tpu_torch.models.quantize import param_bytes

    engine = _tp_engine({**task, "backend": "gloo"}, dev, None)
    logits = _tp_teacher_forced(engine, dev, None)
    out = {"param_bytes": param_bytes(engine.params), "pool_bytes": _pool_bytes(engine),
           "step": _tp_step_ms(engine, dev, None)}
    if task.get("page_size"):
        out["paged_logits"] = _tp_paged_logits(engine, dev, None)
    del engine
    release()
    return logits, out


def _tp_run(world: int, task: dict, label: str, timeout_s: float = 900.0,
            target=None) -> list:
    """Spawn the ``world`` ranks of ``task`` (each runs ``target``, by
    default :func:`tp_rank_main`) and return their numbers."""
    import multiprocessing

    with tempfile.TemporaryDirectory(prefix="dots_tp_") as workdir:
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=target or tp_rank_main, args=(rank, world, workdir, task))
                 for rank in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.perf_counter() + timeout_s
        for proc in procs:
            proc.join(max(1.0, deadline - time.perf_counter()))
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(30)
        log(f"  [{label}] rank exit codes: {[proc.exitcode for proc in procs]}")
        ranks = []
        for rank in range(world):
            path = os.path.join(workdir, f"rank{rank}.json")
            if not os.path.exists(path):
                raise AssertionError(f"{label}: rank {rank} wrote nothing "
                                     f"(exit code {procs[rank].exitcode})")
            with open(path) as f:
                res = json.load(f)
            if "error" in res:
                raise AssertionError(f"{label}: rank {rank} failed:\n{res['error']}")
            ranks.append(res)
        import torch

        if target is not None:
            return ranks
        ranks[0]["logits"] = torch.load(os.path.join(workdir, "logits.pt"))
        if task.get("page_size"):
            ranks[0]["paged_logits"] = torch.load(os.path.join(workdir, "paged_logits.pt"))
    return ranks


def _tp_check(label: str, ranks: list, ref_logits, ref: dict, required, smi: str) -> dict:
    """Every rank launched ``required``, the counters agree, the logits
    are within LOGIT_TOL of TP = 1; logs each rank's bytes and step."""
    logits = ranks[0].pop("logits")
    diff, std = (logits - ref_logits).abs(), float(ref_logits.std())
    ratio = float(diff.max()) / std
    same = bool((logits.argmax(-1) == ref_logits.argmax(-1)).all())
    log(f"  [{label}] teacher-forced logits (page request, last {TP_TAIL} positions) vs TP = 1: "
        f"max|diff| / std = {ratio:.4f} (tol {LOGIT_TOL}), mean "
        f"{float(diff.mean()) / std:.4f}, same argmax: {same}")
    if not ratio <= LOGIT_TOL:
        raise AssertionError(f"{label}: logits differ from TP = 1 by {ratio} std")
    paged, ref_paged = ranks[0].pop("paged_logits", None), ref.pop("paged_logits", None)
    if paged is not None:
        paged_ratio = float((paged - ref_paged).abs().max()) / float(ref_paged.std())
        log(f"  [{label}] the page request's last 3 tokens as a k = 2 verify step and its last "
            f"as a decode step, through the rank's paged route: logits vs TP = 1 max|diff| / "
            f"std = {paged_ratio:.4f} (tol {LOGIT_TOL})")
        if not paged_ratio <= LOGIT_TOL:
            raise AssertionError(f"{label}: paged logits differ from TP = 1 by {paged_ratio} std")
    for res in ranks:
        r = res["rank"]
        log(f"  [{label}] rank {r}: shard {res['shard']}, KV pool width {res['kv_width']} "
            f"(replication {res['kv_replication']}), gate/up pad {res['decoder_pad']}, "
            f"parameters {res['param_bytes'] / 1e9:.3f} GB (TP = 1: "
            f"{ref['param_bytes'] / 1e9:.3f}), pool {res['pool_bytes'] / 1e9:.3f} GB (TP = 1: "
            f"{ref['pool_bytes'] / 1e9:.3f}), CUDA graphs {res['cuda_graphs']}; built in "
            f"{res['build_s']:.1f} s, served in {res['serve_s']:.1f} s")
        log(f"  [{label}] rank {r} launches while serving: {res['launches']}")
        missing = [name for name in required if res["launches"].get(name, 0) < 1]
        if missing:
            raise AssertionError(f"{label}: rank {r} launched no {missing}")
        step = res["step"]
        log(f"  [{label}] rank {r}: phase 9's step eager {step['step_ms']:.3f} ms (TP = 1 eager: "
            f"{ref['step']['step_ms']:.3f} ms), {step['reduces_a_step']:g} all-reduces a step, "
            f"one all-reduce of [64, 1536] float32 {step['all_reduce_ms']:.3f} ms on {smi}")
    counters = [res["engine_metrics"] for res in ranks]
    if any(c != counters[0] for c in counters):
        raise AssertionError(f"{label}: the ranks' engine counters differ: {counters}")
    launches = [res["launches"] for res in ranks]
    if any(c != launches[0] for c in launches):
        raise AssertionError(f"{label}: the ranks' launch counts differ: {launches}")
    log(f"  [{label}] engine counters, equal on every rank: {counters[0]}")
    out = {"ranks": ranks, "reference": ref, "logit_ratio": ratio, "same_argmax": same}
    if paged is not None:
        out["paged_logit_ratio"] = paged_ratio
    return out


def tp_phase(dev, env_flags, smi: str) -> dict:
    """Phase 19: (a) TP = 2 over gloo on this card, the flagship at full
    width and depth with deploy/shipping.env's serve flags (no warmup:
    under gloo nothing is captured), phase 11's waves; (b) TP = 4 over
    gloo, the flagship's width at TP4_LAYERS + TP4_LAYERS layers, int8
    weights and KV, k = 2: each KV head on two ranks, gate/up padded to
    2,304; (d) TP = 2 at TP4_LAYERS + TP4_LAYERS layers where decode takes
    kernel 3's route (int8 KV at page TP_V1_PAGE); (c) NCCL with CUDA graphs
    at TP = 2 where the host has 2 GPUs."""
    import torch

    release()  # the ranks share this card with this process
    flags = [f for i, f in enumerate(env_flags)
             if f not in ("--warmup", "--compile-cache")
             and env_flags[i - 1] not in ("--warmup", "--compile-cache")]
    numbers = {}
    tp2 = {"backend": "gloo", "flags": flags, "waves": SHIPPING_WAVES}
    ref2 = _tp_reference(tp2, dev)
    log(f"  [TP=2] TP = 1 reference: parameters {ref2[1]['param_bytes'] / 1e9:.3f} GB, pool "
        f"{ref2[1]['pool_bytes'] / 1e9:.3f} GB, phase 9's step eager "
        f"{ref2[1]['step']['step_ms']:.3f} ms")
    ranks = _tp_run(2, tp2, "TP=2")
    numbers["tp2"] = _tp_check("TP=2", ranks, *ref2, (
        "flash_attention", "flash_attention (q_offset > 0)", "paged_attention_multiquery",
        "paged_attention_multiquery (nq > 1)", "w8a16_matmul", "gumbel_argmax",
        "tp_all_reduce"), smi)
    launches = ranks[0]["launches"]
    decode = launches["paged_attention_multiquery"] - launches["paged_attention_multiquery (nq > 1)"]
    if decode < 1:
        raise AssertionError("TP=2: kernel 2 never ran at nq = 1")
    metrics = ranks[0]["metrics"]
    if metrics.get("prefill_chunks", 0) < 2 or metrics.get("spec_chunks", 0) < 1:
        raise AssertionError(f"TP=2: prefill_chunks / spec_chunks too few: {metrics}")

    tp4 = {"backend": "gloo", "layers": TP4_LAYERS, "waves": ((0.0, 32),)}
    ref_logits, ref = _tp_reference(tp4, dev)
    ranks = _tp_run(4, tp4, "TP=4")
    numbers["tp4"] = _tp_check("TP=4", ranks, ref_logits, ref, (
        "flash_attention", "paged_attention_multiquery_int8",
        "paged_attention_multiquery_int8 (nq > 1)", "w8a16_matmul", "tp_all_reduce"), smi)
    if any(r["kv_replication"] != 2 or r["kv_width"] != 1 or r["decoder_pad"] != 64
           for r in ranks):
        raise AssertionError("TP=4: KV replication 2, pool width 1 and the gate/up pad of 64 "
                             f"expected: {[(r['kv_replication'], r['kv_width'], r['decoder_pad']) for r in ranks]}")

    # (d) kernel 3's route: int8 KV at page 64, no speculation, so that
    # every served decode step is nq = 1 (kernel 3 at one KV head a rank);
    # the paged logits add a k = 2 verify (the plain reference)
    v1 = {"backend": "gloo", "layers": TP4_LAYERS, "page_size": TP_V1_PAGE, "speculate_k": 0,
          "waves": ((0.0, 32),)}
    ref_logits, ref = _tp_reference(v1, dev)
    ranks = _tp_run(2, v1, "TP=2 page 64")
    numbers["tp2_page64"] = _tp_check("TP=2 page 64", ranks, ref_logits, ref, (
        "flash_attention", "paged_attention_v1_int8", "w8a16_matmul", "tp_all_reduce"), smi)
    kernel2 = [r["launches"]["paged_attention_multiquery_int8"] for r in ranks]
    if any(kernel2) or any(r["kv_width"] != 1 for r in ranks):
        raise AssertionError(f"TP=2 page 64: kernel 2 launched {kernel2} times, or a pool is not "
                             f"one KV head: {[r['kv_width'] for r in ranks]}")
    return _tp_nccl(dev, flags, ref2, smi, numbers)


def _tp_nccl(dev, flags, ref2, smi: str, numbers: dict) -> dict:
    """Phase 19 (c): TP = 2 over NCCL, a GPU a rank, decode chunks as CUDA
    graphs (every chunk a replay), held to the TP = 1 reference ``ref2``."""
    import torch

    if torch.cuda.device_count() >= 2:
        nccl = {"backend": "nccl", "flags": flags, "waves": ((0.0, 32),)}
        ranks = _tp_run(2, nccl, "TP=2 nccl")
        numbers["nccl"] = _tp_check("TP=2 nccl", ranks, *ref2, (
            "flash_attention", "paged_attention_multiquery", "w8a16_matmul", "tp_all_reduce"),
            smi)
        for res in ranks:
            m = res["engine_metrics"]
            if not res["cuda_graphs"] or m["graph_replays"] < m["steps"] or m["steps"] < 1:
                raise AssertionError(f"TP=2 nccl: every chunk a graph replay expected ({m})")
        log(f"  [TP=2 nccl] every decode chunk a CUDA graph replay: "
            f"{ranks[0]['engine_metrics']['graph_replays']} replays, "
            f"{ranks[0]['engine_metrics']['graph_captures']} captures")
    else:
        numbers["nccl"] = (f"not run: {torch.cuda.device_count()} CUDA device(s); NCCL refuses "
                           "two ranks on one device, so TP with CUDA graphs needs 2 GPUs")
        log(f"  [TP=2 nccl] {numbers['nccl']}")
    return numbers


# Phase 20: tensor- and data-parallel training, the ranks sharing this card
# over gloo (NCCL refuses two ranks on one device). (a) the flagship at full
# width and depth, bf16, remat, text-only TRAIN_BATCH x TRAIN_SEQ batches,
# TRAIN_TP_STEPS steps at TP = 2 (lr TRAIN_LR); step 1's loss and grad_norm
# held to the card's TP = 1 step on the same weights and batch within
# TRAIN_TP_LOSS_TOL / TRAIN_TP_NORM_TOL relative, tolerances set before the
# first run: every row-parallel product is summed over the ranks in float32
# and then rounded to bf16, so some activations land one bf16 ulp apart
# (2^-8), which 28 layers carry into the loss (a mean over 4,096 tokens:
# ~1e-4) and more into the bf16 gradients (~1e-3 in their norm). (b) phase
# 18 (c)'s model with TRAIN_CONSISTENCY_VISION image tokens in each of
# TRAIN_TP_ROWS rows at each of TRAIN_TP_LAYOUTS (data, model), four ranks
# at most on the card, held to the card's one-process step under phase 18
# (c)'s rule and constants (hold_train_step); the TP = 2 checkpoint,
# restored in one process, equal to the gathered state bit for bit. (c) TP =
# 2 over NCCL, a GPU a rank, where the host has 2 GPUs.
TRAIN_TP_STEPS = 3
TRAIN_TP_LOSS_TOL, TRAIN_TP_NORM_TOL = 1e-3, 1e-2
TRAIN_TP_ROWS = 2
TRAIN_TP_LAYOUTS = (("TP=2", 1, 2), ("TP=4", 1, 4), ("model 2 x data 2", 2, 2))
TRAIN_TP_REDUCES = 10


def train_tp_rank_main(rank: int, world: int, workdir: str, task: dict) -> None:
    """One process of phase 20 (spawned): for each of task["layouts"]
    (label, data, model) whose world holds ``rank``, join that layout's
    groups (a store of its own), run task["kind"] ("flagship": (a);
    "consistency": (b)) and leave; a process outside a layout skips it, so
    one spawn serves every layout. Writes ``workdir/rank{rank}.json`` with
    the numbers by layout (or the traceback)."""
    import traceback

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    sys.path.insert(0, REPO)
    out = {"rank": rank, "layouts": {}}
    try:
        import torch

        from dots_ocr_tpu_torch.parallel.distributed import destroy, initialize_distributed

        dev = torch.device(task.get("device", "cuda"), rank if task["backend"] == "nccl" else 0)
        run = _train_tp_flagship if task["kind"] == "flagship" else _train_tp_consistency
        cache = {}
        for i, (label, data, model) in enumerate(task["layouts"]):
            if rank >= data * model:
                continue
            tp = initialize_distributed(task["backend"], rank, data * model,
                                        f"file://{workdir}/store{i}", device=dev, timeout_s=900,
                                        model_parallel=model)
            out["layouts"][label] = run(tp, dev, {**task, "checkpoint": label == "TP=2"},
                                        os.path.join(workdir, str(i)), cache)
            destroy(tp)
            torch.cuda.empty_cache()
    except BaseException:  # noqa: BLE001 - the parent reports it
        out["error"] = traceback.format_exc()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _train_tp_flagship(tp, dev, task: dict, workdir: str, cache: dict) -> dict:
    """(a) on one rank: the seeded flagship init, the rank's shard, then
    TRAIN_TP_STEPS steps; each step's metrics, ms and all-reduces, the
    peak memory from the first step on, and one all-reduce of a
    row-parallel product ([TRAIN_BATCH x TRAIN_SEQ, hidden] float32)."""
    import torch

    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.models.quantize import param_bytes
    from dots_ocr_tpu_torch.ops.tp import train_all_reduce
    from dots_ocr_tpu_torch.parallel.sharding import shard_batch
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        shard_for_training,
        train_step,
    )

    cfg = DotsOCRConfig.flagship()
    params = shard_for_training(init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0)),
                                cfg, tp)
    optimizer = make_optimizer(learning_rate=TRAIN_LR)
    state = init_train_state(params, optimizer)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = []
    for step in range(1, TRAIN_TP_STEPS + 1):
        batch = shard_batch(make_dummy_batch(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                             seed=step, device=dev), tp.data, tp.data_rank)
        torch.cuda.synchronize(dev)
        before, t0 = train_all_reduce.launches, time.perf_counter()
        state, metrics = train_step(state, batch, cfg, optimizer, remat=True, tp=tp)
        values = {k: float(v) for k, v in metrics.items()}  # waits for the step
        steps.append({**values, "ms": (time.perf_counter() - t0) * 1e3,
                      "all_reduces": train_all_reduce.launches - before})
    peak = torch.cuda.max_memory_allocated(dev)
    shard_bytes = param_bytes(state.params)
    del state
    torch.cuda.empty_cache()
    x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, cfg.decoder.hidden_size, device=dev)
    train_all_reduce(x, tp)
    torch.cuda.synchronize(dev)
    ms = []
    for _ in range(TRAIN_TP_REDUCES):
        t0 = time.perf_counter()
        train_all_reduce(x, tp)
        torch.cuda.synchronize(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"steps": steps, "peak_memory_bytes": peak, "param_bytes": shard_bytes,
            "all_reduce_ms": statistics.median(ms), "all_reduce_bytes": x.numel() * 4}


def _train_tp_consistency(tp, dev, task: dict, workdir: str, cache: dict) -> dict:
    """(b) on one rank: phase 18 (c)'s model and settings, one step of the
    rank's shard on its rows of TRAIN_TP_ROWS rows; rank 0 gathers the
    whole state, takes the card's one-process step from the same weights
    and batch (once a process: ``cache`` keeps it for the next layout), and
    holds the two to phase 18 (c)'s rule; with task["checkpoint"] the
    layout's checkpoint, restored in one process, against the gathered
    state bit for bit."""
    import torch

    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.ops.tp import train_all_reduce
    from dots_ocr_tpu_torch.parallel.sharding import shard_batch
    from dots_ocr_tpu_torch.train.checkpoint import (
        gather_train_state,
        restore_checkpoint,
        save_checkpoint,
    )
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        shard_for_training,
        train_step,
        tree_items,
    )

    _consistency_settings()
    cpu, cfg = torch.device("cpu"), consistency_config()
    init = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0))  # every rank's
    optimizer = make_optimizer(learning_rate=TRAIN_LR)
    batch = make_dummy_batch(cfg, batch_size=TRAIN_TP_ROWS, seq_len=TRAIN_CONSISTENCY_SEQ,
                             vision_tokens=TRAIN_CONSISTENCY_VISION, seed=0, device=dev)
    state = init_train_state(shard_for_training(_copy_tree(init, dev), cfg, tp), optimizer)
    torch.cuda.synchronize(dev)
    before, t0 = train_all_reduce.launches, time.perf_counter()
    state, metrics = train_step(state, shard_batch(batch, tp.data, tp.data_rank), cfg, optimizer,
                                tp=tp)
    metrics = {k: float(v) for k, v in metrics.items()}
    out = {"metrics": metrics, "step_ms": (time.perf_counter() - t0) * 1e3,
           "all_reduces": train_all_reduce.launches - before}
    whole = gather_train_state(state, cfg, tp)
    ckpt = os.path.join(workdir, "ckpt")
    if task.get("checkpoint"):
        save_checkpoint(ckpt, state, cfg, tp=tp)
    del state
    if whole is None:
        return out
    torch.cuda.empty_cache()
    if "reference" not in cache:
        ref, m_ref = train_step(init_train_state(init, optimizer), batch, cfg, optimizer)
        cache["reference"] = ({k: float(v) for k, v in m_ref.items()}, ref.params)
    out["reference"], ref_params = cache["reference"]
    out.update(hold_train_step(metrics, whole.params, out["reference"], ref_params))
    if task.get("checkpoint"):
        restored, cfg2 = restore_checkpoint(ckpt, cpu)
        pairs = [(whole.params, restored.params), (whole.opt_state.mu, restored.opt_state.mu),
                 (whole.opt_state.nu, restored.opt_state.nu)]
        out["checkpoint_bit_equal"] = (
            cfg2 == cfg and int(restored.step) == int(whole.step) == 1
            and int(restored.opt_state.count) == 1
            and all(torch.equal(a, b) and a.dtype == b.dtype for x, y in pairs
                    for (_, a), (_, b) in zip(tree_items(x), tree_items(y))))
    return out


def _train_tp1_reference(dev) -> dict:
    """(a)'s TP = 1 step 1 on the card: the same seeded flagship and batch."""
    import torch

    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.train.train_step import (
        init_train_state,
        make_dummy_batch,
        make_optimizer,
        train_step,
    )

    cfg = DotsOCRConfig.flagship()
    optimizer = make_optimizer(learning_rate=TRAIN_LR)
    state = init_train_state(init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0)),
                             optimizer)
    batch = make_dummy_batch(cfg, batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ, seed=1, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    state, metrics = train_step(state, batch, cfg, optimizer, remat=True)
    out = {k: float(v) for k, v in metrics.items()}
    out["ms"] = (time.perf_counter() - t0) * 1e3
    del state, batch
    release()
    return out


def train_tp_phase(dev, smi: str) -> dict:
    """Phase 20 (module notes and the constants above)."""
    import torch

    release()  # the ranks share this card with this process
    numbers = {}
    ref = _train_tp1_reference(dev)
    log(f"  (a) TP = 1 reference step 1: loss {ref['loss']:.6f}, grad_norm "
        f"{ref['grad_norm']:.6f}, {ref['ms']:.1f} ms (a first step)")
    ranks = [r["layouts"]["TP=2"] | {"rank": r["rank"]} for r in _tp_run(
        2, {"kind": "flagship", "backend": "gloo", "layouts": (("TP=2", 1, 2),)}, "TP=2 training",
        target=train_tp_rank_main)]
    steps = ranks[0]["steps"]
    if any(r["steps"] != steps for r in ranks[1:]):
        # the metrics and the all-reduce counts are the same on every rank;
        # only the host's step times may differ
        strip = [[{k: v for k, v in st.items() if k != "ms"} for st in r["steps"]] for r in ranks]
        if any(x != strip[0] for x in strip[1:]):
            raise AssertionError(f"phase 20 (a): the ranks disagree: {strip}")
    rel = {k: abs(steps[0][k] - ref[k]) / abs(ref[k]) for k in ("loss", "grad_norm")}
    ms = [st["ms"] for st in steps[1:]]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    numbers["a"] = {"ranks": ranks, "reference": ref, "rel_err": rel,
                    "ms_per_step_median": statistics.median(ms),
                    "tokens_per_s": tokens / statistics.median(ms) * 1e3, "device": smi}
    for res in ranks:
        log(f"  (a) rank {res['rank']}: parameters {res['param_bytes'] / 1e9:.3f} GB, peak memory "
            f"{res['peak_memory_bytes'] / 2**30:.2f} GiB, one all-reduce of "
            f"{res['all_reduce_bytes'] / 1e6:.1f} MB float32 {res['all_reduce_ms']:.2f} ms")
    log(f"  (a) TP = 2 over gloo, flagship bf16, remat, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses "
        f"{['%.6f' % st['loss'] for st in steps]}, grad_norm "
        f"{['%.6f' % st['grad_norm'] for st in steps]}; step 1 vs TP = 1: rel loss "
        f"{rel['loss']:.2e} (tol {TRAIN_TP_LOSS_TOL:g}), grad_norm {rel['grad_norm']:.2e} (tol "
        f"{TRAIN_TP_NORM_TOL:g}); all-reduces a step {[st['all_reduces'] for st in steps]}; "
        f"steps 2-{TRAIN_TP_STEPS}: {', '.join('%.1f' % x for x in ms)} ms "
        f"({numbers['a']['tokens_per_s']:.0f} tokens/s); {smi}")
    if rel["loss"] > TRAIN_TP_LOSS_TOL or rel["grad_norm"] > TRAIN_TP_NORM_TOL:
        raise AssertionError(f"phase 20 (a): step 1 differs from TP = 1: {rel}")

    # (b): one spawn of the most ranks any layout needs serves every layout
    world = max(data * model for _, data, model in TRAIN_TP_LAYOUTS)
    res = _tp_run(world, {"kind": "consistency", "backend": "gloo", "layouts": TRAIN_TP_LAYOUTS},
                  "(b) training", target=train_tp_rank_main)
    numbers["b"] = {label: _train_tp_check(label, [r["layouts"][label] | {"rank": r["rank"]}
                                                   for r in res if label in r["layouts"]], smi)
                    for label, _, _ in TRAIN_TP_LAYOUTS}
    if torch.cuda.device_count() >= 2:
        task = {"kind": "consistency", "backend": "nccl", "layouts": (("TP=2 nccl", 1, 2),)}
        res = _tp_run(2, task, "TP=2 nccl training", target=train_tp_rank_main)
        numbers["c"] = _train_tp_check(
            "TP=2 nccl", [r["layouts"]["TP=2 nccl"] | {"rank": r["rank"]} for r in res], smi)
    else:
        numbers["c"] = (f"not run: {torch.cuda.device_count()} CUDA device(s); NCCL refuses two "
                        "ranks on one device")
        log(f"  (c) TP = 2 training over NCCL {numbers['c']}")
    return numbers


def _train_tp_check(label: str, ranks: list, smi: str) -> dict:
    """(b)'s rule on rank 0's numbers, every rank's metrics equal."""
    head = ranks[0]
    if any(r["metrics"] != head["metrics"] or r["all_reduces"] != head["all_reduces"]
           for r in ranks):
        raise AssertionError(f"phase 20 (b) {label}: the ranks disagree: {ranks}")
    log(f"  (b) {label}, {consistency_config().decoder.num_layers} + "
        f"{consistency_config().vision.num_layers} layers float32, {TRAIN_TP_ROWS} x "
        f"{TRAIN_CONSISTENCY_SEQ} tokens, {TRAIN_CONSISTENCY_VISION} image tokens a row: loss "
        f"{head['metrics']['loss']:.6f} / one process {head['reference']['loss']:.6f}, grad_norm "
        f"{head['metrics']['grad_norm']:.6f} / {head['reference']['grad_norm']:.6f} (rel "
        f"{head['rel_err']['loss']:.2e} / {head['rel_err']['grad_norm']:.2e}, tol "
        f"{TRAIN_REL_TOL:g}); updated params: worst {head['param_worst_over_lr']:.3f} lr (tol 2), "
        f"{head['param_outliers']} of {head['param_elements']} past 1e-2 lr (tol "
        f"{TRAIN_OUTLIER_SHARE:g} of them) {head['outliers_by_leaf']}; {head['all_reduces']} "
        f"all-reduces, step {head['step_ms']:.0f} ms"
        + (f"; checkpoint restored in one process bit-equal to the gathered state: "
           f"{head['checkpoint_bit_equal']}" if "checkpoint_bit_equal" in head else "")
        + f"; {smi}")
    if not head["ok"] or head.get("checkpoint_bit_equal") is False:
        raise AssertionError(f"phase 20 (b) {label} failed: {head}")
    return {k: v for k, v in head.items() if k != "rank"}


def shipping_flags() -> list:
    """deploy/shipping.env's serve settings as server flags."""
    env = shipping_env()
    return [item for key, flag in SHIPPING_KEYS.items() for item in (flag, env[key])]


def shipping_env() -> dict:
    """deploy/shipping.env's KEY=VALUE lines (comments and blanks skipped)."""
    env = {}
    with open(SHIPPING_ENV) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#") and "=" in line:
                key, value = line.split("=", 1)
                env[key.strip()] = value.strip()
    missing = [key for key in SHIPPING_KEYS if key not in env]
    if missing:
        raise AssertionError(f"{SHIPPING_ENV} lacks {missing}")
    return env


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is false; this run needs an NVIDIA GPU")
        return 2
    if not os.path.isdir(os.path.join(REPO, "dots_ocr_tpu_torch")):
        log("chip_smoke: dots_ocr_tpu_torch/ not found next to this script; "
            "run it from a checkout of the repository")
        return 2
    sys.path.insert(0, REPO)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("[1/20] device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s): {kind}; nvidia-smi: {smi}")

    if "--train-repeat" in sys.argv[1:]:
        # A developer's shortcut: phase 18 (c)'s step N times, diagnosed.
        runs = int(sys.argv[sys.argv.index("--train-repeat") + 1])
        log(f"[18/20] phase 18 (c) {runs} times (--train-repeat) on {smi}")
        summary = train_repeat_phase(runs, smi)
        log(smi)
        log(json.dumps({"train_repeat": summary}))
        return 0

    if "--train-tp-only" in sys.argv[1:]:
        # A developer's shortcut: phase 20 alone.
        log(f"[20/20] tensor- and data-parallel training alone (--train-tp-only) on {smi}")
        training_tp = train_tp_phase(dev, smi)
        log(f"phase 20 passed in {time.perf_counter() - t_start:.1f} s")
        log(smi)
        log(json.dumps({"training_tp": training_tp}))
        return 0

    log("[2/20] build the CUDA kernels")
    from dots_ocr_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    kernel_lib.load()
    log(f"  built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in kernel_lib.build_log.splitlines():
        if "Function properties for" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    if "--tp-only" in sys.argv[1:]:
        # A developer's shortcut (the full run takes no arguments): phase 19 alone.
        log(f"[3/20] the shard shapes' kernel cases alone (--tp-only) on {smi}")
        tp_shard_cases(dev)
        log(f"[19/20] tensor-parallel serving alone (--tp-only) on {smi}")
        tp = tp_phase(dev, shipping_flags(), smi)
        for numbers in tp.values():
            for res in numbers["ranks"] if isinstance(numbers, dict) else ():
                res.pop("replies", None)
        log(f"phase 19 passed in {time.perf_counter() - t_start:.1f} s")
        log(smi)
        log(json.dumps({"tensor_parallel": tp}))
        return 0

    log(f"[3/20] kernels vs plain versions on {smi}")
    kernels = kernel_phase(dev)
    kernels.update(w8a16_cases(dev))
    kernels.update(draw_cases(dev))
    kernels.update(threefry_cases(dev))
    for name, cases in tp_shard_cases(dev).items():
        kernels[name].extend(cases)
    tiny_call = tiny_call_phase(dev)
    w8a8_vision = w8a8_vision_phase(dev)

    log(f"[4/20] end to end, shipped path (int8 weights, int8 KV, k=2, chunk "
        f"{PREFILL_CHUNK}): flagship, random weights, OpenAIServer on {smi}")
    shipped_replies = []
    engine, shipped, metrics, page = serve_phase(
        dev, SHIPPED_FLAGS, "shipped", waves=SHIPPED_WAVES, replies=shipped_replies,
        before_serve=guard_off,
        required=("flash_attention", "flash_attention (q_offset > 0)",
                  "paged_attention_multiquery_int8", "w8a16_matmul", "w8a16_matmul (decode)",
                  "w8a16_matmul (prefill)"))
    if metrics.get("preemptions", 0) != 0:
        raise AssertionError(f"shipped path: the full pool preempted ({metrics})")
    if metrics.get("prefill_chunks", 0) < 2 or metrics.get("spec_chunks", 0) < 1:
        raise AssertionError(f"shipped path: prefill_chunks {metrics.get('prefill_chunks')} "
                             f"(need >= 2), spec_chunks {metrics.get('spec_chunks')} (need >= 1)")

    log("[5/20] consistency, shipped path: kernel path vs plain path, page request")
    consistency_chunked_phase(engine, page, dev)
    del engine
    release()

    log(f"[6/20] end to end, fully quantized path (int4 weights, W8A8 vision, int8 KV, k=2, "
        f"chunk {PREFILL_CHUNK}): flagship, random weights, OpenAIServer on {smi}")
    engine, full_quant, metrics, page = serve_phase(
        dev, FULL_QUANT_FLAGS, "int4", waves=FULL_QUANT_WAVES,
        required=("int4_matmul", "int4_matmul_w4a8", "int4_matmul_w4a8 (split)",
                  "int4_matmul_w4a8 (wgmma)", "flash_attention",
                  "flash_attention (q_offset > 0)", "paged_attention_multiquery_int8"))
    log(f"  [int4] W4A8 wave: {full_quant['int4_matmul_w4a8']} launches of the W4A8 kernel, "
        f"{full_quant['int4_matmul_w4a8 (wgmma)']} in the prefill regime (wgmma), "
        f"{full_quant['int4_matmul_w4a8 (split)']} in the decode regime (cluster split); "
        f"W4A16 wave: {full_quant['int4_matmul']} launches")
    if metrics.get("prefill_chunks", 0) < 2 or metrics.get("spec_chunks", 0) < 1:
        raise AssertionError(f"int4 path: prefill_chunks {metrics.get('prefill_chunks')} "
                             f"(need >= 2), spec_chunks {metrics.get('spec_chunks')} (need >= 1)")

    log("[7/20] consistency, fully quantized path: kernel path vs plain path, page request")
    consistency_chunked_phase(engine, page, dev, w8a8_vision=True)
    del engine
    release()

    log(f"[8/20] end to end, bf16 path (bf16 weights and KV, no speculation, one "
        f"{PREFILL_LIMIT}-token prefill), full depth, on {smi}")
    engine, bf16_path, _, page = serve_phase(
        dev, BF16_FLAGS, "bf16", required=("flash_attention", "paged_attention_multiquery"))
    log("  consistency, bf16 path: kernel path vs plain path, page request")
    consistency_phase(engine, page, dev)

    log(f"[9/20] quantized weights and kernel 3 in decode: one 64-slot step on {smi}")
    decode_ms, decode_launches = decode_cost_phase(engine, dev)
    del engine
    release()

    log(f"[10/20] end to end, windowed vision and int8 KV at page 64 (int8 weights, no "
        f"speculation, chunk {PREFILL_CHUNK}): flagship, random weights, OpenAIServer on {smi}")
    engine, windowed, metrics, page = serve_phase(
        dev, WINDOWED_FLAGS, "windowed",
        required=("window_attention", "flash_attention", "paged_attention_v1_int8"))
    if metrics.get("prefill_chunks", 0) < 2:
        raise AssertionError(f"windowed path: prefill_chunks {metrics.get('prefill_chunks')} "
                             f"(need >= 2)")
    log("  consistency, windowed page-64 path: kernel path vs plain path, page request")
    consistency_chunked_phase(engine, page, dev)
    del engine
    release()

    env = shipping_env()
    env_flags = shipping_flags()
    settings = ", ".join(f"{key}={env[key]}" for key in SHIPPING_KEYS)
    log(f"[11/20] end to end, deploy/shipping.env as written ({settings}): flagship, random "
        f"weights, waves (temperature, max_tokens) {SHIPPING_WAVES}, OpenAIServer on {smi}")
    engine, shipping, metrics, page = serve_phase(
        dev, [], "shipping.env", base_flags=env_flags, waves=SHIPPING_WAVES,
        required=("flash_attention", "flash_attention (q_offset > 0)",
                  "paged_attention_multiquery", "paged_attention_multiquery (nq > 1)",
                  "w8a16_matmul", "w8a16_matmul (decode)", "w8a16_matmul (prefill)",
                  "gumbel_argmax", "threefry2x32"))
    decode_calls = (shipping["paged_attention_multiquery"]
                    - shipping["paged_attention_multiquery (nq > 1)"])
    log(f"  [shipping.env] kernel 2 bf16: {decode_calls} launches at nq = 1 (decode), "
        f"{shipping['paged_attention_multiquery (nq > 1)']} at nq = 3 (verify); W8A16 "
        f"{shipping['w8a16_matmul']} ({shipping['w8a16_matmul (decode)']} decode, "
        f"{shipping['w8a16_matmul (prefill)']} prefill); draw {shipping['gumbel_argmax']}, "
        f"threefry {shipping['threefry2x32']}")
    if (decode_calls < 1 or metrics.get("prefill_chunks", 0) < 2
            or metrics.get("spec_chunks", 0) < 1 or metrics.get("pipelined_chunks", 0) < 1):
        raise AssertionError(f"shipping.env path: {decode_calls} nq = 1 launches (need >= 1), "
                             f"prefill_chunks {metrics.get('prefill_chunks')} (need >= 2), "
                             f"spec_chunks {metrics.get('spec_chunks')} (need >= 1), "
                             f"pipelined_chunks {metrics.get('pipelined_chunks')} (need >= 1)")
    log("  consistency, shipping.env path: kernel path vs plain path, page request")
    consistency_chunked_phase(engine, page, dev)
    del engine
    release()

    log(f"[12/20] a pool that runs dry (phase 4's flags, --num-pages cut): flagship, random "
        f"weights, OpenAIServer on {smi}")
    dry_launches, dry_metrics = dry_pool_phase(dev, shipped_replies[1])

    log(f"[13/20] pipelined decode A/B at full width: deploy/shipping.env's geometry with "
        f"--speculate-k 0, {PIPELINE_TOKENS} tokens a request, on {smi}")
    pipeline_ab = pipeline_ab_phase(dev, env_flags)
    log(f"  [13] deploy/shipping.env as written (k = 2) with the defaults, {PIPELINE_TOKENS} "
        f"tokens a request, over HTTP; then phase 14 on that server")
    engine, pipelined_k2, _, _ = serve_phase(
        dev, [], "shipping.env, pipelined", base_flags=env_flags,
        waves=((0.0, PIPELINE_TOKENS),), before_serve=first_text_token, probe=logit_options_probe,
        required=("flash_attention", "paged_attention_multiquery",
                  "paged_attention_multiquery (nq > 1)", "w8a16_matmul"))
    del engine
    release()

    with tempfile.TemporaryDirectory(prefix="dots_parse_") as workdir:
        log(f"[15/20] the loader, the batch engine and the parser's local mode: a synthetic "
            f"flagship checkpoint, a seeded 2-page PDF parse on {smi}")
        ckpt, local_launches, local_numbers = local_parse_phase(dev, workdir)
        log(f"[16/20] the parser's server mode: deploy/shipping.env's flags + --weights, the "
            f"CLI with --seed on a PDF and a PNG, on {smi}")
        served_launches, served_numbers = server_parse_phase(dev, ckpt, workdir, env_flags)

    log(f"[17/20] CUDA graphs and the warmup flags: deploy/shipping.env's engine graphed "
        f"against eager, --warmup full, phase 9's step as one chunk, --warmup background and "
        f"--compile-cache, on {smi}")
    engine, graph_numbers = graph_tokens_phase(dev, env_flags)
    graph_numbers["chunk"] = chunk_speed_phase(engine, dev)
    del engine
    release()
    graph_numbers["background"] = background_warmup_phase(dev, env_flags)
    graph_numbers["compile_cache"] = compile_cache_phase(env)

    log(f"[18/20] training: the trainer's CLI at the flagship's full width and depth, "
        f"{TRAIN_STEPS} steps with vision in process, card vs CPU and a checkpoint round trip, "
        f"on {smi}")
    training = {"cli": train_cli_phase(smi), "vision": train_vision_phase(dev, smi),
                "consistency": train_consistency_phase(smi)}

    log(f"[19/20] tensor-parallel serving: TP = 2 over gloo on this card (the flagship, "
        f"deploy/shipping.env's flags), TP = 4 with KV replication and padded gate/up "
        f"({TP4_LAYERS} + {TP4_LAYERS} layers), TP = 2 through kernel 3 (int8 KV, page "
        f"{TP_V1_PAGE}), NCCL with CUDA graphs where there are 2 GPUs, on {smi}")
    tp = tp_phase(dev, env_flags, smi)

    log(f"[20/20] tensor- and data-parallel training: TP = 2 over gloo on this card (the "
        f"flagship, bf16, remat), TP = 2, TP = 4 and model 2 x data 2 at "
        f"{TRAIN_CONSISTENCY_LAYERS} + {TRAIN_CONSISTENCY_LAYERS} layers against one process, "
        f"a TP = 2 checkpoint restored in one process, NCCL where there are 2 GPUs, on {smi}")
    training_tp = train_tp_phase(dev, smi)

    sources = {
        "gumbel_argmax": ("dots_ocr_tpu_torch/csrc/threefry_sample.cu",
                          "none: fused by XLA into the sampling program "
                          "(dots_ocr_tpu/engine/sampling.py:47 _categorical)", shipping),
        "threefry2x32": ("dots_ocr_tpu_torch/csrc/threefry_sample.cu",
                         "none: jax.random's threefry2x32, fused by XLA (fold_in / split / "
                         "uniform of dots_ocr_tpu/engine/sampling.py)", shipping),
        "w8a16_matmul": ("dots_ocr_tpu_torch/csrc/int8_matmul.cuh",
                         "none: XLA fuses the int8 convert into the dot "
                         "(dots_ocr_tpu/models/layers.py:62-67 linear, :101-108 unembed)",
                         shipping),
        "flash_attention": ("dots_ocr_tpu_torch/csrc/flash_attention.cu",
                            "dots_ocr_tpu/ops/flash_attention.py:330", shipped),
        "paged_attention_multiquery": ("dots_ocr_tpu_torch/csrc/paged_attention.cu",
                                       "dots_ocr_tpu/ops/paged_attention.py:689", shipping),
        "paged_attention_multiquery_int8": (
            "dots_ocr_tpu_torch/csrc/paged_attention.cu",
            "dots_ocr_tpu/ops/paged_attention.py:689 (int8 mode, :400-501)", shipped),
        "int4_matmul": ("dots_ocr_tpu_torch/csrc/int4_matmul.cu",
                        "dots_ocr_tpu/ops/int4_matmul.py:232", full_quant),
        "int4_matmul_w4a8": ("dots_ocr_tpu_torch/csrc/int4_matmul.cu",
                             "dots_ocr_tpu/ops/int4_matmul.py:232 (act_quant=True)",
                             full_quant),
        "window_attention": ("dots_ocr_tpu_torch/csrc/window_attention.cu",
                             "dots_ocr_tpu/ops/window_attention.py:96", windowed),
        "paged_attention_v1": ("dots_ocr_tpu_torch/csrc/paged_attention_v1.cu",
                               "dots_ocr_tpu/ops/paged_attention.py:268", decode_launches),
        "paged_attention_v1_int8": ("dots_ocr_tpu_torch/csrc/paged_attention_v1.cu",
                                    "dots_ocr_tpu/ops/paged_attention.py:268 (int8 mode, "
                                    ":142-148)", windowed),
    }
    # The case whose numbers head each kernel's entry: the main path's shape
    # (kernel 3's bf16 mode runs at page 128 in phase 9, its int8 mode at
    # phase 10's served shape; W8A16 at gate/up of a 64-slot decode step, the
    # largest linear of a step), else the first.
    main_case = {"paged_attention_v1": 1, "paged_attention_v1_int8": 2,
                 "w8a16_matmul": next(i for i, c in enumerate(kernels["w8a16_matmul"])
                                      if c["case"].startswith("w8a16 gate/up")
                                      and f"M={MAX_SLOTS}," in c["case"])}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": sources[name][2][name],
         "max_abs_err": max(c["max_abs_err"] for c in cases),
         **{key: cases[main_case.get(name, 0)][key] for key in keys}, "cases": cases}
        for name, cases in kernels.items()
    ], "launches_by_path": {"shipped": shipped, "int4": full_quant, "bf16": bf16_path,
                            "decode_steps": decode_launches, "windowed": windowed,
                            "shipping.env": shipping, "dry_pool": dry_launches,
                            "shipping.env, pipelined": pipelined_k2,
                            "local parse": local_launches, "served parse": served_launches,
                            "tp2": tp["tp2"]["ranks"][0]["launches"],
                            "tp4": tp["tp4"]["ranks"][0]["launches"],
                            "tp2 page 64": tp["tp2_page64"]["ranks"][0]["launches"]},
        "tensor_parallel": tp,
        "local_parse": local_numbers, "served_parse": served_numbers,
        "pipeline_ab": pipeline_ab, "graphs": graph_numbers,
        "dry_pool_preemptions": dry_metrics["preemptions"], "training": training,
        "training_tp": training_tp,
        "decode_step_ms": decode_ms, "w8a8_vision_linear_ms": w8a8_vision,
        "tiny_call_ms": tiny_call}
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
