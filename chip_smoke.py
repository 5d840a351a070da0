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
   linear shapes and 64, 192 and 4,096 rows; the window kernel at the
   windowed vision batch (the same 2 images packed window-major, a padded
   edge window and a fully padded bucket window), beside flash with the
   windows as segments (and flash's own case on those windows); the v1
   paged kernel (kernel 3) in both modes over 64 slots x 2,048 tokens at
   page 64 and 128 (kernel 2's bf16 mode timed beside it at page 128), and
   in bf16 at D 64; max abs
   error against the stated tolerance (kernels 1 and 2 in bf16 also
   against a bound scaled to the output, which a control must fail),
   median CUDA-event times per call over back-to-back calls, the least
   time the card could take (bound) and, where one PyTorch call computes the
   same function, that call's time; and, for context, the W8A8 vision
   linear against the bf16 one at the vision shapes;
4. end to end, the shipped path: the flagship model (full width and depth,
   random bf16 weights from a seed, quantized to int8) with int8 KV, k = 2
   speculation and 2,048-token chunked prefill at the shipping geometry,
   served by the port's ``OpenAIServer`` on 127.0.0.1; /health, three
   concurrent chat completions (a page, a receipt, a text prompt),
   /metrics (prefill chunks and verify chunks counted); the flash kernel
   (with q_offset > 0) and the int8 paged kernel must launch in that run;
5. consistency of that path: the page request's chunked-prefill logits and
   four int8-KV decode steps through the kernels vs their plain versions;
6. end to end, the fully quantized path: as phase 4 with int4 decoder
   block linears (int8 embedding) and W8A8 vision; the int4 kernel (W4A16),
   flash (with q_offset > 0) and the int8 paged kernel must launch;
7. consistency of that path, as phase 5, with the int4 linears switched to
   their plain version through ``int4_matmul.IMPLEMENTATIONS``, both decoder
   passes on the kernel path's image embeddings; the argmax must agree too.
   The W8A8 encoder's kernel-vs-plain gap must stay within the noise of its
   activation quantization;
8. end to end, the bf16 path (bf16 weights and KV, no speculation, one
   4,096-token prefill), as phase 4; the flash and bf16 paged kernels must
   launch; then the same consistency check in bf16;
9. the cost of quantized weights in decode: one decode step for 64 slots
   with the bf16 weights, their int8 quantization (dequantized per call)
   and their int4 quantization in both modes (W4A8 launches here, on a
   path through the model), and the bf16 step with ``attn_impl="v1"``
   (kernel 3's bf16 mode on a path through the model);
10. end to end, windowed vision and int8 KV at page 64: int8 weights, int8
   KV, page 64 (kernel 3 on every decode step, as the JAX package runs it),
   no speculation, 2,048-token chunks, the encoder windowed (16 x 16-patch
   windows, layers 6, 13, 20, 27, 34, 41 image-wide), served as phase 4;
   the window kernel, flash and kernel 3's int8 mode must launch; then the
   consistency check of phase 5 on that path;
11. end to end, ``deploy/shipping.env`` as written: its PAGE_SIZE, KV_DTYPE,
   QUANTIZE, SPECULATE_K, PREFILL_CHUNK, NUM_PAGES, MAX_SLOTS,
   MAX_SEQ_TOKENS, STEPS_PER_SYNC and VISION_ATTN, nothing overridden
   (today int8 weights, bf16 KV, k = 2), served as phase 4, then the same
   three requests again sampled at temperature 1 for 128 tokens, so that
   the engine's speculation gate turns speculation off and plain decode
   steps run too (SHIPPING_WAVES); flash (with q_offset > 0) and
   kernel 2's bf16 mode at nq = 1 (decode) and nq = 3 (verify) must
   launch; then the consistency check of phase 5 on that configuration.

The line before the last is one JSON object with the per-kernel numbers;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import os
import socket
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

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
# int4 kernel vs plain. W4A8: exact (integer group sums, each scaled with one
# rounding, added in the Pallas order on both sides). W4A16: the products
# are exact in float32 and only their summation order differs: 1 bf16 ulp of
# the output (<= 2^-7 |plain|) plus 1e-4 for the float32 order near zero.
INT4_TOL = {False: (1e-4, 2.0**-7), True: (0.0, 0.0)}
# The decoder's block linears (K, N) and the rows of a decode step, a k = 2
# verify step and a 2-row prefill chunk.
INT4_SHAPES = {"wq/wo": (1536, 1536), "wk/wv": (1536, 256), "gate/up": (1536, 8960),
               "down": (8960, 1536)}
INT4_ROWS = (64, 192, 4096)
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
# Kernel 3 at a 64-slot decode step: 2,048 tokens per row.
V1_CONTEXT = 2048
# Phase 11: the deployment file, and its serve flags by key (read as written).
SHIPPING_ENV = os.path.join(REPO, "deploy", "shipping.env")
SHIPPING_KEYS = {"PAGE_SIZE": "--page-size", "KV_DTYPE": "--kv-cache-dtype",
                 "QUANTIZE": "--quantize", "SPECULATE_K": "--speculate-k",
                 "PREFILL_CHUNK": "--prefill-chunk-tokens", "NUM_PAGES": "--num-pages",
                 "MAX_SLOTS": "--max-slots", "MAX_SEQ_TOKENS": "--max-seq-tokens",
                 "STEPS_PER_SYNC": "--steps-per-sync", "VISION_ATTN": "--vision-attn"}
# Phase 11's waves of the three requests, (temperature, max_tokens): the
# greedy wave of phases 4-10, then the same requests sampled for long
# enough that the engine's speculation gate (spec_min_tokens_per_iter,
# 1.5) sees the drafts of near-uniform samples fail for three chunks and
# turns speculation off, so plain decode steps (nq = 1) run too: on random
# weights greedy text repeats and its drafts are accepted (1.70 tokens per
# slot-iteration on the card), so a greedy wave runs verify steps only.
SHIPPING_WAVES = ((0.0, 32), (1.0, 128))
# The bound: NVIDIA H100 SXM data sheet (dense, 700 W): HBM 3.35 TB/s,
# 989 TFLOP/s bf16, 1,979 TOP/s int8.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
REPS = 10
# Calls per timed sample: a kernel's time is taken over back-to-back calls,
# so that what is timed is the device's work rather than one call's host
# time before its launch.
INNER = 5


def log(msg: str = "") -> None:
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


def time_in_turns(fns: dict, inner: int = INNER) -> dict:
    """Median CUDA-event ms per call of REPS samples of each function, a
    sample being ``inner`` calls back to back (so the wrapper's host time
    before each launch overlaps the previous call's device time), after
    one warm call, taking them in turns (the order reversed every other
    round)."""
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for r in range(REPS):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            times[name].append(cuda_ms(fns[name], inner) / inner)
    return {name: statistics.median(ts) for name, ts in times.items()}


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
            work: dict = None, library_fn=None, extra: dict = None, control_fn=None) -> dict:
    """Run kernel and plain once, check |err| <= atol + rtol * |plain|, then
    time REPS runs of each in turns (with ``library_fn``, one PyTorch call
    that computes the same function, and the ``extra`` functions, timed in
    the same turns for comparison). ``work`` is the case's :func:`bound`.
    With ``control_fn`` (the plain version on V rounded through fp8) the
    kernel must also pass :func:`tight_errors`' bound, the control must
    fail it, and REPEAT_CALLS more kernel calls must repeat the output bit
    for bit."""
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
        control = tight_errors(control_fn(), ref)
        same = sum(bool(torch.equal(kernel_fn(), out)) for _ in range(REPEAT_CALLS))
        log(f"  {name}: kernel rel RMS err {tight['rel_rms_err']:.3e} (tol {TIGHT_RMS:g}), max "
            f"err / (2^-7|ref| + {TIGHT_ROW:g} rms_D(ref)) {tight['tight_ratio']:.3f} (tol 1); "
            f"control, plain on V through fp8: {control['rel_rms_err']:.3e}, "
            f"{control['tight_ratio']:.3f} (must fail); {same} of {REPEAT_CALLS} repeated "
            f"calls bit-identical")
        if same != REPEAT_CALLS:
            raise AssertionError(f"{name}: {REPEAT_CALLS - same} of {REPEAT_CALLS} repeated "
                                 f"calls differ from the first")
        if not _tight_pass(tight):
            raise AssertionError(f"{name}: kernel fails the tight bound ({tight})")
        if _tight_pass(control):
            raise AssertionError(f"{name}: the fp8 control passes the tight bound ({control})")
        tight.update({f"control_{key}": value for key, value in control.items()})
    del out, ref
    fns = {"ms": kernel_fn, "plain_ms": plain_fn, **(extra or {})}
    if library_fn is not None:
        fns["library_ms"] = library_fn
    times = time_in_turns(fns)
    res = {"case": name, "max_abs_err": max_abs, "library_ms": None, **tight, **times,
           **(work or {})}
    log(f"  {name}: max_abs_err {max_abs:.3e} (tol {atol:g} + {rtol:g}*|ref|), "
        f"kernel {res['ms']:.3f} ms, plain {res['plain_ms']:.3f} ms, "
        + "".join(f"{k} {v:.3f} ms, " for k, v in times.items() if k not in ("ms", "plain_ms"))
        + (f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}) " if work else "")
        + f"(median of {REPS} samples of {INNER} calls)")
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
        paged_attention_int8_reference,
        paged_attention_multiquery_bf16,
        paged_attention_multiquery_int8,
        paged_attention_multiquery_reference,
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
    # kernel's tile. No single PyTorch call reads a paged pool: no
    # library time.
    kq, ks = quantize_kv(kp)
    vq, vs = quantize_kv(vp)
    for nq in (1, 3):
        qd = randn(MAX_SLOTS, nq, 12, 128)
        results["paged_attention_multiquery"].append(compare(
            f"paged decode nq={nq} bf16 {shape}",
            lambda: paged_attention_multiquery_bf16(qd, kp, vp, lens_t, table_t),
            lambda: paged_attention_multiquery_reference(qd, kp, vp, lens_t, table_t),
            work=_paged_work(qd, lens_t, 2, int8=False),
            control_fn=lambda: paged_attention_multiquery_reference(qd, kp, fp8_round(vp),
                                                                    lens_t, table_t)))
        results["paged_attention_multiquery_int8"].append(compare(
            f"paged decode nq={nq} int8 {shape}",
            lambda: paged_attention_multiquery_int8(qd, kq, vq, ks, vs, lens_t, table_t),
            lambda: paged_attention_int8_reference(qd, kq, vq, ks, vs, lens_t, table_t),
            work=_paged_work(qd, lens_t, 2, int8=True)))
    del kp, vp, kq, vq, ks, vs
    windows = window_cases(randn, dev)
    results["flash_attention"].append(windows.pop("flash_windowed"))
    results.update(windows)
    results.update(paged_v1_cases(randn, dev))
    results.update(int4_cases(randn, gen, dev))
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
        extra={"flash_same_windows_ms": lambda: flash_attention(*flat, win_seg, win_seg)})
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


def paged_v1_cases(randn, dev) -> dict:
    """Kernel 3 against its plain version: 64 slots x 2,048 tokens, 12q/2kv,
    D 128, pages of 64 and 128 in both modes, and D 64 in bf16 (the JAX
    rule's head_dim case); the pool is the middle layer of a 3-layer stack.
    No single PyTorch call reads a paged pool: no library time."""
    import numpy as np
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import quantize_kv
    from dots_ocr_tpu_torch.ops.paged_attention import (
        paged_attention_multiquery_bf16,
        paged_attention_stacked,
        paged_attention_v1_reference,
    )

    def stack(x):
        flat = x.reshape(1, x.shape[0], -1, *x.shape[3:])
        return torch.cat([torch.zeros_like(flat), flat, torch.zeros_like(flat)]).contiguous()

    results = {"paged_attention_v1": [], "paged_attention_v1_int8": []}
    rng = np.random.RandomState(1)
    lengths = np.full(MAX_SLOTS, V1_CONTEXT)
    for page_size, head_dim, modes in ((64, 128, (False, True)), (128, 128, (False, True)),
                                       (64, 64, (False,))):
        kp, vp, lens_t, table_t = _paged_pool(randn, rng, lengths, page_size, head_dim,
                                              -(-V1_CONTEXT // page_size))
        qd = randn(MAX_SLOTS, 12, head_dim)
        for int8 in modes:
            if int8:
                (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
                k_all, v_all, ks_all, vs_all = stack(kq), stack(vq), stack(ks), stack(vs)
            else:
                k_all, v_all, ks_all, vs_all = stack(kp), stack(vp), None, None
            args = (qd, k_all, v_all, 1, lens_t, table_t, page_size, ks_all, vs_all)
            # Kernel 2's bf16 mode on the same rows, timed in the same turns
            # (the JAX rule sends bf16 decode at head_dim 128 to kernel 2).
            extra = {}
            if page_size == 128 and head_dim == 128 and not int8:
                def k2():
                    return paged_attention_multiquery_bf16(qd[:, None], kp, vp, lens_t,
                                                           table_t)[:, 0]
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
            results["paged_attention_v1_int8" if int8 else "paged_attention_v1"].append(compare(
                f"paged v1 {'int8' if int8 else 'bf16'} 64 slots x {V1_CONTEXT} page "
                f"{page_size} 12q/2kv D={head_dim}",
                lambda: paged_attention_stacked(*args),
                lambda: paged_attention_v1_reference(*args),
                work=_paged_work(qd, lens_t, 2, int8=int8), extra=extra))
            del k_all, v_all, ks_all, vs_all, args
        del kp, vp
    return results


def int4_cases(randn, gen, dev) -> dict:
    """Kernel 5 in both modes against its plain version at the decoder's
    linear shapes: weights from quantize_kernel_int4 of N(0, 0.02) bf16,
    activations N(0, 1). No single PyTorch call unpacks int4: no library
    time."""
    import torch

    from dots_ocr_tpu_torch.models.quantize import quantize_kernel_int4
    from dots_ocr_tpu_torch.ops.int4_matmul import int4_matmul, int4_matmul_plain

    results = {"int4_matmul": [], "int4_matmul_w4a8": []}
    for label, (k, n) in INT4_SHAPES.items():
        qk = quantize_kernel_int4(randn(k, n) * 0.02)
        packed, scales = qk["qint4"], qk["scale4"]
        for rows in INT4_ROWS:
            x = randn(rows, k)
            # x and out bf16, the packed nibbles and float32 group scales
            nbytes = 2 * rows * k + packed.numel() + 4 * scales.numel() + 2 * rows * n
            for act, key in ((False, "int4_matmul"), (True, "int4_matmul_w4a8")):
                atol, rtol = INT4_TOL[act]
                results[key].append(compare(
                    f"int4 {'W4A8' if act else 'W4A16'} {label} K={k} N={n} M={rows}",
                    lambda: int4_matmul(x, packed, scales, act),
                    lambda: int4_matmul_plain(x, packed, scales, act), atol, rtol,
                    work=bound(2.0 * rows * k * n, nbytes, "int8" if act else "bf16")))
    return results


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
    from dots_ocr_tpu_torch.ops.paged_attention import (
        paged_attention_multiquery_bf16,
        paged_attention_multiquery_int8,
        paged_attention_stacked,
    )
    from dots_ocr_tpu_torch.ops.window_attention import window_attention

    return {"flash_attention": (flash_attention, "launches"),
            "flash_attention (q_offset > 0)": (flash_attention, "offset_launches"),
            "paged_attention_multiquery": (paged_attention_multiquery_bf16, "launches"),
            "paged_attention_multiquery (nq > 1)": (paged_attention_multiquery_bf16,
                                                    "verify_launches"),
            "paged_attention_multiquery_int8": (paged_attention_multiquery_int8, "launches"),
            "paged_attention_v1": (paged_attention_stacked, "launches"),
            "paged_attention_v1_int8": (paged_attention_stacked, "int8_launches"),
            "window_attention": (window_attention, "launches"),
            "int4_matmul": (int4_matmul, "launches"),
            "int4_matmul_w4a8": (int4_matmul, "w4a8_launches")}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def serve_phase(dev, flags, label: str, required, base_flags=None, waves=((0.0, 32),)):
    """Build the engine through the server's entry point with ``flags``
    (after ``base_flags``, by default the shipping geometry of phases 4-10),
    serve it, and drive three concurrent requests per wave, one wave after
    the other, each wave's requests at its (temperature, max_tokens). Every
    counter named in ``required`` must move during the served run (all
    waves). Returns (engine, the launch counts of the run, /metrics as a
    dict, the page image)."""
    import torch
    from aiohttp import web
    from PIL import Image

    from dots_ocr_tpu_torch.serve.openai_server import OpenAIServer
    from dots_ocr_tpu_torch.utils.image_io import pil_to_base64
    from dots_ocr_tpu_torch.utils.prompts import dict_promptmode_to_prompt as prompts
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

    port = _free_port()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(OpenAIServer(engine, model_name="flagship-random").build_app())
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
    base = f"http://127.0.0.1:{port}"
    try:
        status, body = _http(f"{base}/health")
        if status != 200:
            raise AssertionError(f"/health -> {status} {body}")
        log(f"  [{label}] /health -> {status} {body}")
        page = Image.open(os.path.join(REPO, "demo/assets/sample_page.png"))
        receipt = Image.open(os.path.join(REPO, "demo/assets/sample_receipt.png"))

        def chat(img, text):
            content = [{"type": "text", "text": text}]
            if img is not None:
                content = [{"type": "image_url", "image_url": {"url": pil_to_base64(img)}},
                           {"type": "text", "text": "<|img|><|imgpad|><|endofimg|>" + text}]
            return {"model": "flagship-random", "messages": [{"role": "user", "content": content}]}

        requests = [("page/prompt_layout_all_en", chat(page, prompts["prompt_layout_all_en"])),
                    ("receipt/prompt_ocr", chat(receipt, prompts["prompt_ocr"])),
                    ("text", chat(None, "Summarize the layout rules of a scanned invoice."))]

        def post(item):
            name, body = item
            t = time.perf_counter()
            status, text = _http(f"{base}/v1/chat/completions", body)
            return name, status, json.loads(text), time.perf_counter() - t

        reset_counts()
        for wave, (temperature, max_tokens) in enumerate(waves):
            wave_label = label if len(waves) == 1 else f"{label} wave {wave + 1}"
            batch = [(name, {**body, "temperature": temperature, "max_tokens": max_tokens})
                     for name, body in requests]
            _serve_wave(post, batch, wave_label, temperature)
        launches = read_counts()
        status, text = _http(f"{base}/metrics")
        metrics = {}
        for line in text.splitlines():
            if line.startswith("dots_ocr_engine_") and len(line.split()) == 2:
                key, value = line.split()
                metrics[key[len("dots_ocr_engine_"):]] = float(value)
        if status != 200 or metrics.get("prefills", 0) < 3:
            raise AssertionError(f"/metrics shows fewer than 3 prefills: {metrics}")
        shown = ("prefills", "prefill_chunks", "steps", "spec_chunks", "spec_emitted",
                 "spec_slot_iters", "spec_auto_disabled", "t_admit_s", "t_prefill_s",
                 "t_decode_s")
        log(f"  [{label}] /metrics: " + ", ".join(f"{k} {metrics.get(k)}" for k in shown))
        log(f"  [{label}] kernel launches during the served run: {launches}")
        for name in required:
            if launches[name] < 1:
                raise AssertionError(f"{name} was not launched on the {label} path")
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(120)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(60)
    return engine, launches, metrics, page


def _serve_wave(post, batch, label: str, temperature: float) -> None:
    """Post the wave's requests concurrently; each must come back HTTP 200
    with completion tokens. Logs each request and the wave's wall."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(batch)) as pool:
        results = list(pool.map(post, batch))
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
    log(f"  [{label}] 3 concurrent requests at temperature {temperature:g}: wall {wall:.2f} s, "
        f"{total_tokens} completion tokens -> {total_tokens / wall:.1f} tok/s")


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
            logits, k, v = vlm_prefill(
                params, cfg, put(ids), put(np.arange(t)[None]), put(np.array([t])),
                patches=put(packed.patches), rope_cos=cos, rope_sin=sin,
                segment_ids=put(packed.segment_ids), attn_impl=impl, last_logit_only=True,
                **scatter)
            paged = PagedKV.create(cfg.decoder, alloc.num_pages, PAGE_SIZE,
                                   cfg.torch_dtype, dev)
            write_prefill_kv(paged, k, v, put(alloc.slot_mapping(0, 0, t)))
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
    bf16 weights and their int8 quantization (``linear`` dequantizes it to
    a bf16 copy on every call) over a bf16 pool, the shipped pair (int8
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
                 "paged_attention_v1"):
        if launches[name] < 1:
            raise AssertionError(f"{name} was not launched in the decode steps")
    return res, launches


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

    log("[1/11] device")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"  torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s): {kind}; nvidia-smi: {smi}")

    log("[2/11] build the CUDA kernels")
    from dots_ocr_tpu_torch.ops import kernel_lib

    t0 = time.perf_counter()
    kernel_lib.load()
    log(f"  built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in kernel_lib.build_log.splitlines():
        if "Function properties for" in line or "registers" in line or "spill" in line:
            log(f"  {line.strip()}")

    log(f"[3/11] kernels vs plain versions on {smi}")
    kernels = kernel_phase(dev)
    tiny_call = tiny_call_phase(dev)
    w8a8_vision = w8a8_vision_phase(dev)

    log(f"[4/11] end to end, shipped path (int8 weights, int8 KV, k=2, chunk "
        f"{PREFILL_CHUNK}): flagship, random weights, OpenAIServer on {smi}")
    engine, shipped, metrics, page = serve_phase(
        dev, SHIPPED_FLAGS, "shipped",
        required=("flash_attention", "flash_attention (q_offset > 0)",
                  "paged_attention_multiquery_int8"))
    if metrics.get("prefill_chunks", 0) < 2 or metrics.get("spec_chunks", 0) < 1:
        raise AssertionError(f"shipped path: prefill_chunks {metrics.get('prefill_chunks')} "
                             f"(need >= 2), spec_chunks {metrics.get('spec_chunks')} (need >= 1)")

    log("[5/11] consistency, shipped path: kernel path vs plain path, page request")
    consistency_chunked_phase(engine, page, dev)
    del engine
    torch.cuda.empty_cache()

    log(f"[6/11] end to end, fully quantized path (int4 weights, W8A8 vision, int8 KV, k=2, "
        f"chunk {PREFILL_CHUNK}): flagship, random weights, OpenAIServer on {smi}")
    engine, full_quant, metrics, page = serve_phase(
        dev, FULL_QUANT_FLAGS, "int4",
        required=("int4_matmul", "flash_attention", "flash_attention (q_offset > 0)",
                  "paged_attention_multiquery_int8"))
    if metrics.get("prefill_chunks", 0) < 2 or metrics.get("spec_chunks", 0) < 1:
        raise AssertionError(f"int4 path: prefill_chunks {metrics.get('prefill_chunks')} "
                             f"(need >= 2), spec_chunks {metrics.get('spec_chunks')} (need >= 1)")

    log("[7/11] consistency, fully quantized path: kernel path vs plain path, page request")
    consistency_chunked_phase(engine, page, dev, w8a8_vision=True)
    del engine
    torch.cuda.empty_cache()

    log(f"[8/11] end to end, bf16 path (bf16 weights and KV, no speculation, one "
        f"{PREFILL_LIMIT}-token prefill), full depth, on {smi}")
    engine, bf16_path, _, page = serve_phase(
        dev, BF16_FLAGS, "bf16", required=("flash_attention", "paged_attention_multiquery"))
    log("  consistency, bf16 path: kernel path vs plain path, page request")
    consistency_phase(engine, page, dev)

    log(f"[9/11] quantized weights and kernel 3 in decode: one 64-slot step on {smi}")
    decode_ms, decode_launches = decode_cost_phase(engine, dev)
    del engine
    torch.cuda.empty_cache()

    log(f"[10/11] end to end, windowed vision and int8 KV at page 64 (int8 weights, no "
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
    torch.cuda.empty_cache()

    env = shipping_env()
    env_flags = [item for key, flag in SHIPPING_KEYS.items() for item in (flag, env[key])]
    settings = ", ".join(f"{key}={env[key]}" for key in SHIPPING_KEYS)
    log(f"[11/11] end to end, deploy/shipping.env as written ({settings}): flagship, random "
        f"weights, waves (temperature, max_tokens) {SHIPPING_WAVES}, OpenAIServer on {smi}")
    engine, shipping, metrics, page = serve_phase(
        dev, [], "shipping.env", base_flags=env_flags, waves=SHIPPING_WAVES,
        required=("flash_attention", "flash_attention (q_offset > 0)",
                  "paged_attention_multiquery", "paged_attention_multiquery (nq > 1)"))
    decode_calls = (shipping["paged_attention_multiquery"]
                    - shipping["paged_attention_multiquery (nq > 1)"])
    log(f"  [shipping.env] kernel 2 bf16: {decode_calls} launches at nq = 1 (decode), "
        f"{shipping['paged_attention_multiquery (nq > 1)']} at nq = 3 (verify)")
    if (decode_calls < 1 or metrics.get("prefill_chunks", 0) < 2
            or metrics.get("spec_chunks", 0) < 1):
        raise AssertionError(f"shipping.env path: {decode_calls} nq = 1 launches (need >= 1), "
                             f"prefill_chunks {metrics.get('prefill_chunks')} (need >= 2), "
                             f"spec_chunks {metrics.get('spec_chunks')} (need >= 1)")
    log("  consistency, shipping.env path: kernel path vs plain path, page request")
    consistency_chunked_phase(engine, page, dev)
    del engine
    torch.cuda.empty_cache()

    sources = {
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
                             decode_launches),
        "window_attention": ("dots_ocr_tpu_torch/csrc/window_attention.cu",
                             "dots_ocr_tpu/ops/window_attention.py:96", windowed),
        "paged_attention_v1": ("dots_ocr_tpu_torch/csrc/paged_attention_v1.cu",
                               "dots_ocr_tpu/ops/paged_attention.py:268", decode_launches),
        "paged_attention_v1_int8": ("dots_ocr_tpu_torch/csrc/paged_attention_v1.cu",
                                    "dots_ocr_tpu/ops/paged_attention.py:268 (int8 mode, "
                                    ":142-148)", windowed),
    }
    # The case whose numbers head each kernel's entry: the main path's shape
    # (kernel 3's bf16 mode runs at page 128 in phase 9), else the first.
    main_case = {"paged_attention_v1": 1}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": sources[name][2][name],
         "max_abs_err": max(c["max_abs_err"] for c in cases),
         **{key: cases[main_case.get(name, 0)][key] for key in keys}, "cases": cases}
        for name, cases in kernels.items()
    ], "launches_by_path": {"shipped": shipped, "int4": full_quant, "bf16": bf16_path,
                            "decode_steps": decode_launches, "windowed": windowed,
                            "shipping.env": shipping},
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
