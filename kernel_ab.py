#!/usr/bin/env python3
"""Kernels 1-5 of two checkouts (kernels 2, 3 and 5 in both modes), timed
the same way in one run on one GPU, and the split counts of kernel 2 (per
mode), kernel 3 and kernel 5 (W4A16 splits, W4A8 cluster sizes and column
widths) swept.

    mkdir -p _archive/parent && git archive <parent commit> | tar -x -C _archive/parent
    python3 kernel_ab.py --parent _archive/parent

Runs one worker process per tree, in the order parent, this checkout,
this checkout, parent. Each worker imports ``dots_ocr_tpu_torch`` from its
tree (building that tree's kernels), makes the same inputs from the same
seeds on the card, and times, through the public wrappers a caller uses,
``flash_attention`` at chip_smoke.py's four shapes,
``paged_attention_multiquery_bf16`` at its three,
``paged_attention_multiquery_int8`` at the shipping geometry (nq = 1 and 3),
``window_attention`` at the windowed vision batch, ``paged_attention_stacked``
(kernel 3) at chip_smoke.py's ``paged_v1_cases`` shapes and phase 10's served
shape (3 live rows among 64 slots, a table of 640 pages of 64), and
``int4_matmul`` in both modes (W4A16, W4A8) at the four decoder shapes x
INT4_ROWS: per call as
single calls (inner 1) and as back-to-back calls (inner INNER, chip_smoke.py's
method), median of REPS samples taken in turns with the yardsticks (the same
in every worker): one SDPA call at the flash and window shapes; cuBLAS bf16
on the dequantized weight and ``torch._weight_int4pack_mm`` at the W4A16
shapes (chip_smoke.py's ``int4_yardsticks``); beside W4A8, for context and
not the same function, ``torch._int_mm`` on the quantized rows and the
unpacked int8 weight (the same int8 products, twice the weight bytes, no
group scales) and cuBLAS bf16 on the dequantized weight. Each
output's max abs error against its tree's plain version is kept, and
REPEATS more calls on the same inputs are compared with the first bit for
bit: the count that differ shows a race.

A worker whose tree has them also times kernel 2's split kernels and merge
(bf16 and int8) at the shipping geometry (64 slots, lengths 0..12k, table
width 320 x page 128) at nq = 1 and 3 over SWEEP split counts, in the same
turns, through ``_paged_bf16_launch`` and ``_paged_int8_launch``, and
kernel 3's over V1_SWEEP counts through ``_paged_v1_launch``, kernel 5
W4A16's split counts through ``_w4a16_launch`` and kernel 5 W4A8's decode
regime over cluster sizes and column widths through ``_w4a8_launch``.

It also times the int8 weight-only ``layers.linear`` and the int8
``unembed`` at chip_smoke.py's W8A16 shapes and rows (the W8A16 kernel in a
tree that has it, the per-call bf16 copy and cuBLAS before it), beside
cuBLAS bf16 on the weight converted once; a 64-slot step's seeded draw over
the full vocabulary with its key folds (one launch in a tree whose draw
folds its keys, torch folds and a two-pass draw before); phase 9's
decode step (64 slots x 2,048, int8 weights, bf16 KV) graphed and eager,
at nq = 1 and as a k = 2 verify (nq = 3: deploy/shipping.env's step); and
one 2,048-token prefill chunk through the flagship decoder with int8 and
with bf16 weights, eager.
A tree with them also sweeps the W8A16 kernel's launch choices (the TMA
kernel: consumer warpgroups and their split x cluster ranks; the earlier
mma.sync kernel: row tiles x cluster ranks) and the draw's cluster sizes,
each tree through its own entry and signature.

A tree with them also takes parts out of its W8A16 kernel ("ablation
w8a16": no convert, no wgmma, and for the TMA kernel no TMA wait, i.e. no
loads; for the earlier kernel no convert, no mma, no wgmma) to show what
holds it back.

``--only`` takes comma-separated prefixes of case names (and "sweep int4",
"sweep w4a8", "sweep paged", "sweep w8a16", "sweep draw", "ablation w8a16",
"decode step", "prefill chunk") and
times only those: a tuning run's way to spend less card time.

Prints a summary and, as its last line, one JSON object with every
worker's numbers.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# Split counts of the sweep (chunk = the next multiple of 64 of the
# table's tokens / count).
SWEEP = (8, 16, 24, 28, 32, 40, 48, 64, 80)
# Kernel 3's split counts of its sweep (chunk = the next multiple of 64 and
# of the page of the table's tokens / count).
V1_SWEEP = (4, 8, 16, 24, 32, 48, 64, 80)
# Kernel 5's rows: decode and verify steps, the shipped prefill chunk, the
# 2-row chunk.
INT4_ROWS = (64, 192, 2048, 4096)
# Calls per case after the first, each compared with it bit for bit.
REPEATS = 200


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its helpers and shapes)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str, only: tuple = ()) -> dict:
    """Time the tree at ``root``'s kernels at the shapes (with ``only``, the
    cases named with those prefixes)."""
    import numpy as np
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import dots_ocr_tpu_torch
    from dots_ocr_tpu_torch.ops import kernel_lib
    from dots_ocr_tpu_torch.ops import paged_attention as paged_mod
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention_reference as flash_plain
    from dots_ocr_tpu_torch.engine.kv_cache import quantize_kv
    from dots_ocr_tpu_torch.ops.window_attention import (
        window_attention,
        window_attention_reference,
    )

    if not os.path.abspath(dots_ocr_tpu_torch.__file__).startswith(root + os.sep):
        raise RuntimeError(f"dots_ocr_tpu_torch came from {dots_ocr_tpu_torch.__file__}")
    cs = _chip_smoke()
    paged_plain = paged_mod.paged_attention_multiquery_reference
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernel_lib.load()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(torch.bfloat16)

    cases, sweep, int4_checks = {}, {}, {}

    def want(prefix: str) -> bool:
        """Whether ``only`` selects cases named with ``prefix`` (or some of them)."""
        return not only or any(p.startswith(prefix) or prefix.startswith(p) for p in only)

    def case(name, kernel_fn, plain_fn, library_fn=None, library=None):
        if not want(name):
            return
        first, plain = kernel_fn(), plain_fn().float()
        err = float((first.float() - plain).abs().max())
        # REPEATS more calls on the same inputs: each must equal the first
        # bit for bit (a race shows here); the worst error of any call.
        differ, worst = 0, err
        for _ in range(REPEATS):
            out = kernel_fn()
            if not torch.equal(out, first):
                differ += 1
                worst = max(worst, float((out.float() - plain).abs().max()))
        del first, plain, out
        fns = {"kernel": kernel_fn, **(library or {})}
        if library_fn is not None:
            fns["sdpa"] = library_fn
        res = {"max_abs_err": err, "repeats": REPEATS, "repeats_differing": differ,
               "worst_abs_err": worst}
        for inner in (1, cs.INNER):
            res.update({f"{key}_ms_inner{inner}": ms
                        for key, ms in cs.time_in_turns(fns, inner=inner).items()})
        res.update({f"{key}_graph_ms": graph_ms(fn, cs) for key, fn in fns.items()})
        res["kernel_device_us"], res["kernel_launches_per_call"] = device_breakdown(kernel_fn)
        cases[name] = res
        torch.cuda.empty_cache()

    if want("flash") or want("window"):
        # Kernel 1 at chip_smoke.py's shapes (kernel_phase and window_cases).
        seg = np.full((1, 6656), -1, np.int32)
        seg[0, :5040], seg[0, 5040:6420] = 0, 1
        seg = torch.from_numpy(seg).to(dev)
        q, k, v = randn(1, 6656, 12, 128), randn(1, 6656, 12, 128), randn(1, 6656, 12, 128)
        block = ((seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] >= 0))[:, None]
        case("flash vision T=6656", lambda: flash_attention(q, k, v, seg, seg),
             lambda: flash_plain(q, k, v, seg, seg), lambda: cs._sdpa(q, k, v, block))
        del block
        lens = torch.tensor([2048, 1531, 800, 77], device=dev)
        seg = torch.where(torch.arange(2048, device=dev)[None] < lens[:, None], 0, -1).to(torch.int32)
        q, k, v = randn(4, 2048, 12, 128), randn(4, 2048, 2, 128), randn(4, 2048, 2, 128)
        case("flash prefill B=4 x 2048 causal",
             lambda: flash_attention(q, k, v, seg, seg, causal=True),
             lambda: flash_plain(q, k, v, seg, seg, causal=True),
             lambda: cs._sdpa(q, k, v, causal=True))
        plen = torch.tensor([4096, 3100], device=dev)
        pos = torch.arange(4096, device=dev)
        q_seg = torch.where(pos[None, 2048:] < plen[:, None], 0, -1).to(torch.int32)
        kv_seg = torch.where(pos[None, :] < plen[:, None], 0, -1).to(torch.int32)
        q, k, v = randn(2, 2048, 12, 128), randn(2, 4096, 2, 128), randn(2, 4096, 2, 128)
        chunk_mask = ((q_seg[:, :, None] == kv_seg[:, None, :]) & (q_seg[:, :, None] >= 0)
                      & (pos[None, None, :] <= pos[None, 2048:, None]))[:, None]
        case("flash chunk C=2048 at q_offset 2048",
             lambda: flash_attention(q, k, v, q_seg, kv_seg, causal=True, q_offset=2048),
             lambda: flash_plain(q, k, v, q_seg, kv_seg, causal=True, q_offset=2048),
             lambda: cs._sdpa(q, k, v, chunk_mask))
        del chunk_mask
        wseg, _ = cs.windowed_segments(dev)
        nw, w = wseg.shape
        win_seg = torch.where(wseg >= 0, torch.arange(nw, device=dev)[:, None], -1)
        win_seg = win_seg.reshape(1, -1).to(torch.int32)
        q, k, v = randn(nw, w, 12, 128), randn(nw, w, 12, 128), randn(nw, w, 12, 128)
        flat = [x.reshape(1, nw * w, 12, 128) for x in (q, k, v)]
        key_mask = (wseg >= 0)[:, None, None, :]
        case(f"flash windowed {nw} x {w}", lambda: flash_attention(*flat, win_seg, win_seg),
             lambda: flash_plain(*flat, win_seg, win_seg), lambda: cs._sdpa(q, k, v, key_mask))
        # Kernel 4 on the same windows.
        case(f"window attention {nw} x {w}", lambda: window_attention(q, k, v, wseg),
             lambda: window_attention_reference(q, k, v, wseg), lambda: cs._sdpa(q, k, v, key_mask))
        del q, k, v, flat

    if want("paged"):
        # Kernel 2's bf16 mode at chip_smoke.py's shapes.
        kernel2 = paged_mod.paged_attention_multiquery_bf16
        rng = np.random.RandomState(0)
        lengths = rng.randint(1, 12001, cs.MAX_SLOTS)
        lengths[::8] = 0
        kp, vp, lens_t, table_t = cs._paged_pool(randn, rng, lengths, cs.PAGE_SIZE, 128,
                                                 cs.MAX_SEQ_TOKENS // cs.PAGE_SIZE, extra=2)
        shipping_q = {}
        for nq in (1, 3):
            qd = shipping_q[nq] = randn(cs.MAX_SLOTS, nq, 12, 128)
            case(f"paged bf16 nq={nq} 64 slots 0..12k",
                 lambda: kernel2(qd, kp, vp, lens_t, table_t),
                 lambda: paged_plain(qd, kp, vp, lens_t, table_t))
        if hasattr(paged_mod, "_paged_bf16_launch") and want("sweep paged"):
            sweep["bf16"] = _split_sweep(paged_mod, paged_mod._paged_bf16_launch, shipping_q,
                                         (kp, vp), lens_t, table_t, cs)
        # Kernel 2's int8 mode on the same rows (pools from quantize_kv), against
        # the tree's unsplit plain version.
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        del kp, vp
        kernel2_int8 = paged_mod.paged_attention_multiquery_int8
        for nq, qd in shipping_q.items():
            case(f"paged int8 nq={nq} 64 slots 0..12k",
                 lambda: kernel2_int8(qd, kq, vq, ks, vs, lens_t, table_t),
                 lambda: paged_mod.paged_attention_int8_reference(qd, kq, vq, ks, vs, lens_t,
                                                                  table_t))
        if hasattr(paged_mod, "_paged_int8_launch") and want("sweep paged"):
            sweep["int8"] = _split_sweep(paged_mod, paged_mod._paged_int8_launch, shipping_q,
                                         (kq, vq, ks, vs), lens_t, table_t, cs,
                                         paged_mod.paged_int8_split_plan)
        del kq, vq, ks, vs
        rng = np.random.RandomState(1)
        kp, vp, lens_t, table_t = cs._paged_pool(randn, rng, np.full(cs.MAX_SLOTS, cs.V1_CONTEXT),
                                                 128, 128, cs.V1_CONTEXT // 128)
        qd = randn(cs.MAX_SLOTS, 1, 12, 128)
        case("paged bf16 nq=1 64 x 2048 page 128",
             lambda: kernel2(qd, kp, vp, lens_t, table_t),
             lambda: paged_plain(qd, kp, vp, lens_t, table_t))
        del kp, vp

        # Kernel 3 at chip_smoke.py's paged_v1_cases shapes and phase 10's served
        # shape, against the tree's plain version in its kernel's order.
        stacked = paged_mod.paged_attention_stacked
        v1_plain = paged_mod.paged_attention_v1_reference
        split = hasattr(paged_mod, "paged_v1_split_plan")
        rng = np.random.RandomState(1)
        full = np.full(cs.MAX_SLOTS, cs.V1_CONTEXT)
        served = np.zeros(cs.MAX_SLOTS, np.int64)
        served[:len(cs.V1_SERVED_LENGTHS)] = cs.V1_SERVED_LENGTHS
        v1_served = {}
        for page_size, head_dim, int8, lengths in (
                (64, 128, True, full), (128, 128, True, full), (64, 128, False, full),
                (128, 128, False, full), (64, 64, False, full), (64, 128, True, served),
                (64, 128, False, served)):
            width = (cs.MAX_SEQ_TOKENS if lengths is served else cs.V1_CONTEXT) // page_size
            args, _ = cs.v1_inputs(randn, rng, lengths, page_size, head_dim, width, int8)
            chunk = {"chunk": cs.v1_split(args)[0]} if split else {}
            rows = "served 2200/420/40 of 64, width 640" if lengths is served else "64 x 2048"
            case(f"paged v1 {'int8' if int8 else 'bf16'} {rows} page {page_size} D={head_dim}",
                 lambda: stacked(*args), lambda: v1_plain(*args, **chunk))
            if lengths is served:
                v1_served["int8" if int8 else "bf16"] = args
            elif page_size == 64 and int8:
                v1_served["int8 64 x 2048"] = args
        if hasattr(paged_mod, "_paged_v1_launch") and want("sweep paged"):
            sweep["v1"] = _v1_sweep(paged_mod, v1_served, cs)
        del v1_served, args

    if want("int4"):
        # Kernel 5 at the decoder's linear shapes: W4A16 with cuBLAS bf16 on
        # the dequantized weight and torch._weight_int4pack_mm in the same
        # turns; W4A8 with torch._int_mm on the quantized rows and the
        # unpacked int8 weight, and cuBLAS bf16, for context.
        from dots_ocr_tpu_torch.models.quantize import quantize_kernel_int4
        from dots_ocr_tpu_torch.ops import int4_matmul as int4_mod
        from dots_ocr_tpu_torch.ops.int4_matmul import (
            int4_matmul,
            int4_matmul_plain,
            quantize_rows,
            unpack_int4,
        )

        for label, (k, n) in cs.INT4_SHAPES.items():
            qk = quantize_kernel_int4(randn(k, n) * 0.02)
            packed, scales = qk["qint4"], qk["scale4"]
            q8 = unpack_int4(packed)
            for rows in INT4_ROWS:
                x = randn(rows, k)
                library, check = cs.int4_yardsticks(x, packed, scales)
                name = f"int4 W4A16 {label} K={k} N={n} M={rows}"
                if want(name):
                    int4_checks[name] = check
                case(name, lambda: int4_matmul(x, packed, scales),
                     lambda: int4_matmul_plain(x, packed, scales), library=library)
                xq = quantize_rows(x)[0].to(torch.int8)
                context = {"cublas_bf16": library["cublas_bf16"],
                           "int_mm": lambda: torch._int_mm(xq, q8)}
                case(f"int4 W4A8 {label} K={k} N={n} M={rows}",
                     lambda: int4_matmul(x, packed, scales, True),
                     lambda: int4_matmul_plain(x, packed, scales, True), library=context)
            del qk, packed, scales, q8, x, xq, library, context
        if hasattr(int4_mod, "_w4a16_launch") and want("sweep int4"):
            sweep["int4"] = _int4_sweep(int4_mod, randn, cs)
        if hasattr(int4_mod, "_w4a8_launch") and want("sweep w4a8"):
            sweep["w4a8"] = _w4a8_sweep(int4_mod, randn, cs)
    if want("w8a16") or want("sweep w8a16") or want("ablation w8a16"):
        # The int8 weight-only linear and the tied int8 unembed through the
        # model's entry points (layers.linear / unembed: the W8A16 kernel in a
        # tree that has it, the per-call bf16 copy and cuBLAS before it), at
        # chip_smoke.py's W8A16_SHAPES and rows; the plain version is the copy
        # path written out; cuBLAS bf16 on the weight converted once beside.
        from dots_ocr_tpu_torch.models import layers
        from dots_ocr_tpu_torch.models.quantize import quantize_embedding, quantize_kernel

        for label, (k, n) in cs.W8A16_SHAPES.items():
            unembed = label == "lm_head"
            if unembed:
                qk = quantize_embedding(randn(n, k))
            else:
                qk = quantize_kernel(randn(k, n) * 0.02)
            bias = randn(n) if label in ("wq/wo", "wk/wv") else None
            w_lib = qk["qint8"].to(torch.bfloat16)
            w_lib = w_lib.t() if unembed else w_lib
            for rows in cs.W8A16_ROWS:
                if unembed and rows > 3 * cs.MAX_SLOTS:
                    continue
                x = randn(rows, k)
                if unembed:
                    fn = lambda: layers.unembed(x, qk)  # noqa: E731
                    plain = lambda: layers.matmul_f32(x, w_lib) * qk["scale"]  # noqa: E731
                else:
                    fn = lambda: layers.linear(x, qk, bias)  # noqa: E731

                    def plain():
                        y = layers.matmul_f32(x, qk["qint8"].to(x.dtype)) * qk["scale"]
                        return (y if bias is None else y + bias.float()).to(x.dtype)
                case(f"w8a16 {label} K={k} N={n} M={rows}", fn, plain,
                     library={"cublas_bf16": lambda: layers.matmul_f32(x, w_lib)})
            del qk, w_lib, x
        try:  # a tree before the W8A16 kernel has no such module
            from dots_ocr_tpu_torch.ops import int8_matmul as w8_mod
        except ImportError:
            w8_mod = None
        if w8_mod is not None and want("sweep w8a16"):
            sweep["w8a16"] = _w8a16_sweep(w8_mod, randn, cs)
        if w8_mod is not None and want("ablation w8a16"):
            sweep["w8a16_ablation"] = _w8a16_ablation(root, w8_mod, randn, cs)

    if want("draw") or want("sweep draw"):
        # A 64-slot step's draw over the full vocabulary, keys and all: the
        # slot keys folded with the positions, then the Gumbel-max draw with
        # the temperatures fused (in a tree whose draw folds its own keys,
        # one launch; before, the folds as torch ops and a two-pass draw).
        import inspect

        from dots_ocr_tpu_torch.engine import sampling as eng_sampling
        from dots_ocr_tpu_torch.ops import sampling as ops_sampling

        rng = np.random.RandomState(7)
        logits = torch.from_numpy((rng.randn(cs.MAX_SLOTS, 151936) * 3).astype(np.float32)).to(dev)
        temps = torch.from_numpy(rng.uniform(0.05, 1.5, cs.MAX_SLOTS).astype(np.float32)).to(dev)
        slot_keys = eng_sampling.split(eng_sampling.prng_key(12), cs.MAX_SLOTS).to(dev)
        pos = torch.from_numpy(rng.randint(0, 40960, cs.MAX_SLOTS).astype(np.int64)).to(dev)
        draw = ops_sampling.gumbel_argmax
        if "positions" in inspect.signature(draw).parameters:
            step = lambda: draw(logits, slot_keys, temps, positions=pos)  # noqa: E731
        else:
            step = lambda: draw(logits, eng_sampling.fold_positions(slot_keys, pos),  # noqa: E731
                                temps)
        case("draw [64, 151936] slot keys + positions, temperatures fused", step,
             lambda: ops_sampling.gumbel_argmax_reference(
                 logits, eng_sampling.fold_positions(slot_keys.cpu(), pos.cpu()).to(dev), temps))
        if hasattr(ops_sampling, "draw_plan") and want("sweep draw"):
            sweep["draw"] = _draw_sweep(ops_sampling, logits, temps, slot_keys, pos, cs)
        del logits

    if want("decode step"):
        sweep["decode_step"] = _decode_step(dev, cs)
    if want("prefill chunk"):
        sweep["prefill_chunk"] = _prefill_chunk(dev, cs)
    return {"root": root, "build_s": build_s, "cases": cases, "split_sweep": sweep,
            "int4pack_check": int4_checks}


def _decode_step(dev, cs) -> dict:
    """chip_smoke.py phase 9's step at shipping.env's weights: 64 slots at
    2,048 tokens of context, the flagship decoder with int8 weights over a
    bf16 pool (page 128), greedy logits, at nq = 1 (a decode step: 64 rows a
    linear) and as a k = 2 verify (nq = 3: 192 rows a linear, the step
    deploy/shipping.env runs), each as one CUDA graph (device ms a step,
    median of REPS replays) and eager (ms a call, back to back)."""
    import torch

    from dots_ocr_tpu_torch.engine.kv_cache import PagedKV
    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.decoder import (
        decoder_decode_step_paged,
        decoder_spec_step_paged,
        embed_tokens,
        logits_from_hidden,
    )
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.models.quantize import quantize_decoder_params

    cfg = DotsOCRConfig.flagship()
    params = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    dec = quantize_decoder_params(params["decoder"])
    del params
    s, ctx, page, nq = cs.MAX_SLOTS, 2048, cs.PAGE_SIZE, 3
    per_row = (ctx + nq) // page + 1
    pool = PagedKV.create(cfg.decoder, s * per_row + 1, page, cfg.torch_dtype, dev)
    table = (1 + torch.arange(s * per_row, device=dev, dtype=torch.int32)).reshape(s, per_row)
    pos = torch.full((s,), ctx, dtype=torch.int64, device=dev)
    slots = table[:, ctx // page].long() * page + ctx % page
    lens = (pos + 1).to(torch.int32)
    tokens = (torch.arange(s, device=dev) * 7 + 100) % cfg.decoder.vocab_size
    vpos = pos[:, None] + torch.arange(nq, device=dev)[None]
    vslots = table.gather(1, vpos // page).long() * page + vpos % page
    vtokens = (tokens[:, None] + torch.arange(nq, device=dev)[None] * 13) % cfg.decoder.vocab_size

    def step():
        with torch.no_grad():
            h = decoder_decode_step_paged(dec, cfg.decoder, embed_tokens(dec, tokens), pos,
                                          pool.k, pool.v, table, lens, slots, page)
            return logits_from_hidden(dec, cfg.decoder, h)

    def verify():
        with torch.no_grad():
            h = decoder_spec_step_paged(dec, cfg.decoder, embed_tokens(dec, vtokens), vpos,
                                        pool.k, pool.v, table, lens, vslots, page)
            return logits_from_hidden(dec, cfg.decoder, h)

    out = {}
    for name, fn in (("", step), ("verify_", verify)):
        out[f"{name}graph_ms"] = graph_ms(fn, cs, calls=1)
        out[f"{name}eager_ms"] = cs.time_in_turns({"step": fn}, inner=1)["step"]
    del dec, pool
    torch.cuda.empty_cache()
    return out


def _prefill_chunk(dev, cs) -> dict:
    """One shipped prefill chunk (chip_smoke.py's PREFILL_CHUNK tokens of one
    request) through the flagship decoder, the last token's logits
    included, with int8 weights (the W8A16 kernel in a tree that has it,
    the per-call bf16 copy and cuBLAS before it) and with bf16 weights
    (cuBLAS), in turns: ms a chunk, eager as the engine runs it (median of
    REPS single calls)."""
    import torch

    from dots_ocr_tpu_torch.models.config import DotsOCRConfig
    from dots_ocr_tpu_torch.models.decoder import decoder_prefill, logits_from_hidden
    from dots_ocr_tpu_torch.models.init import init_params
    from dots_ocr_tpu_torch.models.quantize import quantize_decoder_params

    cfg = DotsOCRConfig.flagship()
    params = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0))
    decs = {"int8": quantize_decoder_params(params["decoder"]), "bf16": params["decoder"]}
    t = cs.PREFILL_CHUNK
    gen = torch.Generator(device=dev).manual_seed(1)
    embeds = torch.randn(1, t, cfg.decoder.hidden_size, generator=gen, device=dev).to(
        cfg.torch_dtype)
    positions = torch.arange(t, device=dev)[None]
    lens = torch.tensor([t], device=dev)

    def chunk(dec):
        with torch.no_grad():
            hidden, _ = decoder_prefill(dec, cfg.decoder, embeds, positions, lens)
            return logits_from_hidden(dec, cfg.decoder, hidden[:, -1])

    out = cs.time_in_turns({name: lambda dec=dec: chunk(dec) for name, dec in decs.items()},
                           inner=1)
    del params, decs
    torch.cuda.empty_cache()
    return out


def _w8a16_inputs(label, k, n, randn):
    """chip_smoke.py's W8A16 weights for one shape: (q, scale, [N, K] layout)."""
    from dots_ocr_tpu_torch.models.quantize import quantize_embedding, quantize_kernel

    nk = label == "lm_head"
    qk = quantize_embedding(randn(n, k)) if nk else quantize_kernel(randn(k, n) * 0.02)
    return qk["qint8"], qk["scale"], nk


def _w8a16_sweep(w8_mod, randn, cs) -> dict:
    """The W8A16 kernel at chip_smoke.py's shapes and the rows of a decode
    step of one slot and of 64, a k = 2 verify and a prefill chunk, over
    its launch choices, through the tree's own entry: device ms (CUDA
    graphs) and which one the plan takes. A tree whose plan names consumer
    warpgroups (the TMA kernel) sweeps consumers (1, 2) x cluster ranks at
    the plan's row tile; a tree with the earlier mma.sync kernel sweeps its
    row tiles x cluster ranks (its split regime) or cluster ranks (its wgmma
    regime)."""
    import torch

    from dots_ocr_tpu_torch.ops import kernel_lib

    dev = torch.device("cuda")
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tma = "consumers" in w8_mod.W8A16Plan._fields
    out = {}
    for label, (k, n) in cs.W8A16_SHAPES.items():
        q, scale, nk = _w8a16_inputs(label, k, n, randn)
        for rows in (1, cs.MAX_SLOTS, 3 * cs.MAX_SLOTS, cs.PREFILL_CHUNK):
            if nk and rows > 3 * cs.MAX_SLOTS:
                continue
            x = randn(rows, k)
            y = torch.empty(rows, n, dtype=torch.float32 if nk else torch.bfloat16, device=dev)
            plan = w8_mod.w8a16_plan(rows, k, n, num_sms, nk)
            res = {}
            if tma:
                blocks = k // w8_mod.K_BLOCK
                tile = plan.rows_tile
                shapes = [(1, "columns")]  # (consumers, split) the library builds at this tile
                if not nk and tile <= w8_mod.PREFILL_ROWS_TILE:  # the split's largest tile
                    shapes.append((2, "contraction"))
                if not nk and tile == 128 and n % (2 * w8_mod.COLS) == 0:
                    shapes.append((2, "columns"))
                for consumers, split in shapes:
                    for cluster in sorted({1, 2, 4, 8, plan.cluster}):
                        if cluster > blocks:
                            continue
                        variant = plan._replace(consumers=consumers, split=split, cluster=cluster)

                        def call(variant=variant):
                            w8_mod._launch(x, q, scale, None, y, nk, nk, variant, dev.index or 0)
                        name = f"{consumers}wg {split} x{cluster}"
                        res[name] = {"graph_ms": graph_ms(call, cs), "planned": variant == plan}
            else:
                lib = kernel_lib.load()
                wgmma = plan.regime == "wgmma"
                for tile in (0,) if wgmma else w8_mod.ROW_TILES:
                    for cluster in sorted({1, 2, 3, 4, 6, plan.cluster, w8_mod.MAX_CLUSTER}):
                        unit = w8_mod.K_MULTIPLE if wgmma else w8_mod.SPLIT_UNIT[nk]
                        if cluster > k // unit or (tile and tile < 64 and rows > 2 * 64):
                            continue

                        def call(tile=tile, cluster=cluster):
                            kernel_lib.check(lib.dots_w8a16_matmul(
                                x.data_ptr(), q.data_ptr(), scale.data_ptr(), 0, y.data_ptr(),
                                rows, k, n, int(nk), int(nk), 0, tile, cluster,
                                torch.cuda.current_stream().cuda_stream), "w8a16 sweep")
                        res[f"{tile}x{cluster}"] = {
                            "graph_ms": graph_ms(call, cs),
                            "planned": (tile, cluster) == (plan.rows_tile, plan.cluster)}
            out[f"{label} M={rows}"] = res
    return out


def _w8a16_ablation(root: str, w8_mod, randn, cs) -> dict:
    """What holds the W8A16 kernel back: the tree's kernel built again (in a
    temporary directory) with a part taken out, timed at its planned launch
    beside the kernel itself and cuBLAS bf16 on a converted weight. The TMA
    kernel (a tree whose plan names consumer warpgroups) is built with its
    ablation switches: "no convert" (the weight bytes passed to the tensor
    cores unconverted), "no wgmma" (the products removed, their operands
    kept live) and "no TMA wait" (no loads: the producer arrives on each
    stage's full barrier at once, so the consumers never wait for data).
    The earlier mma.sync kernel is edited as its text allows: "no
    convert", "no mma" (each mma.sync replaced by one add that keeps its
    operands live), "no mma, operands dropped" and "no wgmma". Device ms as CUDA graphs; the
    variants' outputs are wrong by design and are not checked."""
    import ctypes
    import tempfile

    import torch

    from dots_ocr_tpu_torch.ops import kernel_lib

    csrc = os.path.join(root, "dots_ocr_tpu_torch", "csrc")
    tma = "consumers" in w8_mod.W8A16Plan._fields
    if tma:
        sources = sorted(os.path.join(csrc, f) for f in os.listdir(csrc)
                         if f.startswith("int8_matmul") and f.endswith(".cu"))
        variants = {"no convert": ["-DW8A16_ABLATE_NO_CONVERT"],
                    "no wgmma": ["-DW8A16_ABLATE_NO_WGMMA"],
                    "no TMA wait": ["-DW8A16_ABLATE_NO_TMA_WAIT"]}
    else:
        src = open(os.path.join(csrc, "int8_matmul.cu")).read()
        convert = "  const uint32_t u = w ^ 0x80808080u;  // b + 128 in each byte"
        mma = src[src.index('  asm volatile(\n      "mma.sync'):
                  src.index('"r"(b0), "r"(b1));') + 19]
        wgmma = '"wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "'
        texts = {
            "no convert": src.replace(convert, "  return make_uint2(w, w ^ 1u);\n" + convert),
            "no mma": src.replace(mma, "  d[0] += __uint_as_float((a[0] ^ a[1] ^ a[2] ^ a[3] ^ b0 "
                                       "^ b1) & 0x3fffffffu);"),
            "no mma, operands dropped": src.replace(mma, ""),
            "no wgmma": src.replace(wgmma, '"// "').replace(
                '"}, %32, %33, p, 1, 1, 0, 0;\\n}\\n"', '"\\n}\\n"'),
        }
        for name, text in texts.items():
            if text == src:
                raise RuntimeError(f"the {name} variant changed nothing")
    libs = {"kernel": kernel_lib.load()}
    with tempfile.TemporaryDirectory() as tmp:
        procs = []  # (variant, object or library, process)
        for name in (variants if tma else texts):
            stem = os.path.join(tmp, name.replace(" ", "_").replace(",", ""))
            if tma:
                for src_path in sources:
                    obj = f"{stem}.{os.path.basename(src_path)}.o"
                    procs.append((name, obj, subprocess.Popen(
                        [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, *variants[name], "-c", "-o",
                         obj, src_path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                        text=True)))
            else:
                with open(stem + ".cu", "w") as f:
                    f.write(texts[name])
                procs.append((name, stem + ".so", subprocess.Popen(
                    [kernel_lib._nvcc(), *kernel_lib.NVCC_FLAGS, "-shared", "-o", stem + ".so",
                     stem + ".cu"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        built = {}
        for name, path, proc in procs:
            log = proc.communicate(timeout=900)[0]
            if proc.returncode != 0:
                raise RuntimeError(f"the {name} variant failed to build:\n{log[-2000:]}")
            built.setdefault(name, []).append(path)
        for name, paths in built.items():
            so = paths[0]
            if tma:
                so = os.path.join(tmp, name.replace(" ", "_") + ".so")
                link = subprocess.run([kernel_lib._nvcc(), "-shared", "-o", so, *paths],
                                      capture_output=True, text=True, timeout=600)
                if link.returncode != 0:
                    raise RuntimeError(f"the {name} variant failed to link:\n{link.stderr[-2000:]}")
            lib = ctypes.CDLL(so)
            lib.dots_w8a16_matmul.argtypes = kernel_lib._SIGNATURES["dots_w8a16_matmul"]
            libs[name] = lib
        dev = torch.device("cuda")
        num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        out = {}
        for label, (k, n) in cs.W8A16_SHAPES.items():
            q, scale, nk = _w8a16_inputs(label, k, n, randn)
            w_lib = q.to(torch.bfloat16)
            w_lib = w_lib.t() if nk else w_lib
            for rows in (1, cs.MAX_SLOTS, 3 * cs.MAX_SLOTS, cs.PREFILL_CHUNK):
                if nk and rows > 3 * cs.MAX_SLOTS:
                    continue
                x = randn(rows, k)
                y = torch.empty(rows, n, dtype=torch.float32 if nk else torch.bfloat16, device=dev)
                plan = w8_mod.w8a16_plan(rows, k, n, num_sms, nk)
                launch = ((plan.rows_tile, plan.consumers, w8_mod.SPLITS.index(plan.split),
                           plan.cluster) if tma else tuple(plan))
                res = {}
                for name, lib in libs.items():
                    def call(lib=lib):
                        kernel_lib.check(lib.dots_w8a16_matmul(
                            x.data_ptr(), q.data_ptr(), scale.data_ptr(), 0, y.data_ptr(), rows,
                            k, n, int(nk), int(nk), 0, *launch,
                            torch.cuda.current_stream().cuda_stream), f"w8a16 {name}")
                    try:  # a refused launch is recorded, not timed
                        call()
                        torch.cuda.synchronize()
                    except RuntimeError as exc:
                        res[name] = f"failed: {exc}"
                        continue
                    res[name] = graph_ms(call, cs)
                res["cublas_bf16"] = graph_ms(lambda: x @ w_lib, cs)
                out[f"{label} M={rows} ({plan.regime})"] = res
    return out


def _draw_sweep(ops_sampling, logits, temps, keys, pos, cs) -> dict:
    """The draw kernel at [64, 151,936] (slot keys and positions folded in
    the kernel, temperatures fused) over cluster sizes, through the C
    entry: device ms (CUDA graphs) and which one the plan takes."""
    import torch

    from dots_ocr_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load()
    b, v = logits.shape
    out = torch.empty(b, dtype=torch.int64, device=logits.device)
    planned = ops_sampling.draw_plan(b, v, torch.cuda.get_device_properties(
        logits.device).multi_processor_count)
    res = {}
    for cluster in range(1, ops_sampling.DRAW_MAX_CLUSTER + 1):
        def call(cluster=cluster):
            kernel_lib.check(lib.dots_threefry_gumbel_argmax(
                logits.data_ptr(), temps.data_ptr(), keys.data_ptr(), 2, pos.data_ptr(), -1, 0,
                0, out.data_ptr(), b, v, cluster, torch.cuda.current_stream().cuda_stream),
                "draw sweep")
        res[str(cluster)] = {"graph_ms": graph_ms(call, cs), "planned": cluster == planned}
    return res


def device_breakdown(fn, calls: int = 20) -> dict:
    """Device microseconds per call of each CUDA kernel that ``fn`` launches
    (torch.profiler's CUDA activity over ``calls`` calls, after one warm
    call; {} where the profiler records no device time), and the device
    operations a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out, ops = {}, 0
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if us:
            ops += evt.count
        if us and evt.count >= calls:
            out[evt.key[:60]] = us / calls
    return out, ops / calls


def graph_ms(fn, cs, calls: int = 10):
    """chip_smoke.py's ``graph_ms`` (device ms per call of ``fn`` in a CUDA
    graph), or None where the calls cannot be captured."""
    import torch

    try:
        return cs.graph_ms(fn, calls)
    except RuntimeError:
        torch.cuda.synchronize()
        return None


def _int4_sweep(int4_mod, randn, cs) -> dict:
    """Kernel 5 W4A16's split-K kernel (and reduce) at the four decoder
    shapes, M = 64 and 192, over split counts (each a whole number of units
    a split), device ms by CUDA graph and back-to-back eager ms; the plan's
    choice is marked."""
    import torch

    from dots_ocr_tpu_torch.models.quantize import quantize_kernel_int4
    from dots_ocr_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load()
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, (k, n) in cs.INT4_SHAPES.items():
        qk = quantize_kernel_int4(randn(k, n) * 0.02)
        packed, scales = qk["qint4"], qk["scale4"]
        units = k // 2 // int4_mod.SPLIT_UNIT
        for rows in (64, 192):
            x = randn(rows, k)
            y = torch.empty(rows, n, dtype=torch.bfloat16, device=x.device)
            planned = int4_mod.int4_split_plan(rows, k, n, num_sms)
            plans = sorted({(-(-units // c), -(-units // -(-units // c)))
                            for c in (1, 2, 3, 4, 6, 8, 12, 16, 24, 35, 48, 70) if c <= units}
                           | {planned})
            fns = {}
            for per, count in plans:
                def fn(per=per, count=count):
                    err = int4_mod._w4a16_launch(
                        lib, x, packed, scales, y, per, count,
                        torch.cuda.current_stream().cuda_stream)
                    kernel_lib.check(err, "int4 sweep")
                    return y
                fns[f"{count} x {per}{'*' if (per, count) == planned else ''}"] = fn
            eager = cs.time_in_turns(fns, inner=cs.INNER)
            out[f"{label} M={rows}"] = {key: {"ms": eager[key], "graph_ms": graph_ms(fn, cs)}
                                        for key, fn in fns.items()}
    return out


def _w4a8_sweep(int4_mod, randn, cs) -> dict:
    """Kernel 5 W4A8's decode regime (the ordered cluster split) at the four
    decoder shapes, M = 64 and 192, over every column width and cluster size
    that fits (``w4a8_candidates``), and its wgmma regime at M = 2,048 at
    both column widths: device ms by CUDA graph and back-to-back eager ms,
    and whether the output equals the plain version bit for bit; the plan's
    choice is marked."""
    import torch

    from dots_ocr_tpu_torch.models.quantize import quantize_kernel_int4
    from dots_ocr_tpu_torch.ops import kernel_lib

    lib = kernel_lib.load()
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, (k, n) in cs.INT4_SHAPES.items():
        qk = quantize_kernel_int4(randn(k, n) * 0.02)
        packed, scales = qk["qint4"], qk["scale4"]
        for rows in (64, 192, 2048):
            x = randn(rows, k)
            y = torch.empty(rows, n, dtype=torch.bfloat16, device=x.device)
            plain = int4_mod.int4_matmul_plain(x, packed, scales, True)
            planned = int4_mod.int4_w4a8_plan(rows, k, n, num_sms)
            fns, exact = {}, {}
            tilings = (int4_mod.w4a8_candidates(rows, k, n) if rows <= 192
                       else [(cols, 0) for cols in (64, 128)])
            for cols, cluster in tilings:
                def fn(cols=cols, cluster=cluster):
                    err = int4_mod._w4a8_launch(lib, x, packed, scales, y, cols, cluster,
                                                torch.cuda.current_stream().cuda_stream)
                    kernel_lib.check(err, "w4a8 sweep")
                    return y
                mark = "*" if (cols, cluster) == (planned.cols, planned.cluster) else ""
                key = (f"{cols} cols x cluster {cluster}" if cluster else f"wgmma {cols} cols") + mark
                fns[key] = fn
                exact[key] = bool(torch.equal(fn(), plain))
            eager = cs.time_in_turns(fns, inner=cs.INNER)
            out[f"{label} M={rows}"] = {key: {"ms": eager[key], "graph_ms": graph_ms(fn, cs),
                                              "bit_identical": exact[key]}
                                        for key, fn in fns.items()}
            del fns
        torch.cuda.empty_cache()
    return out


def _v1_sweep(paged_mod, served: dict, cs) -> dict:
    """Kernel 3's split kernel and merge over V1_SWEEP split counts (chunk =
    the next multiple of 64 and of the page of the table's tokens / count)
    at the served shape (both modes) and at 64 x 2,048 int8, in the same
    turns, through ``_paged_v1_launch``; the plan's own choice is marked."""
    import math

    import torch

    out = {}
    for key, args in served.items():
        qd, k_all, v_all, layer, lens_t, table_t, page_size, ks, vs = args
        batch, kv = qd.shape[0], k_all.shape[1]
        group, head_dim = qd.shape[1] // kv, qd.shape[2]
        max_tokens = table_t.shape[1] * page_size
        align = math.lcm(64, page_size)
        planned = cs.v1_split(args)
        fns, meta = {}, {}
        for count in sorted({*V1_SWEEP, planned[1]}):
            chunk = -(-(-(-max_tokens // count)) // align) * align
            n_split = -(-max_tokens // chunk)
            key_ = f"{n_split} x {chunk}"
            if key_ in fns:
                continue
            part_o = torch.empty((batch, kv, n_split, group, head_dim), dtype=torch.float32,
                                 device=qd.device)
            part_ml = torch.empty((batch, kv, n_split, group, 2), dtype=torch.float32,
                                  device=qd.device)
            fns[key_] = (lambda po=part_o, pm=part_ml, c=chunk, n=n_split:
                         paged_mod._paged_v1_launch(qd, k_all, v_all, layer, lens_t, table_t,
                                                    page_size, ks, vs, po.data_ptr(),
                                                    pm.data_ptr(), c, n, head_dim**-0.5))
            meta[key_] = {"n_split": n_split, "chunk": chunk,
                          "planned": (chunk, n_split) == planned}
        ref = paged_mod.paged_attention_stacked(*args).float()
        for key_, fn in fns.items():
            meta[key_]["max_abs_diff_vs_wrapper"] = float((fn().float() - ref).abs().max())
        times = cs.time_in_turns(fns, inner=cs.INNER)
        out[key] = {key_: {**meta[key_], "ms": times[key_]} for key_ in fns}
        del fns
        torch.cuda.empty_cache()
    return out


def _split_sweep(paged_mod, launch, shipping_q, pools, lens_t, table_t, cs,
                 plan=None) -> dict:
    """One mode of kernel 2 (``launch`` on ``pools``: K and V, then the
    scales in int8 mode): its split kernel and merge at each SWEEP split
    count, in the same turns (inner INNER), and at ``plan``'s own choice
    (default ``paged_split_plan``), which is marked."""
    import torch

    batch, max_pages = table_t.shape
    max_tokens = max_pages * pools[0].shape[2]
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = plan or paged_mod.paged_split_plan
    out = {}
    for nq, qd in shipping_q.items():
        rows = 12 // 2 * nq
        planned = plan(batch, 2, rows, 128, max_tokens, num_sms)
        fns, meta = {}, {}
        for count in sorted({*SWEEP, planned[1]}):
            chunk = -(-(-(-max_tokens // count)) // 64) * 64
            n_split = -(-max_tokens // chunk)
            part_o = torch.empty((batch, 2, n_split, rows, 128), dtype=torch.float32,
                                 device=qd.device)
            part_ml = torch.empty((batch, 2, n_split, rows, 2), dtype=torch.float32,
                                  device=qd.device)
            key = f"{n_split} x {chunk}"
            fns[key] = (lambda po=part_o, pm=part_ml, c=chunk, n=n_split:
                        launch(qd, *pools, lens_t, table_t, po, pm, c, n, 128**-0.5))
            meta[key] = {"n_split": n_split, "chunk": chunk,
                         "scratch_mb": (part_o.numel() + part_ml.numel()) * 4 / 1e6,
                         "planned": (chunk, n_split) == planned}
        scratch = torch.empty((2, batch, 2, planned[1], rows, 128), dtype=torch.float32,
                              device=qd.device)
        ref = launch(qd, *pools, lens_t, table_t, scratch[0], scratch[1, ..., :2].contiguous(),
                     *planned, 128**-0.5).float()  # what the wrapper computes
        for key, fn in fns.items():
            meta[key]["max_abs_diff_vs_wrapper"] = float((fn().float() - ref).abs().max())
        times = cs.time_in_turns(fns, inner=cs.INNER)
        out[f"nq={nq}"] = {key: {**meta[key], "ms": times[key]} for key in fns}
        del fns
        torch.cuda.empty_cache()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="root of the parent checkout (git archive)")
    parser.add_argument("--worker", help=argparse.SUPPRESS)
    parser.add_argument("--timeout", type=float, default=600.0)
    parser.add_argument("--json", help="also write the last line's object to this file")
    parser.add_argument("--only", default="",
                        help="comma-separated prefixes of the case names to time")
    parser.add_argument("--order", default="parent,change,change,parent",
                        help="the workers' trees in turn (tuning: 'change')")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false; this run needs an NVIDIA GPU")
        return 2
    if args.worker:
        only = tuple(p for p in args.only.split(",") if p)
        print(json.dumps(worker(args.worker, only)), flush=True)
        return 0
    order = args.order.split(",")
    if "parent" in order and (
            not args.parent or not os.path.isdir(os.path.join(args.parent, "dots_ocr_tpu_torch"))):
        print("kernel_ab: --parent must name a checkout holding dots_ocr_tpu_torch/")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"kernel_ab on {smi}", flush=True)
    trees = {"parent": os.path.abspath(args.parent or HERE), "change": HERE}
    runs = []
    for label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               trees[label], "--only", args.only], capture_output=True, text=True,
                              timeout=args.timeout, cwd=trees[label])
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n")
            raise RuntimeError(f"the {label} worker failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = label
        runs.append(res)
        print(f"  {label} worker done (build {res['build_s']:.1f} s)", flush=True)
    inner = _chip_smoke().INNER
    names = [name for name in runs[-1]["cases"] if all(name in r["cases"] for r in runs)]
    for name in names:
        print(f"{name}:")
        for res in runs:
            c = res["cases"][name]
            libs = "".join(
                f"; {key[:-len('_ms_inner1')]} {c[key]:.4f} / "
                f"{c[key.replace('inner1', f'inner{inner}')]:.4f}"
                for key in c if key.endswith("_ms_inner1") and not key.startswith("kernel"))
            graphs = ", ".join(f"{key[:-len('_graph_ms')]} {c[key]:.4f}" for key in c
                               if key.endswith("_graph_ms") and c[key] is not None)
            print(f"  {res['tree']:7s} kernel {c['kernel_ms_inner1']:.4f} ms (1 call) / "
                  f"{c[f'kernel_ms_inner{inner}']:.4f} ms ({inner} back to back){libs}; "
                  f"device (CUDA graph) {graphs}; "
                  f"max abs err {c['max_abs_err']:.3e}; {c['repeats_differing']} of "
                  f"{c['repeats']} repeats differ (worst err {c['worst_abs_err']:.3e}); "
                  f"{c.get('kernel_launches_per_call', float('nan')):g} device operations a call"
                  + "".join(f"\n      {k}: {v:.2f} us" for k, v in c.get("kernel_device_us", {}).items()))
    for res in runs:
        for mode, sweep in res["split_sweep"].items():
            if mode in ("int4", "w4a8", "w8a16", "w8a16_ablation", "draw", "decode_step",
                        "prefill_chunk"):
                continue
            for nq, rows in sweep.items():
                print(f"split sweep, {res['tree']} worker, {mode}, {nq}: " + ", ".join(
                    f"{key}{'*' if r['planned'] else ''} {r['ms']:.4f} ms"
                    for key, r in rows.items()))
    for res in runs:
        for shape, rows in res["split_sweep"].get("int4", {}).items():
            print(f"int4 split sweep, {res['tree']} worker, {shape}: " + ", ".join(
                f"{key} {r['ms']:.4f} / {r['graph_ms'] or float('nan'):.4f} ms"
                for key, r in rows.items()))
        for shape, rows in res["split_sweep"].get("w4a8", {}).items():
            print(f"W4A8 cluster sweep, {res['tree']} worker, {shape} (eager / device ms): "
                  + ", ".join(f"{key} {r['ms']:.4f} / {r['graph_ms'] or float('nan'):.4f}"
                              + ("" if r["bit_identical"] else " NOT bit-identical")
                              for key, r in rows.items()))
    for res in runs:
        sw = res["split_sweep"]
        for shape, rows in sw.get("w8a16", {}).items():
            print(f"W8A16 sweep (launch choices, * planned), {res['tree']} worker, "
                  f"{shape}: " + ", ".join(
                      f"{key}{'*' if r['planned'] else ''} {r['graph_ms'] or float('nan'):.4f}"
                      for key, r in sorted(rows.items(), key=lambda kv: kv[1]["graph_ms"] or 1e9)))
        if "draw" in sw:
            print(f"draw sweep (cluster ranks, * planned), {res['tree']} worker: " + ", ".join(
                f"{key}{'*' if r['planned'] else ''} {r['graph_ms'] or float('nan'):.4f}"
                for key, r in sw["draw"].items()))
        for shape, row in sw.get("w8a16_ablation", {}).items():
            print(f"W8A16 ablation (device ms), {res['tree']} worker, {shape}: " + ", ".join(
                f"{key} {round(ms, 4) if isinstance(ms, float) else ms}" for key, ms in row.items()))
        if "prefill_chunk" in sw:
            chunk = sw["prefill_chunk"]
            print(f"prefill chunk, {_chip_smoke().PREFILL_CHUNK} tokens through the flagship "
                  f"decoder, {res['tree']} worker: int8 weights {chunk['int8']:.3f} ms, bf16 "
                  f"weights {chunk['bf16']:.3f} ms")
        if "decode_step" in sw:
            step = sw["decode_step"]
            print(f"decode step, 64 slots x 2048, int8 weights, bf16 KV, {res['tree']} worker: "
                  f"nq = 1 graphed {step['graph_ms'] or float('nan'):.3f} ms, eager "
                  f"{step['eager_ms']:.3f} ms; k = 2 verify (nq = 3) graphed "
                  f"{step['verify_graph_ms'] or float('nan'):.3f} ms, eager "
                  f"{step['verify_eager_ms']:.3f} ms")
    for name, check in runs[-1].get("int4pack_check", {}).items():
        print(f"{name}: torch._weight_int4pack_mm vs cuBLAS on bf16-rounded scales: {check}")
    line = {"device": smi, "order": [r["tree"] for r in runs], "runs": runs}
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(line, f)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
