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

``--only`` takes comma-separated prefixes of case names (and "sweep int4",
"sweep w4a8", "sweep paged") and times only those: a tuning run's way to
spend less card time.

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
        res["kernel_device_us"] = device_breakdown(kernel_fn)
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
    return {"root": root, "build_s": build_s, "cases": cases, "split_sweep": sweep,
            "int4pack_check": int4_checks}


def device_breakdown(fn, calls: int = 20) -> dict:
    """Device microseconds per call of each CUDA kernel that ``fn`` launches
    (torch.profiler's CUDA activity over ``calls`` calls, after one warm
    call); {} where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        if us and evt.count >= calls:
            out[evt.key[:60]] = us / calls
    return out


def graph_ms(fn, cs, calls: int = 10):
    """Device ms per call of ``fn``: CALLS calls captured in a CUDA graph,
    the replay timed with CUDA events (median of REPS), so the wrapper's
    host time is not in it; None where the calls cannot be captured."""
    import statistics

    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        return statistics.median(cs.cuda_ms(graph.replay) / calls for _ in range(cs.REPS))
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
                  f"{c['repeats']} repeats differ (worst err {c['worst_abs_err']:.3e})"
                  + "".join(f"\n      {k}: {v:.2f} us" for k, v in c.get("kernel_device_us", {}).items()))
    for res in runs:
        for mode, sweep in res["split_sweep"].items():
            if mode in ("int4", "w4a8"):
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
