#!/usr/bin/env python3
"""Kernel 1 and kernel 2's bf16 mode of two checkouts, timed the same way
in one run on one GPU, and kernel 2's split count swept.

    mkdir -p _archive/parent && git archive <parent commit> | tar -x -C _archive/parent
    python3 kernel_ab.py --parent _archive/parent

Runs one worker process per tree, in the order parent, this checkout,
this checkout, parent. Each worker imports ``dots_ocr_tpu_torch`` from its
tree (building that tree's kernels), makes the same inputs from the same
seeds on the card, and times, through the public wrappers a caller uses,
``flash_attention`` at chip_smoke.py's four shapes and
``paged_attention_multiquery_bf16`` at its three: per call as single calls
(inner 1) and as back-to-back calls (inner INNER, chip_smoke.py's
method), median of REPS samples taken in turns with, at the flash shapes,
one SDPA call (the same in every worker: a yardstick of the card). Each
output's max abs error against its tree's plain version is kept, and
REPEATS more calls on the same inputs are compared with the first bit for
bit: the count that differ shows a race.

The worker of this checkout also times kernel 2's bf16 split kernel and
merge at the shipping geometry (64 slots, lengths 0..12k, table width
320 x page 128) at nq = 1 and 3 over SWEEP split counts, in the same
turns, through ``_paged_bf16_launch``.

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
# Calls per case after the first, each compared with it bit for bit.
REPEATS = 200


def _chip_smoke():
    """This checkout's chip_smoke.py as a module (its helpers and shapes)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE,
                                                                             "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str) -> dict:
    """Time the tree at ``root``'s kernels 1 and 2 (bf16) at the shapes."""
    import numpy as np
    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import dots_ocr_tpu_torch
    from dots_ocr_tpu_torch.ops import kernel_lib
    from dots_ocr_tpu_torch.ops import paged_attention as paged_mod
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention
    from dots_ocr_tpu_torch.ops.flash_attention import flash_attention_reference as flash_plain

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

    cases = {}

    def case(name, kernel_fn, plain_fn, library_fn=None):
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
        fns = {"kernel": kernel_fn}
        if library_fn is not None:
            fns["sdpa"] = library_fn
        res = {"max_abs_err": err, "repeats": REPEATS, "repeats_differing": differ,
               "worst_abs_err": worst}
        for inner in (1, cs.INNER):
            res.update({f"{key}_ms_inner{inner}": ms
                        for key, ms in cs.time_in_turns(fns, inner=inner).items()})
        cases[name] = res
        torch.cuda.empty_cache()

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
    del q, k, v, flat

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
    sweep = {}
    if hasattr(paged_mod, "_paged_bf16_launch"):
        sweep = _split_sweep(paged_mod, shipping_q, kp, vp, lens_t, table_t, cs)
    del kp, vp
    rng = np.random.RandomState(1)
    kp, vp, lens_t, table_t = cs._paged_pool(randn, rng, np.full(cs.MAX_SLOTS, cs.V1_CONTEXT),
                                             128, 128, cs.V1_CONTEXT // 128)
    qd = randn(cs.MAX_SLOTS, 1, 12, 128)
    case("paged bf16 nq=1 64 x 2048 page 128",
         lambda: kernel2(qd, kp, vp, lens_t, table_t),
         lambda: paged_plain(qd, kp, vp, lens_t, table_t))
    return {"root": root, "build_s": build_s, "cases": cases, "split_sweep": sweep}


def _split_sweep(paged_mod, shipping_q, kp, vp, lens_t, table_t, cs) -> dict:
    """Kernel 2's bf16 split kernel and merge at each SWEEP split count, in
    the same turns (inner INNER); the plan's own choice marked."""
    import torch

    batch, max_pages = table_t.shape
    max_tokens = max_pages * kp.shape[2]
    num_sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for nq, qd in shipping_q.items():
        rows = 12 // 2 * nq
        planned = paged_mod.paged_split_plan(batch, 2, rows, 128, max_tokens, num_sms)
        fns, meta = {}, {}
        for count in SWEEP:
            chunk = -(-(-(-max_tokens // count)) // 64) * 64
            n_split = -(-max_tokens // chunk)
            part_o = torch.empty((batch, 2, n_split, rows, 128), dtype=torch.float32,
                                 device=qd.device)
            part_ml = torch.empty((batch, 2, n_split, rows, 2), dtype=torch.float32,
                                  device=qd.device)
            key = f"{n_split} x {chunk}"
            fns[key] = (lambda po=part_o, pm=part_ml, c=chunk, n=n_split:
                        paged_mod._paged_bf16_launch(qd, kp, vp, lens_t, table_t, po, pm, c, n,
                                                     128**-0.5))
            meta[key] = {"n_split": n_split, "chunk": chunk,
                         "scratch_mb": (part_o.numel() + part_ml.numel()) * 4 / 1e6,
                         "planned": (chunk, n_split) == planned}
        ref = paged_mod.paged_attention_multiquery_bf16(qd, kp, vp, lens_t, table_t).float()
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
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: torch.cuda.is_available() is false; this run needs an NVIDIA GPU")
        return 2
    if args.worker:
        print(json.dumps(worker(args.worker)), flush=True)
        return 0
    if not args.parent or not os.path.isdir(os.path.join(args.parent, "dots_ocr_tpu_torch")):
        print("kernel_ab: --parent must name a checkout holding dots_ocr_tpu_torch/")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"kernel_ab on {smi}", flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": HERE}
    runs = []
    for label in ("parent", "change", "change", "parent"):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               trees[label]], capture_output=True, text=True,
                              timeout=args.timeout, cwd=trees[label])
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n")
            raise RuntimeError(f"the {label} worker failed ({proc.returncode})")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["tree"] = label
        runs.append(res)
        print(f"  {label} worker done (build {res['build_s']:.1f} s)", flush=True)
    inner = _chip_smoke().INNER
    for name in runs[0]["cases"]:
        print(f"{name}:")
        for res in runs:
            c = res["cases"][name]
            sdpa = (f"; sdpa {c['sdpa_ms_inner1']:.3f} / {c[f'sdpa_ms_inner{inner}']:.3f}"
                    if "sdpa_ms_inner1" in c else "")
            print(f"  {res['tree']:7s} kernel {c['kernel_ms_inner1']:.3f} ms (1 call) / "
                  f"{c[f'kernel_ms_inner{inner}']:.3f} ms ({inner} back to back){sdpa}; "
                  f"max abs err {c['max_abs_err']:.3e}; {c['repeats_differing']} of "
                  f"{c['repeats']} repeats differ (worst err {c['worst_abs_err']:.3e})")
    for res in runs:
        for nq, rows in res["split_sweep"].items():
            print(f"split sweep, {res['tree']} worker, {nq}: " + ", ".join(
                f"{key}{'*' if r['planned'] else ''} {r['ms']:.3f} ms" for key, r in rows.items()))
    line = {"device": smi, "order": [r["tree"] for r in runs], "runs": runs}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
