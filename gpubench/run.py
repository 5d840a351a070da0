"""Run one benchmark cell once on the card and print its result line.

    python3 -m gpubench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json``), the architecture it names
(``arch/<arch>.py``), its traffic mix (``traffic/<traffic>.json``, read by
``loadgen.py``), its limits (``cells/<workload>.json``) and each metric's
reader (``metrics/<metric>.py``). The system under test is
``dots_ocr_tpu_torch`` driven through
``serve/async_engine.py::EngineWorker.submit``, the entry the OpenAI server
hands every request to. See README.md.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import faulthandler  # noqa: E402
import functools  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import queue  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "dots_ocr_tpu")
TRACE_SECONDS = 2.0      # the traced part, read while the window runs on
TRACE_AT = 0.7           # where in the window the traced part starts (share)
POLL_S = 0.05            # how often the window reads the KV pool's pages in use
RAMP_LIMIT_S = 240.0     # a closed loop that does not fill in this long fails
LATE_LIMIT_S = 60.0      # how long replies due in the window are waited for

RUN_LIMIT_S = 330.0      # a run that has not ended this long after its window opened is dumped

# What every ``arch/<arch>.py`` defines (README.md says what each returns).
CONTRACT = ("program_config", "serve_params", "make_weights", "prompt_ids", "served_gaps",
            "vision_flops", "prompt_flops", "generated_flops", "kv_bytes_per_token",
            "decoder_linear_shapes")


def stage(msg: str) -> None:
    """A timestamped progress line on standard error."""
    print(f"gpubench [{time.perf_counter() - T_START:8.2f} s] {msg}", file=sys.stderr, flush=True)


def cache_dirs(root: str = ROOT) -> None:
    """Kernel and compiler caches at fixed paths inside the checkout (the
    program builds its CUDA kernels into ``dots_ocr_tpu_torch/csrc/build``)."""
    base = os.path.join(root, ".cache", "gpubench")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "nv")


# -- the benchmark's data, by name -------------------------------------------------

def load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with the files it names."""

    def __init__(self, workload: str, root: str = ROOT, here: Optional[str] = None,
                 arch_root: str = ROOT):
        """``root`` holds BENCHMARK.json and the files it names; ``here`` the
        ``traffic/`` and ``cells/`` folders (``root/gpubench``);
        ``arch_root`` the ``gpubench/arch/`` folder."""
        self.root = root
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = load_json(os.path.join(root, self.config_entry["file"]))
        here = here or os.path.join(root, "gpubench")
        self.mix = load_json(os.path.join(here, "traffic", self.workload["traffic"] + ".json"))
        self.limits = load_json(os.path.join(here, "cells", workload + ".json"))
        self.arch = load_arch(self.config["arch"], arch_root)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def metrics(self, section: str) -> List[dict]:
        """The section's metrics this cell reports."""
        return [m for m in self.bench[section]
                if "workloads" not in m or self.name in m["workloads"]]


def reader(name: str, root: str = ROOT) -> Callable:
    """``metrics/<name>.py``'s ``read(record)``."""
    path = os.path.join(root, "gpubench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_arch(name: str, root: str = ROOT):
    """``arch/<name>.py``: the functions of the contract (``CONTRACT``) for
    one architecture, loaded by its path as ``reader`` loads a metric."""
    path = os.path.join(root, "gpubench", "arch", name + ".py")
    if not os.path.isfile(path):
        raise SystemExit(f"gpubench: the configuration's arch {name!r} has no module: "
                         f"{path} is missing")
    spec = importlib.util.spec_from_file_location(f"gpubench_arch_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [f for f in CONTRACT if not callable(getattr(module, f, None))]
    if missing:
        raise SystemExit(f"gpubench: {path} lacks {', '.join(missing)}")
    return module


# -- the system under test -------------------------------------------------------------

def build_engine(cell: Cell, weights: dict, device, quantize: str, vision_quantize: str):
    """The program's engine over the benchmark's weights, with the serving
    keys of the cell's configuration; ``quantize`` is its decoder's weight
    precision and ``vision_quantize`` its vision tower's, as the
    architecture's ``serve_params`` takes them."""
    from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig

    s, dims = cell.config["serving"], cell.config["model"]
    params = cell.arch.serve_params(weights, dims, quantize, vision_quantize)
    sched = SchedulerConfig(
        num_pages=int(s["NUM_PAGES"]), page_size=int(s["PAGE_SIZE"]),
        max_slots=int(s["MAX_SLOTS"]), steps_per_sync=int(s["STEPS_PER_SYNC"]),
        max_pages_per_seq=max(2, -(-int(s["MAX_SEQ_TOKENS"]) // int(s["PAGE_SIZE"]))),
        prefill_chunk_tokens=int(s["PREFILL_CHUNK"]), speculate_k=int(s["SPECULATE_K"]),
        spec_min_tokens_per_iter=float(s["SPEC_MIN_TOKENS_PER_ITER"]),
        kv_cache_dtype=s["KV_DTYPE"],
        repetition_min_repeats=8 if s["REPETITION_GUARD"] else 0,
    )
    return ContinuousBatchingEngine(params, cell.arch.program_config(dims), device, sched=sched)


def page_bytes(cell: Cell) -> int:
    """Bytes of one KV page of the cell's pool."""
    s = cell.config["serving"]
    return int(s["PAGE_SIZE"]) * cell.arch.kv_bytes_per_token(cell.config["model"], s["KV_DTYPE"])


def make_worker(engine, records: Dict[int, object]):
    """An EngineWorker that, as each request resolves, keeps what the
    program served it and when (the ids and stamps of its request)."""
    from dots_ocr_tpu_torch.serve.async_engine import EngineWorker

    class Worker(EngineWorker):
        def _resolve(self, req) -> None:
            sub = self._futures.get(req.req_id)
            rec = records.get(id(sub)) if sub is not None else None
            if rec is not None:
                rec.admitted_at, rec.first_token_at = req.admitted_at, req.first_token_at
                rec.finished_at, rec.reason = req.finished_at, req.finished_reason
                rec.tokens = list(req.prior_output) + list(req.output_ids)
                rec.prompt_len = len(req.prompt_ids) - len(req.prior_output)
                rec.preempted = req.preempted
            super()._resolve(req)

    return Worker(engine, prep_workers=1)


# -- the load -----------------------------------------------------------------------------

class Load:
    """Sends the mix's requests to the worker from one thread: a closed loop
    of callers, or an open loop on the mix's arrival schedule."""

    def __init__(self, worker, traffic, mix: dict, records: Dict[int, object]):
        from PIL import Image

        from gpubench.record import Request

        self._Image, self._Request = Image, Request
        self.worker, self.traffic, self.mix, self.records = worker, traffic, mix, records
        self.requests: List = []
        self.subs: List = []
        self.stop = threading.Event()
        self._done: "queue.Queue[int]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self.late_s: List[float] = []

    def send(self, spec, due: float, caller: int = -1):
        from dots_ocr_tpu_torch.serve.async_engine import Submission

        image = self._Image.fromarray(self.traffic.pixels(spec))
        rec = self._Request(spec=spec, due=due)
        sub = Submission(prompt=self.mix["prompt"], images=[image],
                         max_new_tokens=spec.max_new_tokens, temperature=spec.temperature,
                         top_p=spec.top_p, system_prompt=None, seed=spec.seed)
        self.records[id(sub)] = rec
        self.requests.append(rec)
        self.subs.append(sub)

        def done(fut, rec=rec):
            rec.done = time.monotonic()
            exc = fut.exception()
            if exc is None:
                rec.result = fut.result()
            else:
                rec.error = str(exc) or type(exc).__name__
            self._done.put(caller)

        sub.future.add_done_callback(done)
        rec.sent = time.monotonic()
        if due > 0:
            self.late_s.append(rec.sent - due)
        self.worker.submit(sub)
        return rec

    def start_closed(self) -> None:
        callers = int(self.mix["callers"])
        for i in range(callers):
            self.send(self.traffic.request(i, first_of_caller=True), 0.0, caller=i)
        self._next = callers
        self._thread = threading.Thread(target=self._closed, daemon=True)
        self._thread.start()

    def _closed(self) -> None:
        while not self.stop.is_set():
            try:
                caller = self._done.get(timeout=0.05)
            except queue.Empty:
                continue
            if caller < 0 or self.stop.is_set():
                continue
            self.send(self.traffic.request(self._next), 0.0, caller=caller)
            self._next += 1

    def start_open(self, t0: float, seconds: float) -> None:
        from gpubench.loadgen import max_requests

        gaps = self.traffic.gaps(max_requests(self.mix, seconds))
        self._thread = threading.Thread(target=self._open, args=(t0, seconds, gaps), daemon=True)
        self._thread.start()

    def _open(self, t0: float, seconds: float, gaps: List[float]) -> None:
        due = t0
        for i, gap in enumerate(gaps):
            due += gap
            if due >= t0 + seconds:
                return
            while True:
                wait = due - time.monotonic()
                if self.stop.is_set():
                    return
                if wait <= 0:
                    break
                time.sleep(min(wait, 0.05))
            self.send(self.traffic.request(i), due)

    def halt(self) -> None:
        self.stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)


class PoolWatch:
    """The most KV pages in use at once, read from the program's page
    allocator while the main thread waits out the window."""

    def __init__(self, engine):
        self.alloc = getattr(engine, "allocator", None)
        self.peak = 0

    def read(self) -> None:
        if self.alloc is not None:
            self.peak = max(self.peak, self.alloc.num_pages - 1 - self.alloc.free_pages)

    def sleep_until(self, deadline: float) -> None:
        while True:
            self.read()
            wait = deadline - time.monotonic()
            if wait <= 0:
                return
            time.sleep(min(wait, POLL_S))


# -- one run ------------------------------------------------------------------------------

def weight_seed(seed: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % 2**63


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             control: Optional[Dict[str, str]] = None, check: bool = True) -> dict:
    """Set up, measure for ``seconds``, reduce and check. ``control``
    replaces serving keys of the configuration (QUANTIZE, VISION_QUANTIZE:
    the control's lower precision); the check holds the served tokens to the
    reference at the configuration's own."""
    import torch

    from dots_ocr_tpu_torch.engine import scheduler as program_scheduler
    from gpubench import check as checking
    from gpubench.loadgen import Traffic
    from gpubench.record import RunRecord
    from gpubench.trace import DeviceTrace, Spans

    device = torch.device(device)
    cfg, mix, dims = cell.config, cell.mix, cell.config["model"]
    serving = cfg["serving"]
    dtype = getattr(torch, dims["dtype"])
    on_card = device.type == "cuda"
    if on_card:
        from dots_ocr_tpu_torch.ops import kernel_lib

        torch.cuda.reset_peak_memory_stats(device)
        kernel_lib.load()
    stage("kernels loaded")
    spans = Spans(program_scheduler, device) if traced else None
    trace = DeviceTrace(device) if traced and on_card else None
    weights = cell.arch.make_weights(dims, weight_seed(seed), device, dtype,
                                     cell.config.get("weights"))
    run_keys = dict(serving, **(control or {}))
    engine = build_engine(cell, weights, device, run_keys["QUANTIZE"], run_keys["VISION_QUANTIZE"])
    del weights
    engine.warmup_decode(nucleus_variants=(False,) if float(mix["top_p"]) >= 1.0
                         else (False, True))
    if trace is not None:
        trace.warm()
    stage("engine built, graphs captured")
    records: Dict[int, object] = {}
    worker = make_worker(engine, records)
    traffic = Traffic(mix, seed, dims)
    load = Load(worker, traffic, mix, records)
    try:
        warm = [load.send(spec, 0.0) for spec in traffic.warmup()]
        _wait(warm, RAMP_LIMIT_S)
        load.requests.clear()
        if spans is not None:
            spans.__enter__()
        if mix["loop"] == "closed":
            load.start_closed()
            base = engine.metrics["prefills"]
            t_ramp = time.monotonic()
            while engine.metrics["prefills"] - base < int(mix["callers"]):
                if time.monotonic() - t_ramp > RAMP_LIMIT_S:
                    raise RuntimeError("the closed loop did not fill")
                time.sleep(0.005)
            ramp_s = time.monotonic() - t_ramp
        else:
            ramp_s = 0.0
        t0 = time.monotonic()
        c0 = dict(engine.metrics)
        setup_s = time.perf_counter() - T_START
        if on_card:
            faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
        stage(f"window opens (ramp {ramp_s:.2f} s)")
        if mix["loop"] == "open":
            load.start_open(t0, seconds)
        pool = PoolWatch(engine)
        edges = None
        if trace is not None:
            # inside the window, so that reading the trace adds nothing after it
            pool.sleep_until(t0 + min(TRACE_AT * seconds, max(0.0, seconds - TRACE_SECONDS)))
            trace.start()
            begin = time.monotonic()
            stage("trace starts")
            pool.sleep_until(min(begin + TRACE_SECONDS, t0 + seconds))
            trace.stop()
            edges = (begin, trace.stopped_at)
            stage(f"trace read: {len(trace.kernels)} device records")
        pool.sleep_until(t0 + seconds)
        t1 = time.monotonic()
        c1 = dict(engine.metrics)
        gate_open = getattr(engine, "_spec_enabled", None)
        stage("window closes")
        load.halt()
        if mix["loop"] == "open":
            _wait([r for r in load.requests if t0 <= r.due < t1], LATE_LIMIT_S)
        peak = torch.cuda.max_memory_reserved(device) if on_card else 0
        for sub in load.subs:
            if not sub.future.done():
                worker.cancel(sub)
        _wait(load.requests, LATE_LIMIT_S)
        totals = dict(engine.metrics)
        stage("every request resolved")
    finally:
        if spans is not None:
            spans.__exit__(None, None, None)
        load.halt()
        worker.shutdown()
    record = RunRecord(dims=dims, serving=serving, mix=mix, t0=t0, t1=t1, counters0=c0,
                       counters1=c1, requests=load.requests + warm, arch=cell.arch, trace=trace,
                       spans=spans.records if spans is not None else None, trace_edges=edges)
    section = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell.metrics(section):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    window_requests = [r for r in load.requests if r.sent >= t0 or t0 <= r.due < t1]
    if mix["loop"] == "open":
        from gpubench.layers import e2e_ms, ttft_ms
        from gpubench.record import percentile

        ttft, e2e = ttft_ms(record), e2e_ms(record)
        tails = {f"{name}_p{q}_ms": percentile(values, q)
                 for name, values in (("ttft", ttft), ("e2e", e2e)) for q in (50, 90, 95, 99)}
    else:
        tails = {}
    from gpubench.layers import spec_tokens_per_iter

    page = page_bytes(cell)
    out = {
        "correct": False,
        "attempted": len(window_requests),
        "failed": sum(1 for r in window_requests
                      if r.error is not None and r.error != "cancelled"),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)},
        "info": {"ramp_s": ramp_s, "window_s": t1 - t0, "seed": seed,
                 "quantize": run_keys["QUANTIZE"], "vision_quantize": run_keys["VISION_QUANTIZE"],
                 "late_max_s": max(load.late_s) if load.late_s else 0.0, **tails,
                 # the speculation gate: shut in the window, open as it closed
                 "spec_gate": {"shut_in_window": record.delta("spec_auto_disabled"),
                               "open_at_close": gate_open,
                               "tokens_per_iter": spec_tokens_per_iter(record)},
                 # KV memory: the reserved pool, and what the traffic held of it
                 "kv_pool_bytes": int(serving["NUM_PAGES"]) * page,
                 "kv_pages_peak": pool.peak, "kv_live_peak_bytes": pool.peak * page,
                 "counters": {k: totals.get(k, 0) - 0 for k in (
                     "generated_tokens", "prefills", "prefill_chunks", "steps", "spec_emitted",
                     "spec_slot_iters", "spec_auto_disabled", "preemptions", "graph_captures",
                     "graph_replays")}},
    }
    if trace is not None:
        out["device"]["busy_s"] = trace.busy_s()
        out["device"]["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    del engine, worker, load

    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    out["record"] = record
    stage("metrics reduced")
    if check:
        checked, facts = checking.check(cell, record, totals, seed, device, dtype)
        # nothing is captured or built inside the window
        checked["window_graph_captures"] = {
            "value": record.delta("graph_captures"), "limit": 0}
        out["correct"] = all(c["value"] is not None and c["value"] <= c["limit"]
                             for c in checked.values())
        out["info"].update(facts)
        out["checked"] = checked
        stage("reference compared")
    if on_card:
        faulthandler.cancel_dump_traceback_later()
    return out


def _wait(requests, limit_s: float) -> None:
    end = time.monotonic() + limit_s
    for r in requests:
        while r.done is None and time.monotonic() < end:
            time.sleep(0.01)


@functools.lru_cache(maxsize=None)
def power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def emit(out: dict) -> None:
    """The result line: the contract's keys, ``checked`` last."""
    checked = out.pop("checked", {})
    for name, c in checked.items():
        print(f"checked {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    out["checked"] = checked
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_dirs()
    os.environ.setdefault("USE_FLAX", "0")
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell.workload["chips"]):
        print(f"gpubench: {cell.name} needs {cell.workload['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"gpubench: {cell.name} seed {args.seed}; card: {power_limit()}", file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    out.pop("record")
    out["device"]["power_limit"] = power_limit()
    bad = forbidden_modules()
    if bad:
        print(f"gpubench: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
