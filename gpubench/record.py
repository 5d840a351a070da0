"""What one run leaves for its metrics: the window, the engine's counters at
its edges, every request's record, and in a traced run the device trace and
the spans. The reductions that several metric readers share live here;
each reader (``metrics/<name>.py``) takes a :class:`RunRecord` and returns
a number or None (nothing to read: the metric is left out of the line).
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from types import ModuleType
from typing import Dict, List, Optional

from gpubench import work
from gpubench.loadgen import RequestSpec
from gpubench.trace import DeviceTrace, Span, image_sizes

FLASH = ("flash_fwd_kernel", "tile_info_kernel")
PAGED = ("paged_decode_split_kernel", "paged_merge_kernel")
W8A16 = ("w8a16_kernel",)


@dataclasses.dataclass
class Request:
    spec: RequestSpec
    due: float                      # monotonic s: when the loop meant to send it
    sent: float = 0.0
    done: Optional[float] = None    # its future resolved
    error: Optional[str] = None
    result: Optional[dict] = None   # the worker's reply
    # read from the program's request as it finished (monotonic s)
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    prompt_len: int = 0
    tokens: List[int] = dataclasses.field(default_factory=list)
    preempted: int = 0
    reason: Optional[str] = None

    @property
    def n_out(self) -> int:
        return len(self.tokens)


@dataclasses.dataclass
class RunRecord:
    dims: dict
    serving: dict
    mix: dict
    t0: float
    t1: float
    counters0: Dict[str, float]
    counters1: Dict[str, float]
    requests: List[Request]
    arch: ModuleType                # the configuration's arch/<arch>.py (run.load_arch)
    trace: Optional[DeviceTrace] = None
    spans: Optional[List[Span]] = None
    trace_edges: Optional[tuple] = None  # (a, b) monotonic s of the traced part

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def delta(self, key: str) -> float:
        return float(self.counters1.get(key, 0)) - float(self.counters0.get(key, 0))

    def due_in_window(self) -> List[Request]:
        return [r for r in self.requests if self.t0 <= r.due < self.t1]

    def host_part(self) -> tuple:
        """(a, b) monotonic s of the window that host-clock per-layer
        metrics read: in a traced run its part before the trace starts,
        since the trace is read inside the window and holds the host up."""
        b = self.trace_edges[0] if self.trace_edges is not None else self.t1
        return self.t0, b

    # -- decode, from the requests' records ----------------------------------------

    def decode_tokens(self, a: float, b: float):
        """(tokens, context sum) decoded in [a, b], each request's tokens
        spread evenly between its first and its last."""
        n = ctx = 0.0
        for r in self.requests:
            if r.first_token_at is None or r.finished_at is None:
                continue
            c, s = work.interval_tokens(r.first_token_at, r.finished_at, r.n_out,
                                        r.prompt_len, a, b)
            n, ctx = n + c, ctx + s
        return n, ctx

    def context_sum(self, a: float, b: float) -> float:
        """The decoding requests' contexts added up, averaged over [a, b]:
        what one decode or verify iteration there reads. A request decodes
        from its first token to its last, its context growing evenly from
        its prompt to its prompt plus its output."""
        total = 0.0
        for r in self.requests:
            if r.first_token_at is None or r.finished_at is None:
                continue
            lo, hi = max(a, r.first_token_at), min(b, r.finished_at)
            if hi <= lo:
                continue
            span = r.finished_at - r.first_token_at
            rate = (r.n_out - 1) / span if span > 0 else 0.0
            grown = rate * ((hi - r.first_token_at) ** 2 - (lo - r.first_token_at) ** 2) / 2.0
            total += (hi - lo) * (r.prompt_len + 1) + grown
        return total / (b - a) if b > a else 0.0

    def active_rows(self, a: float, b: float) -> float:
        """Mean number of requests decoding over [a, b]."""
        busy = 0.0
        for r in self.requests:
            if r.first_token_at is None or r.finished_at is None:
                continue
            busy += max(0.0, min(b, r.finished_at) - max(a, r.first_token_at))
        return busy / (b - a) if b > a else 0.0

    def rows_per_iteration_query(self) -> float:
        """Query rows a decode iteration runs per active request: 1, or
        k + 1 in the share of slot-iterations that verify."""
        gen = self.delta("generated_tokens")
        total = gen - self.delta("spec_emitted") + self.delta("spec_slot_iters")
        if total <= 0:
            return 1.0
        k = int(self.serving.get("SPECULATE_K", 0))
        return 1.0 + k * self.delta("spec_slot_iters") / total

    # -- model FLOPs over the window ---------------------------------------------

    def model_flops(self, a: float, b: float) -> float:
        """Encoded pages and prompts of requests admitted in [a, b], and
        tokens decoded in it."""
        total = 0.0
        for r in self.requests:
            if r.admitted_at is not None and a <= r.admitted_at < b:
                total += self.arch.vision_flops(r.spec.patches, self.dims)
                total += self.arch.prompt_flops(r.prompt_len, self.dims)
        n, ctx = self.decode_tokens(a, b)
        return total + self.arch.generated_flops(n, ctx, self.dims)

    # -- kernel bounds over the traced part --------------------------------------

    def span_work(self, span: Span) -> Dict[str, float]:
        """Seconds of bound a span's kernel-1 launches and prefill linears
        carry (operations at the bf16 peak or bytes at HBM speed, a launch
        at a time)."""
        d = self.dims
        v_layers, d_layers = d["vision"]["num_layers"], d["decoder"]["num_layers"]
        flash = lin = 0.0
        seg = span.args.get("segment_ids")
        if seg is not None:
            ops, nbytes = work.flash_image_bound(image_sizes(seg), int(seg.shape[-1]), d)
            flash += v_layers * work.bound_s(ops, nbytes)
        if span.name == "prefill_extend_program":
            b, chunk = span.args["rows"]
            off, kv_hi = span.args["q_offset"], span.args["kv_hi"]
            plens = [int(x) for x in span.args["prompt_len"].tolist()]
            rows = [(max(0, min(chunk, p - off)), p) for p in plens]
            ops, nbytes = work.flash_causal_bound(rows, off, chunk, kv_hi, d)
            flash += d_layers * work.bound_s(ops, nbytes)
            lin += self._prefill_linears(sum(v for v, _ in rows), b)
        elif span.name == "prefill_program":
            b, t = span.args["rows"]
            lens = [int(x) for x in span.args["seq_lens"].tolist()]
            ops, nbytes = work.flash_causal_bound([(p, p) for p in lens], 0, t, t, d)
            flash += d_layers * work.bound_s(ops, nbytes)
            lin += self._prefill_linears(sum(lens), b)
        return {"flash": flash, "w8a16": lin}

    def _prefill_linears(self, rows: int, heads: int) -> float:
        d = self.dims
        ops, nbytes = work.w8a16_prefill_bound(rows, d, self.arch.decoder_linear_shapes(d))
        c = d["decoder"]
        ops += 2.0 * heads * c["vocab_size"] * c["hidden_size"]
        nbytes += c["vocab_size"] * (c["hidden_size"] + 4)
        return work.bound_s(ops, nbytes)

    def traced_span_bound(self, kind: str) -> Optional[float]:
        if self.trace is None or self.spans is None:
            return None
        return sum(self.trace.overlap(s) * self.span_work(s)[kind] for s in self.spans)

    def decode_iterations(self) -> Optional[float]:
        """Decode and verify iterations in the trace: kernel 2 launches once
        a layer an iteration."""
        if self.trace is None:
            return None
        n, _ = self.trace.by_name(PAGED[0])
        return n / self.dims["decoder"]["num_layers"]


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank ``q``-th percentile."""
    if not values:
        return None
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None

