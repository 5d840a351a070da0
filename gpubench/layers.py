"""The metric readers, one per quantity; ``metrics/<name>.py`` names which
one a metric takes. Each takes a ``record.RunRecord`` and returns a number,
or None where the run left nothing to read.
"""

from __future__ import annotations

from typing import Optional

from gpubench import work
from gpubench.record import FLASH, PAGED, W8A16, median, percentile


# -- end to end ------------------------------------------------------------------

def tok_s(run) -> Optional[float]:
    """Output tokens that landed in the window over its seconds: the
    engine's decoded tokens plus its first tokens."""
    n = run.delta("generated_tokens") + run.delta("prefills")
    return n / run.seconds if run.seconds > 0 else None


def _given_up(run) -> float:
    return max((r.done for r in run.requests if r.done is not None), default=run.t1)


def ttft_ms(run) -> list:
    """Due time to first token of every request due in the window; one that
    never got a token counts until the run gave up on it."""
    out = []
    for r in run.due_in_window():
        got = r.first_token_at if r.first_token_at is not None else _given_up(run)
        out.append((got - r.due) * 1e3)
    return out


def e2e_ms(run) -> list:
    """Due time to last token of every request due in the window, counted
    as :func:`ttft_ms` counts."""
    return [((r.finished_at if r.finished_at is not None else _given_up(run)) - r.due) * 1e3
            for r in run.due_in_window()]


def ttft_p95_ms(run) -> Optional[float]:
    return percentile(ttft_ms(run), 95)


def ttft_p95_host_part_ms(run) -> Optional[float]:
    """:func:`ttft_p95_ms` of the requests due in ``RunRecord.host_part()``
    (in a traced run, before the trace starts: reading it holds the host)."""
    a, b = run.host_part()
    return percentile([ms for r, ms in zip(run.due_in_window(), ttft_ms(run))
                       if a <= r.due < b], 95)


# -- engine and scheduler ----------------------------------------------------------

def queue_ms(run) -> Optional[float]:
    """Median from ``EngineWorker.submit`` to the program's admission stamp:
    the prep pool, the worker's queue and the scheduler's wait. (The
    program's own ``timing()["queue_ms"]`` starts at the engine thread's
    submit, after the worker's queue, and reads ~0.1 ms here.)"""
    a, b = run.host_part()
    return median([(r.admitted_at - r.sent) * 1e3 for r in run.requests
                   if a <= r.due < b and r.admitted_at is not None])


def spec_tokens_per_iter(run) -> Optional[float]:
    iters = run.delta("spec_slot_iters")
    return run.delta("spec_emitted") / iters if iters > 0 else None


def preemptions(run) -> Optional[float]:
    return run.delta("preemptions")


# -- model step and device -------------------------------------------------------------

def mfu(run) -> Optional[float]:
    """Model FLOPs of the window's work over its seconds at the bf16 peak
    (in a traced run, of its part before the trace)."""
    a, b = run.host_part()
    if b <= a:
        return None
    return 100.0 * run.model_flops(a, b) / (b - a) / work.PEAK_OPS_PER_S["bf16"]


def idle_share(run) -> Optional[float]:
    t = run.trace
    if t is None or t.window_s <= 0 or not t.kernels:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


# -- kernels -----------------------------------------------------------------------------

def paged_attn_roofline(run) -> Optional[float]:
    """Kernel 2: each decode or verify iteration in the trace (its launches,
    one a layer) reads every decoding request's K and V once; their contexts
    from the requests' records."""
    if run.trace is None:
        return None
    n, device_s = run.trace.by_name(*PAGED)
    if n == 0:
        return None
    per_iteration = run.context_sum(*run.trace_edges) * run.arch.kv_bytes_per_token(
        run.dims, run.serving["KV_DTYPE"])
    return work.share(run.decode_iterations() * per_iteration / work.HBM_BYTES_PER_S, device_s)


def w8a16_roofline(run) -> Optional[float]:
    """W8A16: every decode or verify iteration reads the int8 decoder and
    lm_head once; each prefill chunk in the trace is bound by its rows."""
    if run.trace is None:
        return None
    n, device_s = run.trace.by_name(*W8A16)
    if n == 0:
        return None
    a, b = run.trace_edges
    rows = run.active_rows(a, b) * run.rows_per_iteration_query()
    ops, nbytes = work.w8a16_decode_bound(rows, run.dims,
                                          run.arch.decoder_linear_shapes(run.dims))
    bound = run.decode_iterations() * work.bound_s(ops, nbytes) + run.traced_span_bound("w8a16")
    return work.share(bound, device_s)


def flash_roofline(run) -> Optional[float]:
    """Kernel 1: the encoder's image-wide calls and the prefill's causal
    ones in the trace, from the spans' shapes."""
    if run.trace is None or not run.spans:
        return None
    n, device_s = run.trace.by_name(*FLASH)
    if n == 0:
        return None
    return work.share(run.traced_span_bound("flash"), device_s)
