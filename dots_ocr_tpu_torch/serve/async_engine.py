"""Bridges the serving front end to the continuous-batching scheduler.

A single engine thread owns all device interaction (the scheduler is
single-threaded by design — SURVEY.md §5.2 notes the reference's lock-free
thread soup and deliberately replaces it with one event loop + queues):
HTTP handlers enqueue (request, future) pairs; the engine thread drains the
queue, submits into the scheduler, steps it while work remains, and
resolves futures as requests finish.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)


@dataclass
class Submission:
    prompt: str
    images: Sequence
    max_new_tokens: Optional[int]
    temperature: float
    top_p: float
    system_prompt: Optional[str]
    future: Future = field(default_factory=Future)
    min_pixels: Optional[int] = None
    max_pixels: Optional[int] = None
    # vLLM-parity stop conditions (OpenAI `stop` / `stop_token_ids`).
    stop: Sequence[str] = ()
    stop_token_ids: Sequence[int] = ()
    # OpenAI `seed`: per-request sampled-stream reproducibility.
    seed: Optional[int] = None
    # OpenAI `logprobs`: chosen-token raw-model logprobs per position.
    logprobs: bool = False
    # OpenAI presence/frequency penalties (vLLM semantics).
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # OpenAI logit_bias: {token_id: bias}.
    logit_bias: Optional[dict] = None
    # SSE streaming: called from the ENGINE thread with
    # (text_delta, finish_reason|None); the HTTP layer must trampoline into
    # its own event loop (e.g. loop.call_soon_threadsafe).
    stream_cb: Optional[object] = None
    # Filled by the preprocessing pool before the engine thread sees the
    # submission (tokenization + image patching off the stepping thread).
    prepared: Optional[object] = None
    # Set by cancel() — checked before the engine ever sees the submission
    # (a streaming client can disconnect while preprocessing is in flight).
    cancelled: bool = False


class EngineWorker:
    """Engine thread around a ContinuousBatchingEngine."""

    def __init__(self, engine, prep_workers: int = 1):
        self.engine = engine
        self._queue: "queue.Queue[Submission]" = queue.Queue()
        self._cancels: "queue.Queue[Submission]" = queue.Queue()
        self._futures: Dict[int, Submission] = {}
        self._stop = threading.Event()
        # Tokenization + image preprocessing run off the ENGINE thread so a
        # ~140 ms/page patcher never stalls device stepping (decode p99
        # during admission bursts). ONE worker by default: measured A/B
        # showed concurrent preps contend (allocator/bandwidth — 8 pages:
        # 3.4 s on 4 threads vs 1.1 s serial), so parallel prep loses;
        # off-thread serial prep keeps the overlap without the contention.
        self._prep_pool = (
            ThreadPoolExecutor(
                max_workers=prep_workers, thread_name_prefix="prep"
            )
            if prep_workers > 0 and hasattr(engine, "prepare")
            else None
        )
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, submission: Submission) -> Future:
        if self._prep_pool is not None and submission.prepared is None:
            self._prep_pool.submit(self._prep_and_enqueue, submission)
        else:
            self._queue.put(submission)
        return submission.future

    def _prep_and_enqueue(self, sub: Submission) -> None:
        if sub.cancelled:  # client gone while queued for preprocessing
            self._fail(sub, RuntimeError("cancelled"))
            return
        try:
            sub.prepared = self.engine.prepare(
                sub.prompt,
                sub.images,
                system_prompt=sub.system_prompt,
                min_pixels=sub.min_pixels,
                max_pixels=sub.max_pixels,
            )
        except Exception as e:  # noqa: BLE001 - bad request (e.g. aspect)
            self._fail(sub, e)
            return
        self._queue.put(sub)

    def cancel(self, submission: Submission) -> None:
        """Abort a submission (e.g. the streaming client disconnected). The
        engine thread frees its slot/pages on its next loop iteration."""
        submission.cancelled = True
        self._cancels.put(submission)

    def shutdown(self):
        self._stop.set()
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=False)
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _drain_queue(self, block: bool) -> None:
        try:
            sub = self._queue.get(timeout=0.05 if block else 0)
        except queue.Empty:
            return
        while True:
            try:
                if sub.cancelled:
                    self._fail(sub, RuntimeError("cancelled"))
                    try:
                        sub = self._queue.get_nowait()
                    except queue.Empty:
                        return
                    continue
                rid = self.engine.submit(
                    sub.prompt,
                    images=sub.images,
                    max_new_tokens=sub.max_new_tokens,
                    temperature=sub.temperature,
                    top_p=sub.top_p,
                    system_prompt=sub.system_prompt,
                    min_pixels=sub.min_pixels,
                    max_pixels=sub.max_pixels,
                    stop=list(sub.stop),
                    stop_token_ids=list(sub.stop_token_ids),
                    seed=sub.seed,
                    logprobs=sub.logprobs,
                    presence_penalty=sub.presence_penalty,
                    frequency_penalty=sub.frequency_penalty,
                    logit_bias=sub.logit_bias,
                    stream_cb=sub.stream_cb,
                    prepared=sub.prepared,
                )
                self._futures[rid] = sub
                # Requests rejected at submit time (e.g. prompt_too_long)
                # never pass through step(); resolve them immediately.
                rejected = self.engine.finished_request(rid)
                if rejected is not None:
                    self._resolve(rejected)
            except Exception as e:  # noqa: BLE001 - bad request (e.g. aspect)
                self._fail(sub, e)
            try:
                sub = self._queue.get_nowait()
            except queue.Empty:
                return

    @staticmethod
    def _fail(sub: Submission, exc: Exception) -> None:
        """Resolve a submission exceptionally — and ALWAYS fire a final
        stream callback so SSE handlers never hang on a dead request."""
        if not sub.future.done():
            sub.future.set_exception(exc)
        if sub.stream_cb is not None:
            try:
                sub.stream_cb("", "error")
            except Exception:  # noqa: BLE001
                logger.exception("stream callback failed during error path")

    def _drain_cancels(self) -> None:
        while True:
            try:
                sub = self._cancels.get_nowait()
            except queue.Empty:
                return
            for rid, pending in list(self._futures.items()):
                if pending is sub:
                    self.engine.cancel(rid)
                    break
            # cancel() lands the engine's in-flight decode chunk, which can
            # finish other requests too: resolve every finished one (the
            # engine may have no work left, so no step() would return them).
            for rid in list(self._futures):
                req = self.engine.finished_request(rid)
                if req is not None:
                    self._resolve(req)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._drain_cancels()
            self._drain_queue(block=not self.engine.has_work())
            if not self.engine.has_work():
                # Incremental warmup (server --warmup background): compile
                # one queued decode program per idle tick — requests that
                # arrive mid-compile wait at most one program instead of
                # the whole multi-minute upfront warm.
                if getattr(self.engine, "warm_pending", 0) and self._queue.empty():
                    try:
                        self.engine.warm_tick()
                    except Exception:  # noqa: BLE001
                        logger.exception("background warmup thunk failed")
                        self.engine._warm_queue = []
                continue
            try:
                finished = self.engine.step()
            except Exception as e:  # noqa: BLE001
                logger.exception("engine step failed")
                failed = dict(self._futures)
                self._futures.clear()
                for rid, sub in failed.items():
                    self._fail(sub, e)
                    # Take the request out of the engine too (slot, pages,
                    # finished map), or has_work() stays true and every
                    # later step() raises again in a tight loop.
                    self.engine.cancel(rid)
                    self.engine.take_finished(rid)
                continue
            for req in finished:
                self._resolve(req)

    def _resolve(self, req) -> None:
        sub = self._futures.pop(req.req_id, None)
        # take_finished (not request_text): completed requests must leave
        # the engine's finished map, or a long-lived server leaks every
        # request's token lists and decoded text.
        text = self.engine.take_finished(req.req_id)
        if sub is None or sub.future.done():
            return
        if text is None:
            text = req.final_text or ""
        logprobs = None
        if getattr(req, "logprobs", False):
            toks = list(req.prior_output) + list(req.output_ids)
            lps = list(req.output_logprobs)
            # Trim the trailing EOS/stop-token entry like request_text does
            # for the text, so tokens and content stay aligned.
            eos = self.engine.config.special.eos_token_id
            if toks and (toks[-1] == eos or toks[-1] in req.stop_token_ids):
                toks, lps = toks[:-1], lps[: len(toks) - 1]
            logprobs = list(zip(toks, lps))
        sub.future.set_result(
            {
                "text": text,
                "completion_tokens": len(req.prior_output) + len(req.output_ids),
                # A preempted request's generated tokens joined its prompt.
                "prompt_tokens": len(req.prompt_ids) - len(req.prior_output),
                "finish_reason": req.finished_reason or "stop",
                "logprobs": logprobs,
                # Per-request latency split (queue/ttft/prefill/decode ms) —
                # surfaced as a usage extension when the client asks.
                "timing": req.timing() if hasattr(req, "timing") else {},
            }
        )
