"""Bridges the serving front end to the continuous-batching scheduler.

A single engine thread owns all device interaction (the scheduler is
single-threaded by design — SURVEY.md §5.2 notes the reference's lock-free
thread soup and deliberately replaces it with one event loop + queues):
HTTP handlers enqueue (request, future) pairs; the engine thread drains the
queue, submits into the scheduler, steps it while work remains, and
resolves futures as requests finish.

Under tensor-parallel serving the engine thread is rank 0's, and the ranks
run in lockstep (SPMD): each loop iteration gathers the tick's events
(prepared submissions, cancels, a failed step's cancels, whether an idle
tick may warm, shutdown) into a :class:`Tick`, broadcasts it over the TP
group's CPU control group, and then applies it to its own engine exactly
as every other rank applies it (:func:`follow`, their loop without HTTP).
An idle tick is broadcast too (every 50 ms), so a follower never waits out
the group's timeout. A lost group (a rank died or a collective timed out)
fails the requests in flight and every later one.

While the engine holds a decode chunk whose result has not landed
(``engine.held_fetch()``), the engine thread waits for whichever comes
first, a submission or that landing: a waker thread waits on the chunk's
fetch (its CUDA event, without the interpreter lock) and puts the fetch in
the queue once it has landed. So a request that arrives while a chunk runs
is taken at once and admitted beside the chunk, and finished requests
resolve as soon as their chunk lands. Outside tensor parallelism the
worker also hands the engine a probe of its queue (``engine.arrivals``):
a step during which requests arrived leaves its decode chunk to the next
step, which admits them first, and chunks are not deepened.

Each submission is stamped (``time.monotonic()``) at receipt, at the start
and end of its preprocessing and at the engine thread's take; the stamps
travel into ``engine.submit`` (and to the followers, where nothing reads
them), so that a request's ``timing()`` counts from receipt. While a torch
profiler runs, the engine thread records a ``tick`` span per iteration
(``gather``, ``submit``, and the engine's ``step`` tree) and the
preprocessing threads a ``prepare`` span per request
(``utils/observability.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from dots_ocr_tpu_torch.parallel.distributed import TPGroupLost, broadcast_object
from dots_ocr_tpu_torch.utils.observability import NO_SPAN, SPANS

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
    # time.monotonic() stamps: receipt (submit), preprocessing start and
    # end, the engine thread's take (ScheduledRequest's fields of the names).
    received_at: Optional[float] = None
    prep_started_at: Optional[float] = None
    prep_ended_at: Optional[float] = None
    taken_at: Optional[float] = None


# The engine.submit arguments a tick carries (the prepared request stands
# in for the prompt's images; a stream callback for its presence only).
_SUBMIT_FIELDS = ("prompt", "max_new_tokens", "temperature", "top_p", "system_prompt",
                  "min_pixels", "max_pixels", "stop", "stop_token_ids", "seed", "logprobs",
                  "presence_penalty", "frequency_penalty", "logit_bias", "prepared",
                  "received_at", "prep_started_at", "prep_ended_at", "taken_at")


@dataclass
class Tick:
    """One engine-loop iteration's events, in the order they apply:
    ``failed`` (the requests a failed step cancelled), ``cancels``,
    ``submits``, then, with nothing to step, a warm tick if ``warm``;
    ``stop`` ends the loop. On the wire a submission is its
    engine.submit arguments and whether it streams (:func:`_wire`)."""

    submits: List[Submission] = field(default_factory=list)
    cancels: List[int] = field(default_factory=list)
    failed: List[int] = field(default_factory=list)
    warm: bool = False
    stop: bool = False


def _no_stream(delta: str, finish: Optional[str]) -> None:
    """A follower's stand-in for a stream callback: whether a request
    streams changes the engine's decisions (it keeps chunks shallow)."""


def _wire(sub: Submission) -> tuple:
    fields = {name: getattr(sub, name) for name in _SUBMIT_FIELDS}
    fields.update(stop=list(sub.stop), stop_token_ids=list(sub.stop_token_ids))
    return fields, sub.stream_cb is not None


def _unwire(item: tuple) -> Submission:
    fields, streamed = item
    return Submission(images=(), stream_cb=_no_stream if streamed else None, **fields)


class EngineWorker:
    """Engine thread around a ContinuousBatchingEngine (rank 0's, when the
    engine has a TP group: ``engine.tp``)."""

    def __init__(self, engine, prep_workers: int = 1, thread: bool = True):
        self.engine = engine
        self._tp = getattr(engine, "tp", None)
        # Why the TP group was lost; every request fails once it is set.
        self.lost: Optional[str] = None
        # Submissions, and the fetches the waker saw land.
        self._queue: "queue.Queue" = queue.Queue()
        self._cancels: "queue.Queue[Submission]" = queue.Queue()
        self._futures: Dict[int, Submission] = {}
        self._failed: List[int] = []
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
        self._thread = threading.Thread(target=self._loop, daemon=True, name="engine")
        # The waker: waits on each fetch handed to it in turn and puts it in
        # the queue once it has landed; _watched is the last one handed over.
        self._watch: "queue.SimpleQueue" = queue.SimpleQueue()
        self._watched = None
        self._waker = threading.Thread(target=self._wake_on_landing, daemon=True, name="waker")
        if thread:
            if self._tp is None:
                engine.arrivals = self._arrivals
            self._thread.start()
            self._waker.start()

    def submit(self, submission: Submission) -> Future:
        submission.received_at = time.monotonic()
        if self.lost is not None:
            self._fail(submission, RuntimeError(f"tensor-parallel group lost: {self.lost}"))
            return submission.future
        if self._prep_pool is not None and submission.prepared is None:
            self._prep_pool.submit(self._prep_and_enqueue, submission)
        else:
            self._queue.put(submission)
        return submission.future

    def _prep_and_enqueue(self, sub: Submission) -> None:
        if sub.cancelled:  # client gone while queued for preprocessing
            self._fail(sub, RuntimeError("cancelled"))
            return
        if self.lost is not None:
            self._fail(sub, RuntimeError(f"tensor-parallel group lost: {self.lost}"))
            return
        try:
            self._prepare(sub)
        except Exception as e:  # noqa: BLE001 - bad request (e.g. aspect)
            self._fail(sub, e)
            return
        self._queue.put(sub)

    def _prepare(self, sub: Submission) -> None:
        """Tokenize and patch a submission, stamped and spanned."""
        with SPANS("prepare") as span:
            sub.prep_started_at = time.monotonic()
            sub.prepared = self.engine.prepare(
                sub.prompt, sub.images, system_prompt=sub.system_prompt,
                min_pixels=sub.min_pixels, max_pixels=sub.max_pixels)
            sub.prep_ended_at = time.monotonic()
            if span and sub.prepared.packed is not None:
                span.note(patches=[h * w for h, w in sub.prepared.packed.grids])

    def cancel(self, submission: Submission) -> None:
        """Abort a submission (e.g. the streaming client disconnected). The
        engine thread frees its slot/pages on its next loop iteration."""
        submission.cancelled = True
        self._cancels.put(submission)

    def shutdown(self):
        self._stop.set()
        self._watch.put(None)
        if self._prep_pool is not None:
            self._prep_pool.shutdown(wait=False)
        self._thread.join(timeout=5)

    # ------------------------------------------------------------------

    def _wake_on_landing(self) -> None:
        while True:
            fetch = self._watch.get()
            if fetch is None:
                return
            try:
                fetch.wait()
            except Exception:  # noqa: BLE001 - the engine's step raises it again
                logger.exception("waiting on a decode chunk's fetch failed")
            self._queue.put(fetch)

    def _first(self, block: bool, held) -> Optional[object]:
        """The tick's first queue item: with ``held`` (the engine's held
        chunk's fetch) a submission or ``held`` itself once it has landed,
        whichever comes first (earlier fetches are dropped); else a
        submission within 50 ms when ``block``, or none."""
        if held is None:
            try:
                return self._queue.get(timeout=0.05 if block else 0)
            except queue.Empty:
                return None
        if held is not self._watched:
            self._watched = held
            self._watch.put(held)
        while True:
            item = self._queue.get()
            if item is held or isinstance(item, Submission):
                return item

    def _gather(self, block: bool, held) -> Tick:
        """This iteration's events, after waiting as :meth:`_first` says:
        cancels of submitted requests, then the queued submissions
        (prepared here if the pool did not)."""
        items = [self._first(block, held)]
        tick = Tick(failed=self._failed)
        self._failed = []
        while True:
            try:
                sub = self._cancels.get_nowait()
            except queue.Empty:
                break
            tick.cancels += [rid for rid, pending in self._futures.items() if pending is sub]
        try:
            while True:
                items.append(self._queue.get_nowait())
        except queue.Empty:
            pass
        subs = [item for item in items if isinstance(item, Submission)]
        taken = time.monotonic()
        for sub in subs:
            sub.taken_at = taken
            if sub.cancelled:
                self._fail(sub, RuntimeError("cancelled"))
                continue
            if sub.prepared is None and self._tp is not None:
                try:
                    self._prepare(sub)
                except Exception as e:  # noqa: BLE001 - bad request (e.g. aspect)
                    self._fail(sub, e)
                    continue
            tick.submits.append(sub)
        tick.warm = self._queue.empty()
        tick.stop = self._stop.is_set()
        return tick

    def _broadcast(self, tick: Tick) -> None:
        """Send the tick to the other ranks (their copy carries no
        Submission objects)."""
        broadcast_object(dataclasses.replace(tick, submits=[_wire(s) for s in tick.submits]),
                         self._tp)

    def _apply(self, tick: Tick) -> None:
        """Apply the tick to the engine, resolving futures as requests
        finish (every follower applies the same tick: :func:`follow`)."""
        for rid in tick.failed:
            self._futures.pop(rid, None)
            self.engine.cancel(rid)
            self.engine.take_finished(rid)
        for rid in tick.cancels:
            self.engine.cancel(rid)
        if tick.cancels:
            # cancel() lands the engine's in-flight decode chunk, which can
            # finish other requests too: resolve every finished one (the
            # engine may have no work left, so no step() would return them).
            for rid in list(self._futures):
                req = self.engine.finished_request(rid)
                if req is not None:
                    self._resolve(req)
        with SPANS("submit") if tick.submits else NO_SPAN as span:
            submitted = []
            for sub in tick.submits:
                try:
                    rid = self.engine.submit(
                        images=sub.images, stream_cb=sub.stream_cb,
                        **{name: getattr(sub, name) for name in _SUBMIT_FIELDS})
                except Exception as e:  # noqa: BLE001 - bad request (e.g. logit_bias)
                    self._fail(sub, e)
                    continue
                self._futures[rid] = sub
                submitted.append(rid)
                # Requests rejected at submit time (e.g. prompt_too_long)
                # never pass through step(); resolve them immediately.
                rejected = self.engine.finished_request(rid)
                if rejected is not None:
                    self._resolve(rejected)
            span.note(reqs=submitted)
        if not self.engine.has_work():
            # Incremental warmup (server --warmup background): compile
            # one queued decode program per idle tick — requests that
            # arrive mid-compile wait at most one program instead of
            # the whole multi-minute upfront warm.
            if getattr(self.engine, "warm_pending", 0) and tick.warm:
                try:
                    self.engine.warm_tick()
                except TPGroupLost:
                    raise
                except Exception:  # noqa: BLE001
                    logger.exception("background warmup thunk failed")
                    self.engine._warm_queue = []
            return
        try:
            finished = self.engine.step()
        except TPGroupLost:
            raise
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
            # The other ranks take the same requests out at the next tick.
            self._failed = list(failed)
            return
        for req in finished:
            self._resolve(req)

    def _arrivals(self) -> bool:
        """Whether a submission waits in the queue."""
        with self._queue.mutex:
            return any(isinstance(item, Submission) for item in self._queue.queue)

    def _lose(self, e: Exception) -> None:
        """The TP group is gone: fail what is in flight and all that comes."""
        self.lost = str(e) or type(e).__name__
        logger.error("tensor-parallel group lost (%s): failing %d requests in flight",
                     self.lost, len(self._futures))
        failed = dict(self._futures)
        self._futures.clear()
        for sub in failed.values():
            self._fail(sub, RuntimeError(f"tensor-parallel group lost: {self.lost}"))
        while True:
            try:
                self._fail(self._queue.get_nowait(), RuntimeError(
                    f"tensor-parallel group lost: {self.lost}"))
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

    def _loop(self) -> None:
        while True:
            with SPANS.whole("tick"):
                with SPANS("gather"):
                    tick = self._gather(block=not self.engine.has_work(),
                                        held=self.engine.held_fetch())
                try:
                    if self._tp is not None:
                        self._broadcast(tick)
                    if tick.stop:
                        return
                    self._apply(tick)
                except TPGroupLost as e:
                    self._lose(e)
                    return

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


def follow(engine) -> None:
    """A follower rank's engine loop (no HTTP): apply rank 0's ticks to
    ``engine`` (whose ``tp`` is this rank's group) until a tick stops it.
    Raises ``TPGroupLost`` when the group fails."""
    worker = EngineWorker(engine, prep_workers=0, thread=False)
    while True:
        tick = broadcast_object(None, engine.tp)
        if tick.stop:
            return
        worker._apply(dataclasses.replace(tick, submits=[_unwire(s) for s in tick.submits]))
