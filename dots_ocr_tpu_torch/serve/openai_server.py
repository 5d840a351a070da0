"""OpenAI-compatible HTTP serving front end (the port's copy of the JAX
package's ``OpenAIServer`` and its request handling, without its ``main``;
``serve/server.py`` builds the engine and runs this class).

It preserves the wire shape the reference client sends: POST
``/v1/chat/completions`` with an ``image_url`` data-URL part and a text
part that starts with the literal ``<|img|><|imgpad|><|endofimg|>``
placeholder. Requests land in a queue; with a continuous-batching engine
an ``EngineWorker`` thread (``serve/async_engine.py``) owns the engine,
otherwise a worker drains up to ``max_batch`` requests per batched
``engine.generate_batch`` call.

Endpoints: /v1/chat/completions, /v1/models, /health, /metrics.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from aiohttp import web

from dots_ocr_tpu_torch.engine.chat_template import IMAGE_PLACEHOLDER
from dots_ocr_tpu_torch.utils.image_io import base64_to_pil, fetch_image

logger = logging.getLogger(__name__)


@dataclass
class ServerMetrics:
    requests_total: int = 0
    requests_failed: int = 0
    prompt_tokens_total: int = 0
    completion_tokens_total: int = 0
    batches_total: int = 0
    batch_size_sum: int = 0
    started_at: float = field(default_factory=time.time)

    def render(self, engine=None) -> str:
        lines = [
            f"dots_ocr_requests_total {self.requests_total}",
            f"dots_ocr_requests_failed {self.requests_failed}",
            f"dots_ocr_prompt_tokens_total {self.prompt_tokens_total}",
            f"dots_ocr_completion_tokens_total {self.completion_tokens_total}",
            f"dots_ocr_batches_total {self.batches_total}",
            f"dots_ocr_batch_size_sum {self.batch_size_sum}",
            f"dots_ocr_uptime_seconds {time.time() - self.started_at:.1f}",
        ]
        # Continuous-batching scheduler gauges (KV occupancy, preemptions...).
        if engine is not None and hasattr(engine, "allocator"):
            alloc = engine.allocator
            used = alloc.num_pages - 1 - alloc.free_pages
            lines += [
                f"dots_ocr_kv_pages_used {used}",
                f"dots_ocr_kv_pages_total {alloc.num_pages - 1}",
                f"dots_ocr_kv_occupancy {used / max(1, alloc.num_pages - 1):.4f}",
            ]
            for key, value in getattr(engine, "metrics", {}).items():
                lines.append(f"dots_ocr_engine_{key} {value}")
            lines.append(
                "dots_ocr_engine_warm_pending "
                f"{getattr(engine, 'warm_pending', 0)}"
            )
            # Per-request latency percentiles over the last-N finished
            # requests (from receipt: preprocessing wait and work, the
            # engine thread's wait and its worker-queue part, queue,
            # prefill, TTFT, decode, total — ScheduledRequest.timing()).
            timings = list(getattr(engine, "recent_timings", ()))
            if timings:
                import numpy as _np

                for key in ("prep_wait_ms", "prep_ms", "engine_wait_ms", "worker_queue_ms",
                            "queue_ms", "ttft_ms", "prefill_ms", "decode_ms", "total_ms"):
                    vals = _np.array([t[key] for t in timings])
                    for q, tag in ((50, "p50"), (95, "p95"), (99, "p99")):
                        lines.append(
                            f"dots_ocr_request_{key}_{tag} "
                            f"{float(_np.percentile(vals, q)):.1f}"
                        )
                lines.append(f"dots_ocr_request_timing_window {len(timings)}")
        return "\n".join(lines) + "\n"


@dataclass
class _PendingRequest:
    prompt: str
    images: list
    temperature: float
    top_p: float
    max_new_tokens: int
    system_prompt: Optional[str]
    future: asyncio.Future


def truncate_at_stop(text: str, stops) -> tuple:
    """Cut ``text`` at the earliest stop-string match (OpenAI semantics: the
    stop string itself is excluded). Returns (text, matched: bool)."""
    best = -1
    for s in stops or []:
        i = text.find(s)
        if i >= 0 and (best < 0 or i < best):
            best = i
    return (text[:best], True) if best >= 0 else (text, False)


def parse_chat_messages(messages: List[Dict[str, Any]]):
    """Extract (prompt_text, images, system_prompt) from OpenAI messages.

    The literal image placeholder in the text is removed — the engine
    re-inserts the expanded span per image (chat_template.build_prompt_ids).
    """
    system_prompt = None
    prompt_parts: List[str] = []
    images = []
    for message in messages:
        role = message.get("role")
        content = message.get("content")
        if role == "system":
            system_prompt = content if isinstance(content, str) else str(content)
            continue
        if role != "user":
            continue
        if isinstance(content, str):
            prompt_parts.append(content)
            continue
        for part in content or []:
            ptype = part.get("type")
            if ptype == "text":
                prompt_parts.append(part.get("text", ""))
            elif ptype == "image_url":
                url = (part.get("image_url") or {}).get("url", "")
                if url.startswith("data:image"):
                    images.append(base64_to_pil(url))
                else:
                    images.append(fetch_image(url))
    prompt = "".join(prompt_parts).replace(IMAGE_PLACEHOLDER, "")
    return prompt, images, system_prompt


class OpenAIServer:
    def __init__(
        self,
        engine,
        model_name: str = "model",
        max_batch: int = 8,
        batch_window_ms: float = 5.0,
    ):
        self.engine = engine
        self.model_name = model_name
        self.max_batch = max_batch
        self.batch_window_ms = batch_window_ms
        self.metrics = ServerMetrics()
        self._queue: asyncio.Queue = asyncio.Queue()
        self._worker_task = None
        # Continuous-batching engines get a dedicated engine thread; the
        # sync engine uses the asyncio micro-batcher below.
        self._cb_worker = None
        if hasattr(engine, "step") and hasattr(engine, "submit"):
            from dots_ocr_tpu_torch.serve.async_engine import EngineWorker

            self._cb_worker = EngineWorker(engine)

    # -- batching worker ----------------------------------------------------

    async def _worker(self):
        while True:
            first: _PendingRequest = await self._queue.get()
            batch = [first]
            if self.batch_window_ms > 0:
                await asyncio.sleep(self.batch_window_ms / 1000.0)
            while len(batch) < self.max_batch:
                try:
                    batch.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            await self._run_batch(batch)

    async def _run_batch(self, batch: List[_PendingRequest]):
        loop = asyncio.get_running_loop()
        self.metrics.batches_total += 1
        self.metrics.batch_size_sum += len(batch)
        max_new = max(r.max_new_tokens for r in batch)
        # System prompts must match to batch; split otherwise.
        sys_prompts = {r.system_prompt for r in batch}
        if len(sys_prompts) > 1:
            for r in batch:
                await self._run_batch([r])
            return
        try:
            texts = await loop.run_in_executor(
                None,
                lambda: self.engine.generate_batch(
                    [r.prompt for r in batch],
                    [r.images for r in batch],
                    temperature=[r.temperature for r in batch],
                    top_p=[r.top_p for r in batch],
                    max_new_tokens=max_new,
                    system_prompt=batch[0].system_prompt,
                ),
            )
            for r, text in zip(batch, texts):
                if not r.future.done():
                    r.future.set_result(text)
        except Exception as e:  # noqa: BLE001
            logger.exception("batch execution failed")
            for r in batch:
                if not r.future.done():
                    r.future.set_exception(e)

    # -- handlers -----------------------------------------------------------

    @staticmethod
    def _bad_request(message: str) -> web.Response:
        return web.json_response(
            {"error": {"message": message, "type": "invalid_request_error"}},
            status=400,
        )

    @staticmethod
    def _validate_params(body: Dict[str, Any]) -> Optional[str]:
        """Explicit conformance: unsupported OpenAI params are REJECTED, not
        silently ignored (vLLM-parity behavior for the knobs we don't serve).
        Returns an error message or None."""
        n = body.get("n")
        if n is not None and (
            isinstance(n, bool) or not isinstance(n, int) or not 1 <= n <= 8
        ):
            return "'n' must be an integer in [1, 8]"
        if n not in (None, 1) and body.get("stream"):
            return "'n' > 1 is not supported with streaming"
        if body.get("best_of") not in (None, 1):
            return "'best_of' != 1 is not supported"
        lp = body.get("logprobs")
        if lp is not None and not isinstance(lp, bool):
            return "'logprobs' must be a boolean"
        if body.get("top_logprobs") not in (None, 0):
            return "'top_logprobs' > 0 is not supported"
        if lp and body.get("stream"):
            return "'logprobs' is not supported with streaming"
        if body.get("tools") or body.get("functions") or body.get("tool_choice"):
            return "tool / function calling is not supported"
        for knob in ("presence_penalty", "frequency_penalty"):
            v = body.get(knob)
            if v is None:
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                return f"'{knob}' must be a number"
            if not -2.0 <= float(v) <= 2.0:
                return f"'{knob}' must be in [-2, 2]"
        stop = body.get("stop")
        if stop is not None and not (
            isinstance(stop, str)
            or (isinstance(stop, list) and all(isinstance(s, str) for s in stop))
        ):
            return "'stop' must be a string or a list of strings"
        lb = body.get("logit_bias")
        if lb is not None:
            if not isinstance(lb, dict):
                return "'logit_bias' must be an object"
            if len(lb) > 32:
                return "'logit_bias' supports at most 32 entries"
            for k, v in lb.items():
                try:
                    int(k)
                except (TypeError, ValueError):
                    return "'logit_bias' keys must be token ids"
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    return "'logit_bias' values must be numbers"
                if not -100.0 <= float(v) <= 100.0:
                    return "'logit_bias' values must be in [-100, 100]"
        sd = body.get("seed")
        if sd is not None and (isinstance(sd, bool) or not isinstance(sd, int)):
            return "'seed' must be an integer"
        sti = body.get("stop_token_ids")
        if sti is not None and not (
            isinstance(sti, list)
            and all(isinstance(t, int) and not isinstance(t, bool) for t in sti)
        ):
            return "'stop_token_ids' must be a list of integers"
        return None

    def _format_logprobs(self, entries) -> Dict[str, Any]:
        """OpenAI chat logprobs shape: choices[].logprobs.content =
        [{token, logprob, bytes}]. Logprobs are the RAW model distribution
        (temperature-independent; well-defined for greedy requests)."""
        tok = getattr(self.engine, "tokenizer", None)
        content = []
        for tid, lp in entries:
            text = tok.decode([tid], skip_special_tokens=False) if tok else ""
            content.append(
                {
                    "token": text,
                    "logprob": round(float(lp), 6),
                    "bytes": list(text.encode("utf-8")),
                }
            )
        return {"content": content}

    async def handle_chat_completions(self, request: web.Request) -> web.Response:
        self.metrics.requests_total += 1
        try:
            try:
                body = await request.json()
            except (json.JSONDecodeError, ValueError) as e:
                self.metrics.requests_failed += 1
                return self._bad_request(f"invalid JSON body: {e}")
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                self.metrics.requests_failed += 1
                return self._bad_request("'messages' must be a non-empty list")
            err = self._validate_params(body)
            if err is not None:
                self.metrics.requests_failed += 1
                return self._bad_request(err)
            if self._cb_worker is None and (
                body.get("logprobs")
                or body.get("presence_penalty")
                or body.get("frequency_penalty")
                or body.get("logit_bias")
            ):
                self.metrics.requests_failed += 1
                return self._bad_request(
                    "'logprobs' / penalties need the continuous engine "
                    "(--engine continuous)"
                )
            prompt, images, system_prompt = parse_chat_messages(messages)
            if not prompt and not images:
                self.metrics.requests_failed += 1
                return self._bad_request("no user content in 'messages'")
            max_new = int(
                body.get("max_completion_tokens")
                or body.get("max_tokens")
                or self.engine.default_max_new_tokens
            )
            temperature = float(body.get("temperature", 0.1))
            top_p = float(body.get("top_p", 1.0))
            stop = body.get("stop")
            # Drop empty stop strings: ''.find('') == 0, so an empty stop
            # would truncate every completion to "" on the batch path.
            stop = [stop] if isinstance(stop, str) else list(stop or [])
            stop = [s for s in stop if s]
            stop_token_ids = [int(t) for t in body.get("stop_token_ids") or []]

            if body.get("stream"):
                return await self._stream_chat(
                    request, body, prompt, images, system_prompt,
                    max_new, temperature, top_p, stop, stop_token_ids,
                )

            # OpenAI `n`: fan out n submissions — the continuous engine
            # co-batches them, so n choices cost ~one request's wall time.
            # Seeded requests derive choice i's seed as seed + i (equal
            # seeds would return n identical completions).
            n_choices = int(body.get("n") or 1)
            seed = body.get("seed")
            if self._cb_worker is not None:
                from dots_ocr_tpu_torch.serve.async_engine import Submission

                subs = [
                    Submission(
                        prompt=prompt,
                        images=images,
                        max_new_tokens=max_new,
                        temperature=temperature,
                        top_p=top_p,
                        system_prompt=system_prompt,
                        stop=stop,
                        stop_token_ids=stop_token_ids,
                        seed=(seed + ci) if seed is not None else None,
                        logprobs=bool(body.get("logprobs")),
                        presence_penalty=float(
                            body.get("presence_penalty") or 0.0
                        ),
                        frequency_penalty=float(
                            body.get("frequency_penalty") or 0.0
                        ),
                        logit_bias=(
                            {int(k): float(v)
                             for k, v in body["logit_bias"].items()}
                            if body.get("logit_bias") else None
                        ),
                    )
                    for ci in range(n_choices)
                ]
                futs = [self._cb_worker.submit(s) for s in subs]
                results = [await asyncio.wrap_future(f) for f in futs]
                choice_texts = [
                    (r["text"], r["finish_reason"]) for r in results
                ]
                choice_logprobs = [r.get("logprobs") for r in results]
                prompt_tokens = results[0]["prompt_tokens"]
                completion_tokens = sum(
                    r["completion_tokens"] for r in results
                )
                timing = results[0].get("timing") or None
            else:
                loop = asyncio.get_running_loop()
                pendings = [
                    _PendingRequest(
                        prompt=prompt,
                        images=images,
                        temperature=temperature,
                        top_p=top_p,
                        max_new_tokens=max_new,
                        system_prompt=system_prompt,
                        future=loop.create_future(),
                    )
                    for _ in range(n_choices)
                ]
                for pending in pendings:
                    await self._queue.put(pending)
                texts = [await p.future for p in pendings]
                stats = self.engine.last_stats
                prompt_tokens = stats.prompt_tokens
                completion_tokens = stats.completion_tokens
                # The micro-batch engine decodes to max_new; stop strings
                # are applied post hoc (the continuous engine stops early).
                choice_texts = [
                    (truncate_at_stop(t, stop)[0], "stop") for t in texts
                ]
                choice_logprobs = [None] * n_choices
                timing = None

            self.metrics.prompt_tokens_total += prompt_tokens
            self.metrics.completion_tokens_total += completion_tokens
            response = {
                "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
                "object": "chat.completion",
                "created": int(time.time()),
                "model": body.get("model", self.model_name),
                "choices": [
                    {
                        "index": ci,
                        "message": {"role": "assistant", "content": t},
                        "finish_reason": fr,
                        **(
                            {"logprobs": self._format_logprobs(
                                choice_logprobs[ci]
                            )}
                            if choice_logprobs[ci] is not None
                            else {}
                        ),
                    }
                    for ci, (t, fr) in enumerate(choice_texts)
                ],
                "usage": {
                    "prompt_tokens": prompt_tokens,
                    "completion_tokens": completion_tokens,
                    "total_tokens": prompt_tokens + completion_tokens,
                },
            }
            if timing:
                # Extension (OpenAI clients ignore unknown usage keys):
                # per-request queue/TTFT/prefill/decode latency split, ms.
                response["usage"]["latency"] = {
                    k: round(v, 1) for k, v in timing.items()
                }
            return web.json_response(response)
        except Exception as e:  # noqa: BLE001
            self.metrics.requests_failed += 1
            logger.exception("chat completion failed")
            return web.json_response(
                {"error": {"message": str(e), "type": type(e).__name__}}, status=500
            )

    # -- SSE streaming --------------------------------------------------------

    async def _stream_chat(
        self,
        request: web.Request,
        body: Dict[str, Any],
        prompt: str,
        images: list,
        system_prompt: Optional[str],
        max_new: int,
        temperature: float,
        top_p: float,
        stop: list,
        stop_token_ids: list,
    ) -> web.StreamResponse:
        """OpenAI `stream: true` — chat.completion.chunk SSE events.

        The continuous engine streams true per-chunk deltas (its engine
        thread fires the request's stream_cb as tokens land); the
        micro-batch engine falls back to one whole-text delta. Client
        disconnect mid-stream cancels the request (frees its KV pages).
        """
        rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        model = body.get("model", self.model_name)

        def sse(delta: Dict[str, Any], finish_reason=None, usage=None) -> bytes:
            payload: Dict[str, Any] = {
                "id": rid,
                "object": "chat.completion.chunk",
                "created": created,
                "model": model,
                "choices": [
                    {"index": 0, "delta": delta, "finish_reason": finish_reason}
                ],
            }
            if usage is not None:
                payload["usage"] = usage
            return f"data: {json.dumps(payload)}\n\n".encode()

        resp = web.StreamResponse(
            status=200,
            headers={
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-cache",
                "X-Accel-Buffering": "no",
            },
        )
        await resp.prepare(request)
        # From here on the response is COMMITTED: any failure must be
        # reported IN-STREAM (an SSE error event + [DONE]) — letting an
        # exception escape to the outer JSON handler would write a second
        # HTTP response into the already-started chunked body, corrupting
        # the stream for the client.
        try:
            return await self._stream_chat_body(
                request, resp, sse, body, prompt, images, system_prompt,
                max_new, temperature, top_p, stop, stop_token_ids,
            )
        except (ConnectionResetError, asyncio.CancelledError):
            raise  # client went away; nothing more to write
        except Exception as e:  # noqa: BLE001
            self.metrics.requests_failed += 1
            logger.exception("streaming chat failed mid-stream")
            try:
                await resp.write(
                    b"data: "
                    + json.dumps(
                        {"error": {"message": str(e), "type": type(e).__name__}}
                    ).encode()
                    + b"\n\n"
                )
                await resp.write(b"data: [DONE]\n\n")
                await resp.write_eof()
            except Exception:  # noqa: BLE001 - stream already broken
                pass
            return resp

    async def _stream_chat_body(
        self,
        request: web.Request,
        resp: web.StreamResponse,
        sse,
        body: Dict[str, Any],
        prompt: str,
        images: list,
        system_prompt: Optional[str],
        max_new: int,
        temperature: float,
        top_p: float,
        stop: list,
        stop_token_ids: list,
    ) -> web.StreamResponse:
        include_usage = bool(
            (body.get("stream_options") or {}).get("include_usage")
        )
        await resp.write(sse({"role": "assistant", "content": ""}))

        usage = None
        if self._cb_worker is not None:
            from dots_ocr_tpu_torch.serve.async_engine import Submission

            loop = asyncio.get_running_loop()
            deltas: asyncio.Queue = asyncio.Queue()

            def stream_cb(delta: str, finish: Optional[str]) -> None:
                # Engine thread -> event loop trampoline.
                loop.call_soon_threadsafe(deltas.put_nowait, (delta, finish))

            sub = Submission(
                prompt=prompt,
                images=images,
                max_new_tokens=max_new,
                temperature=temperature,
                top_p=top_p,
                system_prompt=system_prompt,
                stop=stop,
                stop_token_ids=stop_token_ids,
                seed=body.get("seed"),
                presence_penalty=float(body.get("presence_penalty") or 0.0),
                frequency_penalty=float(body.get("frequency_penalty") or 0.0),
                logit_bias=(
                    {int(k): float(v)
                     for k, v in body["logit_bias"].items()}
                    if body.get("logit_bias") else None
                ),
                stream_cb=stream_cb,
            )
            fut = self._cb_worker.submit(sub)
            finish_reason = "stop"
            try:
                while True:
                    delta, finish = await deltas.get()
                    if delta:
                        await resp.write(sse({"content": delta}))
                    if finish is not None:
                        finish_reason = finish
                        break
            except (ConnectionResetError, asyncio.CancelledError):
                # Client went away: stop decoding, free the slot/pages.
                self._cb_worker.cancel(sub)
                raise
            # Token accounting happens for EVERY stream (a deployment of
            # mostly-streaming clients must not report near-zero token
            # totals); the usage payload is attached only when requested.
            try:
                result = await asyncio.wrap_future(fut)
                self.metrics.prompt_tokens_total += result["prompt_tokens"]
                self.metrics.completion_tokens_total += result[
                    "completion_tokens"
                ]
                if include_usage:
                    usage = {
                        "prompt_tokens": result["prompt_tokens"],
                        "completion_tokens": result["completion_tokens"],
                        "total_tokens": result["prompt_tokens"]
                        + result["completion_tokens"],
                    }
            except Exception:  # noqa: BLE001 - error already streamed as
                self.metrics.requests_failed += 1  # the 'error' finish
        else:
            pending = _PendingRequest(
                prompt=prompt,
                images=images,
                temperature=temperature,
                top_p=top_p,
                max_new_tokens=max_new,
                system_prompt=system_prompt,
                future=asyncio.get_running_loop().create_future(),
            )
            await self._queue.put(pending)
            text = await pending.future
            text, _ = truncate_at_stop(text, stop)
            if text:
                await resp.write(sse({"content": text}))
            finish_reason = "stop"
            stats = self.engine.last_stats
            self.metrics.prompt_tokens_total += stats.prompt_tokens
            self.metrics.completion_tokens_total += stats.completion_tokens
            if include_usage:
                usage = {
                    "prompt_tokens": stats.prompt_tokens,
                    "completion_tokens": stats.completion_tokens,
                    "total_tokens": stats.prompt_tokens + stats.completion_tokens,
                }

        await resp.write(sse({}, finish_reason=finish_reason, usage=usage))
        await resp.write(b"data: [DONE]\n\n")
        await resp.write_eof()
        return resp

    async def handle_models(self, request: web.Request) -> web.Response:
        return web.json_response(
            {
                "object": "list",
                "data": [
                    {
                        "id": self.model_name,
                        "object": "model",
                        "owned_by": "dots_ocr_tpu",
                    }
                ],
            }
        )

    async def handle_health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "ok"})

    async def handle_metrics(self, request: web.Request) -> web.Response:
        return web.Response(
            text=self.metrics.render(self.engine), content_type="text/plain"
        )

    # -- app ----------------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=256 * 1024 * 1024)
        app.router.add_post("/v1/chat/completions", self.handle_chat_completions)
        app.router.add_get("/v1/models", self.handle_models)
        app.router.add_get("/health", self.handle_health)
        app.router.add_get("/metrics", self.handle_metrics)

        async def on_startup(app):
            if self._cb_worker is None:
                self._worker_task = asyncio.create_task(self._worker())

        async def on_cleanup(app):
            if self._worker_task:
                self._worker_task.cancel()
            if self._cb_worker is not None:
                self._cb_worker.shutdown()

        app.on_startup.append(on_startup)
        app.on_cleanup.append(on_cleanup)
        return app

    def run(self, host: str = "0.0.0.0", port: int = 8000):
        web.run_app(self.build_app(), host=host, port=port)
