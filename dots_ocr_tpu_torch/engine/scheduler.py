"""Continuous-batching engine over the paged KV cache (port of
``dots_ocr_tpu.engine.scheduler``).

A single-threaded host loop drives plain functions ("programs"):

  * ``prefill_program``: one admitted batch of short prompts runs the full
    VLM forward (vision encoder, splice, causal flash prefill), its K/V
    scattered into the pages through a host-computed slot mapping, and the
    first token sampled from each row's last valid logit;
  * chunked prefill, for prompts longer than ``prefill_chunk_tokens``: at
    admission the token embeddings, and per request ``encode_program`` and
    the splice of its vision tokens (the request parks in its slot as
    PREFILLING); then one ``prefill_extend_program`` chunk per step for the
    lockstep group at the smallest offset, interleaved with decode;
  * ``decode_program``: ``num_steps`` decode iterations for every slot
    ([S] tokens, [S, max_pages] page tables of static width) through the
    paged decode kernel, with one host sync per chunk;
  * ``spec_decode_program`` (``speculate_k`` > 0): per iteration a bigram
    draft over each slot's generated history, one verify forward over the
    k + 1 tokens, and greedy / exact delta-proposal acceptance; an
    adaptive gate turns speculation off for the current load when it emits
    fewer than ``spec_min_tokens_per_iter`` tokens per slot-iteration.

KV pools are bf16 or int8 (``kv_cache_dtype``); weights may be int8
(``models/quantize.py``). Admission is page-aware (free-page watermark).
Host code carries stop strings, stop ids, streaming and the repetition
guard.

Not ported yet; ``submit`` raises ``ValueError`` naming the ROADMAP item:
logprobs, presence/frequency penalties, ``logit_bias`` and ``seed``. Also
not ported: pipelined (lookahead-1) decode and the deep-chunk depth
adaptation. A pool that runs dry mid-decode preempts the youngest request
(recompute preemption: it re-queues with its generated tokens appended to
its prompt) and every request still finishes with the same greedy tokens.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from dots_ocr_tpu_torch.engine.repetition import detect_repetition
from dots_ocr_tpu_torch.engine.tokenizer import (
    ByteTokenizer,
    IncrementalDetokenizer,
    TokenizerLike,
    longest_stop_prefix_at_tail,
)
from dots_ocr_tpu_torch.engine.kv_cache import (
    OutOfPages,
    PageAllocator,
    PagedKV,
    write_prefill_kv,
)
from dots_ocr_tpu_torch.engine.request import prepare_request
from dots_ocr_tpu_torch.engine.sampling import sample_logits, spec_accept
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.decoder import (
    decoder_decode_step_paged,
    decoder_prefill_extend_batched,
    decoder_spec_step_paged,
    embed_tokens,
    logits_from_hidden,
)
from dots_ocr_tpu_torch.models.preprocess import merge_packed
from dots_ocr_tpu_torch.models.rope import vision_rope_device
from dots_ocr_tpu_torch.models.vision import encode_images
from dots_ocr_tpu_torch.models.vlm import (
    build_scatter_indices,
    splice_vision_embeddings,
    vlm_prefill,
)

logger = logging.getLogger(__name__)

# The ROADMAP.md items that will bring the features not ported yet.
NOT_PORTED = {
    "logprobs": "logprobs, penalties and logit_bias",
    "presence_penalty": "logprobs, penalties and logit_bias",
    "frequency_penalty": "logprobs, penalties and logit_bias",
    "logit_bias": "logprobs, penalties and logit_bias",
    "seed": "seeded position-keyed sampling",
}


def _not_ported(feature: str) -> str:
    return (f"{feature} is not supported by the PyTorch port yet "
            f"(ROADMAP.md: {NOT_PORTED[feature]})")


def prefill_program(
    params: dict,
    config: DotsOCRConfig,
    paged: PagedKV,
    input_ids: torch.Tensor,
    seq_lens: torch.Tensor,
    slot_mapping: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    any_sampled: bool,
    patches: Optional[torch.Tensor] = None,
    pos2d: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    scatter_batch: Optional[torch.Tensor] = None,
    scatter_pos: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Prefill one batch into the paged cache (in place) and sample each
    row's first token. input_ids [B, T]; seq_lens [B]; slot_mapping
    [B*T] (-1 = padding). 2D-RoPE tables are computed on the device from
    ``pos2d`` [T_vis, 2]. Returns first tokens [B] on the device."""
    b, t = input_ids.shape
    rope_cos = rope_sin = None
    if pos2d is not None:
        rope_cos, rope_sin = vision_rope_device(
            pos2d, config.vision.head_dim, config.vision.rope_theta
        )
    positions = torch.arange(t, device=input_ids.device).expand(b, t)
    logits, k, v = vlm_prefill(
        params, config, input_ids, positions, seq_lens, patches=patches,
        rope_cos=rope_cos, rope_sin=rope_sin, segment_ids=segment_ids,
        scatter_batch=scatter_batch, scatter_pos=scatter_pos,
        last_logit_only=True,
    )
    write_prefill_kv(paged, k, v, slot_mapping)
    return sample_logits(logits, temperature, top_p, generator, any_sampled)


def decode_program(
    params: dict,
    config: DotsOCRConfig,
    paged: PagedKV,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    page_tables: torch.Tensor,
    active: torch.Tensor,
    budgets: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    any_sampled: bool,
    page_size: int,
    num_steps: int,
) -> torch.Tensor:
    """``num_steps`` decode iterations for every slot, all on the device.

    tokens/positions [S] int64: each slot's current token and its cache
    write position; page_tables [S, max_pages] int32 must cover
    positions + num_steps; active [S] bool; budgets [S] int64 tokens each
    row may still emit. A row stops at EOS or at its budget; stopped and
    inactive rows write the null page with length 0 (the kernel returns
    zeros for them). Returns packed [S, num_steps + 1] int64: the sampled
    tokens (pad after a row stopped) and, last, each row's emitted count.
    """
    eos = config.special.eos_token_id
    s = tokens.shape[0]
    rows = torch.arange(s, device=tokens.device)
    tokens_out = torch.full((s, num_steps), config.special.pad_token_id,
                            dtype=torch.int64, device=tokens.device)
    num_decoded = torch.zeros(s, dtype=torch.int64, device=tokens.device)
    done = ~active
    current, pos = tokens, positions
    for i in range(num_steps):
        live = ~done
        write_pos = torch.where(live, pos, 0)
        page = page_tables[rows, write_pos // page_size].to(torch.int64)
        slots = torch.where(live, page * page_size + write_pos % page_size, 0)
        seq_lens = torch.where(live, pos + 1, 0).to(torch.int32)
        hidden = decoder_decode_step_paged(
            params["decoder"], config.decoder,
            embed_tokens(params["decoder"], current), write_pos,
            paged.k, paged.v, page_tables, seq_lens, slots, page_size,
            k_scales=paged.k_scale, v_scales=paged.v_scale,
        )
        logits = logits_from_hidden(params["decoder"], config.decoder, hidden)
        nxt = sample_logits(logits, temperature, top_p, generator, any_sampled)
        tokens_out[:, i] = torch.where(live, nxt, tokens_out[:, i])
        num_decoded += live.to(torch.int64)
        pos = pos + live.to(torch.int64)
        current = torch.where(live, nxt, current)
        done = done | (live & ((nxt == eos) | (num_decoded >= budgets)))
    return torch.cat([tokens_out, num_decoded[:, None]], dim=1)


def encode_program(params: dict, config: DotsOCRConfig, patches: torch.Tensor,
                   pos2d: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """Vision encoder for one request's packed images -> merged tokens
    [T_pad / merge^2, D_llm] (2D-RoPE tables made on the device)."""
    cos, sin = vision_rope_device(pos2d, config.vision.head_dim, config.vision.rope_theta)
    return encode_images(params["vision"], config.vision, patches, cos, sin, segment_ids)


def prefill_extend_program(
    params: dict,
    config: DotsOCRConfig,
    paged: PagedKV,
    embeds_chunk: torch.Tensor,
    prompt_len: torch.Tensor,
    page_table: torch.Tensor,
    slots: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    any_sampled: bool,
    page_size: int,
    kv_hi: int,
    q_offset: int,
) -> torch.Tensor:
    """One lockstep chunk of a chunked prefill for a batch of requests.

    embeds_chunk [B, C, D] (slices of each request's spliced embeddings;
    rows past a prompt are padding); prompt_len [B]; page_table
    [B, kv_hi / page_size]; slots [B, C] write slots (padding -> the null
    page). Samples a candidate first token from each row's last valid
    position in the chunk; the host keeps it on a row's final chunk.
    Returns first tokens [B] on the device."""
    b, c, _ = embeds_chunk.shape
    positions = q_offset + torch.arange(c, device=embeds_chunk.device)
    hidden = decoder_prefill_extend_batched(
        params["decoder"], config.decoder, embeds_chunk, positions, prompt_len,
        paged.k, paged.v, page_table, slots, page_size, kv_hi, q_offset,
        k_scales=paged.k_scale, v_scales=paged.v_scale,
    )
    last_row = (prompt_len.long() - 1 - q_offset).clamp(0, c - 1)
    hidden = hidden[torch.arange(b, device=hidden.device), last_row]
    logits = logits_from_hidden(params["decoder"], config.decoder, hidden)
    return sample_logits(logits, temperature, top_p, generator, any_sampled)


def spec_decode_program(
    params: dict,
    config: DotsOCRConfig,
    paged: PagedKV,
    tokens_buf: torch.Tensor,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    gen_start: torch.Tensor,
    page_tables: torch.Tensor,
    active: torch.Tensor,
    budgets: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    any_sampled: bool,
    nucleus: bool,
    page_size: int,
    num_steps: int,
    spec_k: int,
) -> torch.Tensor:
    """``num_steps`` speculative iterations for every slot, on the device.

    Per iteration and live slot: (1) draft: the most recent position of
    the slot's generated history whose bigram matches (previous, current)
    proposes the ``spec_k`` tokens that followed it (``current`` repeated
    when nothing matches); (2) verify: one decoder forward over the
    ``spec_k + 1`` tokens through the multi-query paged kernel; (3)
    accept: :func:`sampling.spec_accept`. Emits 1 to ``spec_k + 1`` tokens
    per live slot and iteration; a row stops at EOS or its budget.

    tokens_buf [S, L + 1] int64 generated history by logical position (L =
    the page table's token capacity; the last column is a sink for
    dropped writes), updated in place; gen_start [S]
    first generated position (the prompt length); other arguments as in
    :func:`decode_program`, with page tables covering positions +
    num_steps * (spec_k + 1). Returns packed [S, num_steps * (spec_k + 1)
    + 1] int64: emitted tokens, then each row's count.
    """
    eos, pad = config.special.eos_token_id, config.special.pad_token_id
    s, length_buf = tokens_buf.shape[0], tokens_buf.shape[1] - 1
    nq = spec_k + 1
    capacity = page_tables.shape[1] * page_size
    dev = tokens.device
    rows = torch.arange(s, device=dev)
    offs = torch.arange(nq, device=dev)
    tpos = torch.arange(length_buf, device=dev)
    out = torch.full((s, num_steps * nq + 1), pad, dtype=torch.int64, device=dev)
    n_out = torch.zeros(s, dtype=torch.int64, device=dev)
    done = ~active
    current, pos, buf = tokens, positions, tokens_buf
    for _ in range(num_steps):
        live = ~done
        buf[rows, pos.clamp(0, length_buf - 1)] = current
        prev = buf[rows, (pos - 1).clamp(0, length_buf - 1)]
        hist = buf[:, :length_buf]
        b_prev = torch.nn.functional.pad(hist[:, :-1], (1, 0))  # b_prev[:, t] = hist[:, t - 1]
        match = ((b_prev == prev[:, None]) & (hist == current[:, None])
                 & (tpos[None] >= gen_start[:, None] + 1) & (tpos[None] <= pos[:, None] - 1))
        t_star = torch.where(match, tpos[None], -1).amax(dim=1)
        didx = t_star[:, None] + offs[None, 1:]
        draft = hist.gather(1, didx.clamp(0, length_buf - 1))
        draft = torch.where((t_star >= 0)[:, None] & (didx <= pos[:, None]), draft, current[:, None])
        x_all = torch.cat([current[:, None], draft], dim=1)  # [S, nq]

        # Writes past the table's capacity (a row at its token envelope)
        # go to the null page instead of wrapping onto a live slot.
        pos_all = pos[:, None] + offs[None, :]
        writes = live[:, None] & (pos_all < capacity)
        write_pos = torch.where(writes, pos_all, 0)
        page = page_tables.gather(1, write_pos // page_size).to(torch.int64)
        slots = torch.where(writes, page * page_size + write_pos % page_size, 0)
        seq_lens = torch.where(live, pos + 1, 0).to(torch.int32)
        hidden = decoder_spec_step_paged(
            params["decoder"], config.decoder, embed_tokens(params["decoder"], x_all),
            write_pos, paged.k, paged.v, page_tables, seq_lens, slots, page_size,
            k_scales=paged.k_scale, v_scales=paged.v_scale,
        )
        logits = logits_from_hidden(params["decoder"], config.decoder, hidden)
        a, corrective = spec_accept(logits, x_all, temperature, top_p, generator,
                                    any_sampled, nucleus)

        y = torch.cat([x_all[:, 1:], torch.full_like(x_all[:, :1], pad)], dim=1)
        y[rows, a] = corrective
        is_eos = (y == eos) & (offs[None, :] <= a[:, None])
        eos_idx = torch.where(is_eos, offs[None, :], nq).amin(dim=1)
        m = torch.minimum(torch.minimum(a + 1, eos_idx + 1), budgets - n_out)
        m = torch.where(live, m, 0)
        val = offs[None, :] < m[:, None]
        out[rows[:, None], torch.where(val, n_out[:, None] + offs[None, :], num_steps * nq)] = y
        bpos = pos[:, None] + 1 + offs[None, :]
        buf[rows[:, None], torch.where(val & (bpos < length_buf), bpos, length_buf)] = y
        n_out = n_out + m
        last = y[rows, (m - 1).clamp(0, nq - 1)]
        current = torch.where(live & (m > 0), last, current)
        pos = pos + m
        done = done | (live & ((eos_idx < nq) | (n_out >= budgets)))
    out[:, -1] = n_out
    return out


WAITING, PREFILLING, RUNNING, FINISHED = "waiting", "prefilling", "running", "finished"


@dataclasses.dataclass
class SchedulerConfig:
    num_pages: int = 512
    page_size: int = 64
    max_slots: int = 16
    max_pages_per_seq: int = 128
    prompt_bucket_step: int = 128
    vision_bucket_step: int = 512
    # Admission watermark: keep this fraction of pages free for decode growth.
    admit_free_page_fraction: float = 0.05
    # Decode iterations per host sync.
    steps_per_sync: int = 8
    # Requests prefilled per dispatch.
    max_prefill_batch: int = 4
    # Decode-degeneration guard: stop a sequence whose tail is a periodic
    # token loop (period <= max_period repeating >= min_repeats times).
    # 0 disables.
    repetition_max_period: int = 64
    repetition_min_repeats: int = 8
    # Chunked prefill: prompts longer than this many tokens (rounded up to a
    # page multiple) are admitted as PREFILLING and their decoder forward
    # runs one chunk of this size per step, between decode chunks.
    # 0 = monolithic prefill only.
    prefill_chunk_tokens: int = 0
    # n-gram speculative decoding: > 0 verifies this many drafted tokens per
    # decode iteration (spec_decode_program). 0 = off.
    speculate_k: int = 0
    # Adaptive cut-off: speculation turns off for the current load after 3
    # consecutive chunks whose EWMA of emitted tokens per slot-iteration is
    # below this, and re-probes when the engine drains. <= 0 disables.
    spec_min_tokens_per_iter: float = 1.5
    # "bf16" (the model dtype) or "int8" (int8 pools + float32 scales).
    kv_cache_dtype: str = "bf16"


@dataclasses.dataclass
class ScheduledRequest:
    req_id: int
    prompt_ids: List[int]
    packed: Any  # PackedVisionInput or None
    max_new_tokens: int
    temperature: float
    top_p: float
    state: str = WAITING
    slot: int = -1
    output_ids: List[int] = dataclasses.field(default_factory=list)
    # Tokens generated before a preemption (they moved into prompt_ids);
    # the client-visible output is prior_output + output_ids.
    prior_output: List[int] = dataclasses.field(default_factory=list)
    preempted: int = 0
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    finished_reason: Optional[str] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    stop: List[str] = dataclasses.field(default_factory=list)
    stop_token_ids: frozenset = frozenset()
    # Called from the engine thread with (text_delta, finish_reason|None);
    # finish_reason is non-None exactly once, on the final call.
    stream_cb: Optional[Any] = None
    # Incremental detokenizer (only requests with stop strings or a stream).
    detok: Any = None
    text: str = ""
    emitted_len: int = 0
    detok_count: int = 0
    final_text: Optional[str] = None
    # Chunked prefill (PREFILLING only): the prompt's embeddings on the
    # device ([t_bucket, D], vision spliced) and the prompt tokens already
    # extended into the cache.
    embeds: Any = None
    prefill_pos: int = 0

    def timing(self) -> Dict[str, float]:
        """Millisecond latency split (0.0 for markers never reached)."""
        sub = self.submitted_at
        adm = self.admitted_at or sub
        ft = self.first_token_at
        fin = self.finished_at
        return {
            "queue_ms": max(0.0, (adm - sub) * 1e3),
            "ttft_ms": max(0.0, (ft - sub) * 1e3) if ft else 0.0,
            "prefill_ms": max(0.0, (ft - adm) * 1e3) if ft else 0.0,
            "decode_ms": max(0.0, (fin - ft) * 1e3) if ft and fin else 0.0,
            "total_ms": max(0.0, (fin - sub) * 1e3) if fin else 0.0,
        }


@dataclasses.dataclass
class RequestStats:
    prompt_tokens: int = 0
    completion_tokens: int = 0


def default_tokenizer(config: DotsOCRConfig) -> TokenizerLike:
    """Byte tokenizer on the config's special ids (no checkpoint needed)."""
    sp = config.special
    return ByteTokenizer(
        special_ids={
            "<|endoftext|>": sp.pad_token_id,
            "<|im_start|>": sp.im_start_id,
            "<|im_end|>": sp.im_end_id,
            "<|img|>": sp.img_id,
            "<|imgpad|>": sp.imgpad_id,
            "<|endofimg|>": sp.endofimg_id,
        },
        vocab_size=config.decoder.vocab_size,
    )


class ContinuousBatchingEngine:
    """Paged continuous-batching engine with the surface the JAX package's
    ``OpenAIServer`` and ``EngineWorker`` use."""

    def __init__(
        self,
        params: dict,
        config: DotsOCRConfig,
        device: torch.device,
        tokenizer: Optional[TokenizerLike] = None,
        sched: Optional[SchedulerConfig] = None,
        default_max_new_tokens: int = 16384,
    ):
        self.params = params
        self.config = config
        self.device = torch.device(device)
        self.tokenizer = tokenizer or default_tokenizer(config)
        self.sched = sched or SchedulerConfig()
        if self.sched.prefill_chunk_tokens > 0:
            ps = self.sched.page_size
            rounded = -(-self.sched.prefill_chunk_tokens // ps) * ps
            self.sched = dataclasses.replace(self.sched, prefill_chunk_tokens=rounded)
        if self.sched.kv_cache_dtype == "int8" and self.sched.page_size % 128:
            # The JAX package's warning, for its rule that the port keeps
            # (paged_attention.choose_paged_kernel).
            logger.warning(
                "int8 KV with page_size %d: decode steps fall back from the "
                "multi-page kernel to the slower v1 kernel (verify steps to "
                "the XLA reference), as in the JAX package — prefer page_size 128+",
                self.sched.page_size,
            )
        self.default_max_new_tokens = default_max_new_tokens
        # Sampled rows draw from one engine-wide generator; per-request
        # seeded streams are not ported yet (submit rejects ``seed``).
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        if self.sched.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype {self.sched.kv_cache_dtype!r} not in (bf16, int8)")
        self.paged = PagedKV.create(
            config.decoder, self.sched.num_pages, self.sched.page_size,
            dtype=config.torch_dtype, device=self.device,
            quantized=self.sched.kv_cache_dtype == "int8",
        )
        self.allocator = PageAllocator(
            num_pages=self.sched.num_pages,
            page_size=self.sched.page_size,
            max_pages_per_seq=self.sched.max_pages_per_seq,
        )
        s = self.sched.max_slots
        self._slot_req: List[Optional[ScheduledRequest]] = [None] * s
        self._tokens = np.zeros(s, np.int64)   # current (not yet cached) token
        self._lengths = np.zeros(s, np.int64)  # tokens in cache per slot
        self._temps = np.zeros(s, np.float32)
        self._top_ps = np.ones(s, np.float32)
        self._waiting: Deque[ScheduledRequest] = deque()
        self._finished: Dict[int, ScheduledRequest] = {}
        self._next_id = 0
        # Last-N finished-request latency splits, read by /metrics.
        self.recent_timings: Deque[Dict[str, float]] = deque(maxlen=512)
        # Adaptive speculation: EWMA of emitted tokens per verify
        # slot-iteration, consecutive below-threshold chunks, the gate.
        self._spec_ewma: Optional[float] = None
        self._spec_low_streak = 0
        self._spec_enabled = True
        self.metrics = {
            "steps": 0,
            "prefills": 0,
            "prefill_chunks": 0,
            "generated_tokens": 0,
            "spec_chunks": 0,
            "spec_emitted": 0,     # tokens emitted by verify chunks
            "spec_slot_iters": 0,  # acceptance = emitted / (iters * (k + 1))
            "spec_auto_disabled": 0,
            "preemptions": 0,
            "t_submit_s": 0.0,   # tokenize + image preprocessing
            "t_admit_s": 0.0,    # admission incl. monolithic prefill / chunk embeds
            "t_prefill_s": 0.0,  # chunked-prefill chunks
            "t_decode_s": 0.0,   # decode chunks incl. the packed fetch
        }

    # -- submission ----------------------------------------------------

    def submit(
        self,
        prompt: str,
        images: Sequence = (),
        max_new_tokens: Optional[int] = None,
        temperature: float = 0.1,
        top_p: float = 1.0,
        system_prompt: Optional[str] = None,
        min_pixels: Optional[int] = None,
        max_pixels: Optional[int] = None,
        stop: Optional[Sequence[str]] = None,
        stop_token_ids: Optional[Sequence[int]] = None,
        seed: Optional[int] = None,
        logprobs: bool = False,
        presence_penalty: float = 0.0,
        frequency_penalty: float = 0.0,
        logit_bias: Optional[Dict[int, float]] = None,
        stream_cb=None,
        prepared=None,
    ) -> int:
        """Queue a request; returns its id. ``prepared`` is a
        :meth:`prepare` result built off the engine thread."""
        for name, value in (("seed", seed is not None), ("logprobs", logprobs),
                            ("presence_penalty", presence_penalty),
                            ("frequency_penalty", frequency_penalty),
                            ("logit_bias", logit_bias)):
            if value:
                raise ValueError(_not_ported(name))
        if prepared is None:
            t_sub = time.perf_counter()
            prepared = self.prepare(prompt, images, system_prompt=system_prompt,
                                    min_pixels=min_pixels, max_pixels=max_pixels)
            self.metrics["t_submit_s"] += time.perf_counter() - t_sub
        stop = [s for s in (stop or []) if s]
        req = ScheduledRequest(
            req_id=self._next_id,
            prompt_ids=prepared.prompt_ids,
            packed=prepared.packed,
            max_new_tokens=max_new_tokens or self.default_max_new_tokens,
            temperature=temperature,
            top_p=top_p,
            stop=stop,
            stop_token_ids=frozenset(int(t) for t in (stop_token_ids or [])),
            stream_cb=stream_cb,
            detok=(IncrementalDetokenizer(self.tokenizer)
                   if (stop or stream_cb is not None) else None),
        )
        self._next_id += 1
        # A prompt that can never fit must fail fast, not block admission;
        # so must one that leaves no room for a generated token.
        cap_tokens = self.sched.max_pages_per_seq * self.sched.page_size - 1
        need = self.allocator.pages_needed(len(req.prompt_ids) + 1)
        budget = cap_tokens - len(req.prompt_ids)
        if need > self.sched.num_pages - 1 or budget < 1:
            logger.error("request %d rejected: prompt of %d tokens does not fit",
                         req.req_id, len(req.prompt_ids))
            req.state = FINISHED
            req.finished_reason = "prompt_too_long"
            self._finished[req.req_id] = req
            if req.stream_cb is not None:
                req.stream_cb("", "prompt_too_long")
            return req.req_id
        req.max_new_tokens = min(req.max_new_tokens, budget)
        self._waiting.append(req)
        return req.req_id

    def prepare(self, prompt: str, images: Sequence = (),
                system_prompt: Optional[str] = None,
                min_pixels: Optional[int] = None,
                max_pixels: Optional[int] = None):
        """Tokenize + preprocess a request off the engine thread."""
        return prepare_request(
            self.tokenizer, self.config, prompt, images,
            system_prompt=system_prompt, min_pixels=min_pixels,
            max_pixels=max_pixels, vision_bucket_step=self.sched.vision_bucket_step,
        )

    # -- stop strings / streaming ------------------------------------------

    def _detok_limit(self, req: ScheduledRequest) -> int:
        """Client-visible token count over prior_output + output_ids (a
        trailing EOS / stop-token id is excluded)."""
        total = len(req.prior_output) + len(req.output_ids)
        if req.output_ids and (req.output_ids[-1] == self.config.special.eos_token_id
                               or req.output_ids[-1] in req.stop_token_ids):
            return total - 1
        return total

    def _push_detok(self, req: ScheduledRequest) -> str:
        """Advance the detokenizer to the client-visible limit; tokens
        generated before a preemption are counted, never pushed twice."""
        upto = self._detok_limit(req)
        if upto <= req.detok_count:
            return ""
        plen = len(req.prior_output)
        if req.detok_count >= plen:
            chunk = req.output_ids[req.detok_count - plen:upto - plen]
        else:  # only right after a preemption replay
            chunk = req.prior_output[req.detok_count:] + req.output_ids[:max(0, upto - plen)]
        req.detok_count = upto
        return req.detok.push(chunk)

    def _update_text(self, slot: int) -> None:
        """Feed new tokens to the detokenizer, finish on a stop string
        (truncating it), and emit stream deltas."""
        req = self._slot_req[slot]
        if req is None or req.detok is None:
            return
        new = self._push_detok(req)
        if new:
            req.text += new
            if req.stop:
                longest = max(len(s) for s in req.stop)
                start = max(0, len(req.text) - len(new) - longest + 1)
                hits = [i for i in (req.text.find(s, start) for s in req.stop) if i >= 0]
                if hits:
                    req.text = req.text[: min(hits)]  # the stop string is excluded
                    req.final_text = req.text
                    self._finish(slot, "stop")
                    return
        self._emit_stream(req)

    def _emit_stream(self, req: ScheduledRequest, final: bool = False) -> None:
        if req.stream_cb is None:
            return
        if final:
            delta = req.text[req.emitted_len:]
            req.emitted_len = len(req.text)
            req.stream_cb(delta, req.finished_reason or "stop")
            return
        # Hold back any tail that could still become a stop-string match.
        hold = longest_stop_prefix_at_tail(req.text, req.stop) if req.stop else 0
        upto = len(req.text) - hold
        if upto > req.emitted_len:
            delta = req.text[req.emitted_len:upto]
            req.emitted_len = upto
            req.stream_cb(delta, None)

    # -- helpers ---------------------------------------------------------

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def has_work(self) -> bool:
        return bool(self._waiting) or any(r is not None for r in self._slot_req)

    def _bucket(self, n: int) -> int:
        step = self.sched.prompt_bucket_step
        return max(step, -(-n // step) * step)

    # -- admission -------------------------------------------------------

    def _chunked(self, req: ScheduledRequest) -> bool:
        ct = self.sched.prefill_chunk_tokens
        return ct > 0 and len(req.prompt_ids) > ct

    def _try_admit(self) -> None:
        """Admit waiting requests in order while slots and pages allow: a
        run of long (chunked) prompts together as PREFILLING, or a batch of
        short ones through one monolithic prefill."""
        watermark = int(self.sched.num_pages * self.sched.admit_free_page_fraction)
        while self._waiting and self._free_slots():
            room = min(self.sched.max_prefill_batch, len(self._free_slots()))
            budget = self.allocator.free_pages - watermark
            chunked = self._chunked(self._waiting[0])
            batch: List[ScheduledRequest] = []
            while self._waiting and len(batch) < room and self._chunked(self._waiting[0]) == chunked:
                need = self.allocator.pages_needed(len(self._waiting[0].prompt_ids) + 1)
                if need > budget:
                    break
                budget -= need
                batch.append(self._waiting.popleft())
            if not batch:
                return
            (self._admit_chunked if chunked else self._admit_batch)(batch)

    def _admit_chunked(self, reqs: List[ScheduledRequest]) -> None:
        """Park long requests in slots as PREFILLING: token embeddings for
        the group, then per request its vision encoder and splice. The
        bucket is a multiple of the chunk, so every chunk is an exact slice."""
        ct = self.sched.prefill_chunk_tokens
        t_bucket = max(-(-len(r.prompt_ids) // ct) * ct for r in reqs)
        input_ids = np.full((len(reqs), t_bucket), self.config.special.pad_token_id, np.int64)
        now = time.monotonic()
        for j, req in enumerate(reqs):
            input_ids[j, :len(req.prompt_ids)] = req.prompt_ids
            self.allocator.allocate(req.req_id, len(req.prompt_ids) + 1)
            req.admitted_at = req.admitted_at or now
        embeds = embed_tokens(self.params["decoder"], self._put(input_ids))
        merge = self.config.vision.spatial_merge_size**2
        for j, req in enumerate(reqs):
            packed = req.packed
            if packed is None:
                continue
            # Row-j scatter coordinates: built against the single row, then
            # its batch index remapped (0 -> j, the sentinel 1 -> B).
            sb, sp = build_scatter_indices(
                input_ids[j:j + 1], self.config.special.imgpad_id,
                packed.patches.shape[0] // merge, valid_rows=packed.merged_valid_rows(merge),
            )
            sb = np.where(sb == 0, j, len(reqs)).astype(np.int32)
            vision_tokens = encode_program(
                self.params, self.config, self._put(packed.patches),
                self._put(packed.pos2d), self._put(packed.segment_ids),
            )
            embeds = splice_vision_embeddings(embeds, vision_tokens, self._put(sb), self._put(sp))
            self.metrics["chunk_embeds"] = self.metrics.get("chunk_embeds", 0) + 1
        for slot, (j, req) in zip(self._free_slots(), enumerate(reqs)):
            req.embeds = embeds[j]
            req.state = PREFILLING
            req.slot = slot
            req.prefill_pos = 0
            self._slot_req[slot] = req
            self._lengths[slot] = 0
            self._temps[slot] = req.temperature
            self._top_ps[slot] = req.top_p

    def _run_prefill_chunk(self) -> None:
        """One decoder chunk for the lockstep group of PREFILLING requests
        at the smallest offset; a row's final chunk samples its first token
        and promotes it to RUNNING."""
        prefilling = [(i, r) for i, r in enumerate(self._slot_req)
                      if r is not None and r.state == PREFILLING]
        if not prefilling:
            return
        start = min(r.prefill_pos for _, r in prefilling)
        group = [(i, r) for i, r in prefilling if r.prefill_pos == start]
        group = group[: self.sched.max_prefill_batch]
        ct, ps = self.sched.prefill_chunk_tokens, self.sched.page_size
        kv_hi = start + ct  # both multiples of page_size
        width = kv_hi // ps
        n = len(group)
        tables = np.zeros((n, width), np.int32)
        slots = np.zeros((n, ct), np.int64)  # padding -> the null page's slot 0
        plens = np.zeros(n, np.int64)
        for j, (_, req) in enumerate(group):
            plens[j] = len(req.prompt_ids)
            full = self.allocator.padded_table(req.req_id)
            m = min(width, len(full))
            tables[j, :m] = full[:m]
            n_valid = min(ct, len(req.prompt_ids) - start)
            slots[j, :n_valid] = self.allocator.slot_mapping(req.req_id, start, n_valid)
        temps = np.array([r.temperature for _, r in group], np.float32)
        first = prefill_extend_program(
            self.params, self.config, self.paged,
            torch.stack([r.embeds[start:start + ct] for _, r in group]),
            self._put(plens), self._put(tables), self._put(slots), self._put(temps),
            self._put(np.array([r.top_p for _, r in group], np.float32)),
            self.generator, bool(np.any(temps > 0)), page_size=ps, kv_hi=kv_hi, q_offset=start,
        )
        self.metrics["prefill_chunks"] += 1
        first_host = None
        for j, (slot, req) in enumerate(group):
            req.prefill_pos += ct
            if req.prefill_pos < len(req.prompt_ids):
                continue
            if first_host is None:
                first_host = first.cpu().numpy()  # one fetch per chunk
            token = int(first_host[j])
            req.embeds = None
            req.state = RUNNING
            req.output_ids = [token]
            req.first_token_at = req.first_token_at or time.monotonic()
            self._tokens[slot] = token
            self._lengths[slot] = len(req.prompt_ids)
            self.metrics["prefills"] += 1
            self._update_text(slot)  # may finish on a stop string
            self._maybe_finish(slot)

    def _admit_batch(self, reqs: List[ScheduledRequest]) -> None:
        """Prefill a batch in one dispatch and promote it to RUNNING."""
        n = len(reqs)
        slots = self._free_slots()[:n]
        t_bucket = self._bucket(max(len(r.prompt_ids) for r in reqs))
        input_ids = np.full((n, t_bucket), self.config.special.pad_token_id, np.int64)
        seq_lens = np.zeros(n, np.int64)
        slot_mapping = np.full((n, t_bucket), -1, np.int64)
        now = time.monotonic()
        for j, req in enumerate(reqs):
            req.admitted_at = req.admitted_at or now
            plen = len(req.prompt_ids)
            input_ids[j, :plen] = req.prompt_ids
            seq_lens[j] = plen
            self.allocator.allocate(req.req_id, plen + 1)
            slot_mapping[j, :plen] = self.allocator.slot_mapping(req.req_id, 0, plen)

        vision = {}
        packs = [r.packed for r in reqs if r.packed is not None]
        if packs:
            merged = merge_packed(packs, self.config.vision,
                                  bucket_step=self.sched.vision_bucket_step)
            merge = self.config.vision.spatial_merge_size**2
            sb, sp = build_scatter_indices(
                input_ids, self.config.special.imgpad_id,
                merged.patches.shape[0] // merge,
                valid_rows=merged.merged_valid_rows(merge),
            )
            vision = dict(
                patches=self._put(merged.patches), pos2d=self._put(merged.pos2d),
                segment_ids=self._put(merged.segment_ids),
                scatter_batch=self._put(sb), scatter_pos=self._put(sp),
            )
        temps = np.array([r.temperature for r in reqs], np.float32)
        first = prefill_program(
            self.params, self.config, self.paged, self._put(input_ids),
            self._put(seq_lens), self._put(slot_mapping.reshape(-1)),
            self._put(temps), self._put(np.array([r.top_p for r in reqs], np.float32)),
            self.generator, bool(np.any(temps > 0)), **vision,
        ).cpu().numpy()

        for j, req in enumerate(reqs):
            slot = slots[j]
            token = int(first[j])
            req.state = RUNNING
            req.slot = slot
            req.output_ids = [token]
            req.first_token_at = req.first_token_at or time.monotonic()
            self._slot_req[slot] = req
            self._tokens[slot] = token
            self._lengths[slot] = len(req.prompt_ids)
            self._temps[slot] = req.temperature
            self._top_ps[slot] = req.top_p
            self.metrics["prefills"] += 1
            self._update_text(slot)  # may finish on a stop string
            self._maybe_finish(slot)

    # -- finishing -------------------------------------------------------

    def _maybe_finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        if req is None:
            return
        last = req.output_ids[-1]
        if last == self.config.special.eos_token_id or last in req.stop_token_ids:
            self._finish(slot, "stop")
        elif len(req.output_ids) >= req.max_new_tokens:
            self._finish(slot, "length")
        elif self.sched.repetition_min_repeats > 0:
            period = detect_repetition(
                req.output_ids,
                max_period=self.sched.repetition_max_period,
                min_repeats=self.sched.repetition_min_repeats,
            )
            if period is not None:
                logger.warning("request %d stuck in a period-%d token loop after "
                               "%d tokens; stopping", req.req_id, period,
                               len(req.output_ids))
                self.metrics["repetition_stops"] = self.metrics.get("repetition_stops", 0) + 1
                self._finish(slot, "repetition")

    def _finish(self, slot: int, reason: str) -> None:
        req = self._slot_req[slot]
        req.state = FINISHED
        req.finished_reason = reason
        req.finished_at = time.monotonic()
        self.recent_timings.append(req.timing())
        req.embeds = None  # a PREFILLING request's device embeddings
        if req.detok is not None and req.final_text is None:
            req.text += self._push_detok(req)
            req.text += req.detok.flush()
            req.final_text = req.text
        if req.detok is not None:
            self._emit_stream(req, final=True)
        self.allocator.free(req.req_id)
        self._finished[req.req_id] = req
        self._slot_req[slot] = None
        self._lengths[slot] = 0

    def cancel(self, req_id: int) -> bool:
        """Abort a waiting or running request; it finishes 'cancelled'.
        Returns False if the id is unknown or already done."""
        for req in list(self._waiting):
            if req.req_id == req_id:
                self._waiting.remove(req)
                req.state = FINISHED
                req.finished_reason = "cancelled"
                self._finished[req_id] = req
                self._emit_stream(req, final=True)
                return True
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.req_id == req_id:
                self._finish(slot, "cancelled")
                return True
        return False

    def _preempt_youngest(self) -> None:
        """Recompute preemption: the youngest request in a slot goes back to
        the head of the waiting queue with prompt := prompt + generated so
        far; its pages are freed. A PREFILLING victim restarts its prefill
        (chunk progress and device embeddings dropped)."""
        candidates = [r for r in self._slot_req if r is not None]
        if not candidates:
            raise OutOfPages("no pages free and nothing to preempt")
        victim = max(candidates, key=lambda r: r.submitted_at)
        slot = victim.slot
        self.allocator.free(victim.req_id)
        self._slot_req[slot] = None
        self._lengths[slot] = 0
        victim.embeds = None
        victim.prefill_pos = 0
        victim.prompt_ids = victim.prompt_ids + victim.output_ids
        victim.max_new_tokens = max(1, victim.max_new_tokens - len(victim.output_ids))
        victim.prior_output = victim.prior_output + victim.output_ids
        victim.output_ids = []
        victim.state = WAITING
        victim.slot = -1
        victim.preempted += 1
        self.metrics["preemptions"] += 1
        self._waiting.appendleft(victim)

    # -- the step --------------------------------------------------------

    def step(self) -> List[ScheduledRequest]:
        """Admit, at most one chunked-prefill chunk, then one decode chunk
        (speculative while enabled). Returns newly finished requests."""
        before = set(self._finished)
        t0 = time.perf_counter()
        self._try_admit()
        t1 = time.perf_counter()
        self.metrics["t_admit_s"] += t1 - t0
        self._run_prefill_chunk()
        t2 = time.perf_counter()
        self.metrics["t_prefill_s"] += t2 - t1
        active = [i for i, r in enumerate(self._slot_req)
                  if r is not None and r.state == RUNNING]
        if active:
            self._decode_chunk(active)
            self.metrics["t_decode_s"] += time.perf_counter() - t2
        if not self._spec_enabled and not self.has_work():
            # Drained: give the next load a fresh speculation probe.
            self._spec_enabled, self._spec_ewma, self._spec_low_streak = True, None, 0
        return [self._finished[rid] for rid in set(self._finished) - before]

    def _update_spec_gate(self, emitted: int, chunk: int, n_active: int) -> None:
        """EWMA of emitted tokens per verify slot-iteration; 3 consecutive
        chunks below ``spec_min_tokens_per_iter`` turn speculation off for
        the current load."""
        floor = self.sched.spec_min_tokens_per_iter
        if floor <= 0 or not self._spec_enabled:
            return
        per_iter = emitted / max(1, chunk * n_active)
        self._spec_ewma = (per_iter if self._spec_ewma is None
                           else 0.7 * self._spec_ewma + 0.3 * per_iter)
        if self._spec_ewma >= floor:
            self._spec_low_streak = 0
            return
        self._spec_low_streak += 1
        if self._spec_low_streak >= 3:
            self._spec_enabled = False
            self.metrics["spec_auto_disabled"] += 1
            logger.info("speculation auto-disabled: %.2f tokens/slot-iter below the %.2f "
                        "break-even (re-probes when the engine drains)", self._spec_ewma, floor)

    def _decode_chunk(self, active: List[int]) -> None:
        s, chunk = self.sched.max_slots, self.sched.steps_per_sync
        spec_k = self.sched.speculate_k if self._spec_enabled else 0
        per_iter = spec_k + 1
        cap = self.sched.max_pages_per_seq * self.sched.page_size
        # Pass 1: reserve the chunk's pages per slot. The target is clamped
        # to the per-sequence capacity (submit clamps the token budget), so
        # OutOfPages here always means pool pressure: preempt the youngest
        # request and retry. Preemption may clear any slot, also one that
        # already reserved, so the live set is re-read for pass 2.
        for i in active:
            req = self._slot_req[i]
            if req is None:  # preempted by an earlier iteration
                continue
            target = min(int(self._lengths[i]) + chunk * per_iter, cap)
            while True:
                try:
                    self.allocator.extend(req.req_id, target)
                    break
                except OutOfPages:
                    self._preempt_youngest()
                    if self._slot_req[i] is None:
                        break  # this row preempted itself
        active = [i for i in active if self._slot_req[i] is not None]
        if not active:
            return
        # Pass 2: device inputs from host state.
        tables = np.zeros((s, self.sched.max_pages_per_seq), np.int32)
        positions = np.zeros(s, np.int64)
        budgets = np.zeros(s, np.int64)
        active_mask = np.zeros(s, bool)
        for i in active:
            req = self._slot_req[i]
            tables[i] = self.allocator.padded_table(req.req_id)
            positions[i] = self._lengths[i]
            budgets[i] = req.max_new_tokens - len(req.output_ids)
            active_mask[i] = True
        any_sampled = bool(np.any(self._temps[active] > 0))
        common = dict(page_tables=self._put(tables), active=self._put(active_mask),
                      budgets=self._put(budgets), temperature=self._put(self._temps),
                      top_p=self._put(self._top_ps), generator=self.generator,
                      any_sampled=any_sampled, page_size=self.sched.page_size,
                      num_steps=chunk)
        if spec_k:
            # Generated history by logical position (the draft source),
            # plus the sink column; rebuilt from host state every chunk.
            # After a preemption gen_start is the grown prompt's length and
            # the history holds only the tokens generated since.
            buf = np.zeros((s, cap + 1), np.int64)
            gen_start = np.zeros(s, np.int64)
            for i in active:
                req = self._slot_req[i]
                plen = len(req.prompt_ids)
                gen_start[i] = plen
                end = min(plen + len(req.output_ids), cap)
                buf[i, plen:end] = req.output_ids[: end - plen]
            packed = spec_decode_program(
                self.params, self.config, self.paged, self._put(buf), self._put(self._tokens),
                self._put(positions), self._put(gen_start),
                nucleus=bool(np.any(self._top_ps[active] < 1.0)), spec_k=spec_k, **common,
            ).cpu().numpy()  # the chunk's one host sync
            self.metrics["spec_chunks"] += 1
            self.metrics["spec_slot_iters"] += chunk * len(active)
            emitted = int(packed[active, -1].sum())
            self.metrics["spec_emitted"] += emitted
            self._update_spec_gate(emitted, chunk, len(active))
        else:
            packed = decode_program(
                self.params, self.config, self.paged, self._put(self._tokens),
                self._put(positions), **common,
            ).cpu().numpy()  # the chunk's one host sync
        self.metrics["steps"] += 1
        eos = self.config.special.eos_token_id
        for i in active:
            req = self._slot_req[i]
            n = int(packed[i, -1])
            self._lengths[i] += n
            for token in packed[i, :n].tolist():
                req.output_ids.append(token)
                self.metrics["generated_tokens"] += 1
                if (token == eos or token in req.stop_token_ids
                        or len(req.output_ids) >= req.max_new_tokens):
                    break
            self._tokens[i] = req.output_ids[-1]
            self._update_text(i)  # may finish on a stop string
            self._maybe_finish(i)

    def run(self, max_steps: int = 10_000_000) -> None:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1

    # -- convenience (InferenceEngine-compatible surface) -----------------

    @property
    def last_stats(self) -> RequestStats:
        return RequestStats(completion_tokens=self.metrics["generated_tokens"])

    def generate_batch(
        self,
        prompts: Sequence[str],
        images_per_prompt: Sequence[Sequence] = (),
        temperature=0.1,
        top_p=1.0,
        max_new_tokens: Optional[int] = None,
        system_prompt: Optional[str] = None,
        min_pixels: Optional[int] = None,
        max_pixels: Optional[int] = None,
        seed=None,
        stop: Optional[Sequence[str]] = None,
    ) -> List[str]:
        if seed is not None:
            raise ValueError(_not_ported("seed"))
        n = len(prompts)
        images_per_prompt = images_per_prompt or [[] for _ in range(n)]
        temps = np.broadcast_to(np.asarray(temperature, np.float32), (n,))
        tps = np.broadcast_to(np.asarray(top_p, np.float32), (n,))
        ids = [
            self.submit(prompts[i], images=images_per_prompt[i],
                        max_new_tokens=max_new_tokens, temperature=float(temps[i]),
                        top_p=float(tps[i]), system_prompt=system_prompt,
                        min_pixels=min_pixels, max_pixels=max_pixels, stop=stop)
            for i in range(n)
        ]
        self.run()
        return [self.request_text(rid) for rid in ids]

    def finished_request(self, req_id: int):
        """The finished ScheduledRequest for req_id, or None."""
        return self._finished.get(req_id)

    def take_finished(self, req_id: int) -> Optional[str]:
        """Final text of a finished request, removing it from the engine
        (long-lived servers must not accumulate finished requests)."""
        if req_id not in self._finished:
            return None
        text = self.request_text(req_id)
        del self._finished[req_id]
        return text

    def request_text(self, req_id: int) -> str:
        """Final text of a finished request (stop-string truncation applied)."""
        req = self._finished[req_id]
        if req.final_text is not None:
            return req.final_text
        toks = req.prior_output + req.output_ids
        if toks and (toks[-1] == self.config.special.eos_token_id
                     or toks[-1] in req.stop_token_ids):
            toks = toks[:-1]
        return self.tokenizer.decode(toks, skip_special_tokens=True)
