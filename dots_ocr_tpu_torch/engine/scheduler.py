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
    paged decode kernel, with one packed fetch per chunk;
  * ``spec_decode_program`` (``speculate_k`` > 0): per iteration a bigram
    draft over each slot's generated history, one verify forward over the
    k + 1 tokens, and greedy / exact delta-proposal acceptance; an
    adaptive gate turns speculation off for the current load when it emits
    fewer than ``spec_min_tokens_per_iter`` tokens per slot-iteration.

Decode chunk inputs stay on the device between chunks: the programs return
the next tokens, positions and budgets as a device carry, and the host
rebuilds the inputs only on events (admission, finish, preemption, page
growth, a change of decode mode). Event-free decode deepens its chunks to
``max_steps_per_sync`` and pipelines them (lookahead-1): chunk N+1 is
dispatched off the carry before chunk N's packed result is read, and that
result travels to the host through a pinned buffer guarded by an event of
its own, so reading it never waits for chunk N+1. A chunk whose result
has not landed when ``step()`` returns stays in flight (held), and the
next step lands it before anything reads its results; while it is on the
device a waiting request is admitted beside it (a monolithic batch, in
slots outside the chunk's rows), its prefill queued behind the chunk on
the stream, and the chunk lands after. Driven by an EngineWorker
(``ContinuousBatchingEngine.arrivals``), chunks are not deepened, and a
step during which requests reached the worker leaves its decode chunk to
the next step, which admits them first. The inputs are fixed
buffers, one set per chunk mode (:class:`ChunkInputs`), refilled in place
on events; the programs write their carry back into them. On the card each
chunk configuration is captured once as a CUDA graph over those buffers and
replayed for every later chunk (``engine/graphs.py``), the counterpart of
the JAX engine's one compiled program a chunk; the warmup
(:meth:`ContinuousBatchingEngine.warmup_decode`, or queued and run on idle
ticks) captures every configuration ``step()`` can dispatch ahead of
traffic, as the JAX warmup compiles them.

Sampling is seeded and position-keyed, as in the JAX engine: each request
carries a key, ``PRNGKey(seed)`` for a seeded request and else a split of
the engine's chain (started at ``PRNGKey(0)``), and the draw for the token
at position q folds q into it (``sampling.fold_positions``), so a request's
sampled stream does not depend on what it is co-batched with, on chunk
boundaries, on speculation or on a preemption's replay. Requests may also
ask for logprobs (the chosen token's log-probability), presence/frequency
penalties (vLLM semantics, over a [S, V] counts carry) and
``logit_bias``. KV pools are bf16 or int8 (``kv_cache_dtype``); weights
may be int8 (``models/quantize.py``). Admission is page-aware (free-page
watermark); a pool that runs dry mid-decode preempts the youngest request
(recompute preemption: it re-queues with its generated tokens appended to
its prompt) and every request still finishes with the same greedy tokens.
Host code carries stop strings, stop ids, streaming and the repetition
guard.

While a torch profiler runs, :meth:`ContinuousBatchingEngine.step` records
its span tree (``utils/observability.py``): ``step`` > ``admit`` >
(``prepare_batch``, ``encode``, ``prefill``, ``first_fetch``),
``prefill_chunk``, ``decode`` > (``inputs``, ``dispatch``, ``fetch_wait``,
``apply``), the launching ones with a CUDA event pair. Every decode and
verify chunk also returns the context tokens the paged kernel read, which
``metrics["kv_tokens_read"]`` adds up. A MoE decoder (DeepSeek's, dots.vlm1)
also counts, on the device, the (token, expert) assignments that landed on
the experts this device holds and each layer's busiest held expert: the
decode chunks and the prefills return them beside their results, and
``metrics["moe_routed_here"]`` / ``["moe_busiest_expert"]`` add them up
(noted on the ``apply``, ``prefill`` and ``prefill_chunk`` spans).
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

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
from dots_ocr_tpu_torch.engine.graphs import ChunkKey, DecodeGraphs, chunk_key
from dots_ocr_tpu_torch.engine.request import prepare_request
from dots_ocr_tpu_torch.engine.sampling import (
    fold_positions,
    prng_key,
    sample_logits,
    spec_accept,
    split,
)
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.decoder import (
    decoder_decode_step_paged,
    decoder_prefill_extend_batched,
    decoder_spec_step_paged,
    embed_tokens,
    logits_from_hidden,
)
from dots_ocr_tpu_torch.models.preprocess import merge_packed
from dots_ocr_tpu_torch.models.quantize import has_int4_kernels
from dots_ocr_tpu_torch.models.rope import vision_rope_device
from dots_ocr_tpu_torch.models.vision import encode_images
from dots_ocr_tpu_torch.models.vlm import (
    build_scatter_indices,
    splice_vision_embeddings,
    vlm_prefill,
)
from dots_ocr_tpu_torch.ops.int4_matmul import int4_act_quant
from dots_ocr_tpu_torch.ops.paged_attention import choose_paged_kernel
from dots_ocr_tpu_torch.parallel.sharding import ROW_PARALLEL_PARTS
from dots_ocr_tpu_torch.utils.observability import SPANS

logger = logging.getLogger(__name__)

def add_logit_bias(logits: torch.Tensor, bias_ids: torch.Tensor,
                   bias_vals: torch.Tensor) -> torch.Tensor:
    """OpenAI ``logit_bias``, in place: each row's (token id, bias) pairs
    are added along the vocab (last) axis of logits [S, ..., V]; bias_ids /
    bias_vals [S, K]. An id equal to the vocab size is padding and adds
    nothing (it lands on the last id as +0.0)."""
    v = logits.shape[-1]
    vals = torch.where(bias_ids < v, bias_vals, 0.0)
    shape = (bias_ids.shape[0],) + (1,) * (logits.dim() - 2) + (bias_ids.shape[1],)
    out_shape = logits.shape[:-1] + (bias_ids.shape[1],)
    return logits.scatter_add_(-1, bias_ids.clamp_max(v - 1).view(shape).expand(out_shape),
                               vals.view(shape).expand(out_shape))


def step_keys(keys: torch.Tensor, positions: torch.Tensor, any_sampled: bool) -> torch.Tensor:
    """The rows' draw keys for tokens emitted at ``positions``
    (``fold_positions``: one launch of the threefry kernel on the card), for
    the verify, which folds them further; an all-greedy step draws nothing
    and skips it. The plain draws pass ``positions`` to the draw instead."""
    return fold_positions(keys, positions) if any_sampled else keys


def f32_bits(x: torch.Tensor) -> torch.Tensor:
    """float32 values as their int32 bit patterns in int64, so that they
    travel in a program's one packed int64 fetch."""
    return x.to(torch.float32).view(torch.int32).to(torch.int64)


def bits_f32(x: np.ndarray) -> np.ndarray:
    """Inverse of :func:`f32_bits` on the host."""
    return np.ascontiguousarray(x, np.int64).astype(np.int32).view(np.float32)


def token_logprob(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """log p(token) under logits [B, V] (float32) for tokens [B]."""
    return logits.gather(1, tokens[:, None])[:, 0] - torch.logsumexp(logits, dim=-1)


def _pack_first_with_logprob(first: torch.Tensor, logits: torch.Tensor,
                             moe: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B] first tokens -> [B, 2] int64 (token, logprob bits), then a MoE
    decoder's [B, 2] expert counts: the prefill's fetch stays one array."""
    packed = torch.stack([first, f32_bits(token_logprob(logits, first))], dim=1)
    return packed if moe is None else torch.cat([packed, moe], dim=1)


def moe_counters(config: DotsOCRConfig, rows: int, device) -> Optional[torch.Tensor]:
    """[rows, 2] int64 zeros that a MoE decoder's layers add their expert
    counts to (``models/moe.py::moe_block``: each row's assignments on the
    held experts, and in row 0 the busiest held expert's), or None."""
    if config.decoder.deepseek is None:
        return None
    return torch.zeros(rows, 2, dtype=torch.int64, device=device)


def image_work(segment_ids: np.ndarray) -> dict:
    """A packed vision input's work for a span: the patches of each image
    and the padded token count (host arrays only)."""
    seg = np.asarray(segment_ids)
    return {"patches": np.bincount(seg[seg >= 0]).tolist(), "t_vis": int(seg.shape[-1])}


class HostFetch:
    """A device tensor's copy on its way to the host.

    The copy is enqueued at once into a host buffer of its own (pinned on
    the card, with an event recorded right after the copy) and
    :meth:`numpy` waits for that event only. ``.cpu()`` would instead wait
    for everything queued on the stream by then, such as the next chunk a
    pipelined engine has already dispatched. On the CPU the same code
    copies into a pageable buffer and records no event."""

    def __init__(self, tensor: torch.Tensor):
        self.span = None  # the launching span, noted once the result has landed
        on_card = tensor.is_cuda
        self.host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=on_card)
        self.host.copy_(tensor, non_blocking=on_card)
        self.event = torch.cuda.Event() if on_card else None
        if self.event is not None:
            self.event.record()

    def landed(self) -> bool:
        """Whether the copy has completed (always, on the CPU)."""
        return self.event is None or self.event.query()

    def wait(self) -> None:
        """Block until the copy has completed (the interpreter lock is
        released meanwhile)."""
        if self.event is not None:
            self.event.synchronize()

    def numpy(self) -> np.ndarray:
        self.wait()
        return self.host.numpy()


@dataclasses.dataclass
class ChunkInputs:
    """One chunk mode's device-resident decode inputs: fixed buffers that
    events refill in place and that the programs' carry (next tokens,
    positions and budgets) updates in place, so that a CUDA graph captured
    over them stays valid. ``mode`` is (speculative, penalties, logit_bias):
    the spec history (``buf``, ``gen_start``), the counts and penalty rows,
    and the bias rows exist only in the modes that read them.
    ``any_sampled`` and ``nucleus`` are the host's flags for the rows of
    the last refill."""

    mode: Tuple[bool, bool, bool]
    tokens: torch.Tensor     # [S] int64
    positions: torch.Tensor  # [S] int64
    budgets: torch.Tensor    # [S] int64
    tables: torch.Tensor     # [S, max_pages_per_seq] int32
    active: torch.Tensor     # [S] bool
    temps: torch.Tensor      # [S] float32
    top_ps: torch.Tensor     # [S] float32
    keys: torch.Tensor       # [S, 2] int64
    buf: Optional[torch.Tensor] = None        # [S, L + 1] int64
    gen_start: Optional[torch.Tensor] = None  # [S] int64
    bias_ids: Optional[torch.Tensor] = None   # [S, K] int64
    bias_vals: Optional[torch.Tensor] = None  # [S, K] float32
    counts: Optional[torch.Tensor] = None     # [S, V] int32
    pres: Optional[torch.Tensor] = None       # [S] float32
    freq: Optional[torch.Tensor] = None       # [S] float32
    any_sampled: bool = False
    nucleus: bool = False

    @classmethod
    def allocate(cls, mode: Tuple[bool, bool, bool], slots: int, width: int, history: int,
                 vocab: int, bias_slots: int, device: torch.device) -> "ChunkInputs":
        use_spec, use_pen, use_bias = mode

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        f32 = torch.float32
        return cls(
            mode=mode, tokens=zeros(slots), positions=zeros(slots), budgets=zeros(slots),
            tables=zeros(slots, width, dtype=torch.int32), active=zeros(slots, dtype=torch.bool),
            temps=zeros(slots, dtype=f32), top_ps=zeros(slots, dtype=f32), keys=zeros(slots, 2),
            buf=zeros(slots, history + 1) if use_spec else None,
            gen_start=zeros(slots) if use_spec else None,
            bias_ids=zeros(slots, bias_slots) if use_bias else None,
            bias_vals=zeros(slots, bias_slots, dtype=f32) if use_bias else None,
            counts=zeros(slots, vocab, dtype=torch.int32) if use_pen else None,
            pres=zeros(slots, dtype=f32) if use_pen else None,
            freq=zeros(slots, dtype=f32) if use_pen else None,
        )


def prefill_program(
    params: dict,
    config: DotsOCRConfig,
    paged: PagedKV,
    input_ids: torch.Tensor,
    seq_lens: torch.Tensor,
    slot_mapping: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    sample_keys: torch.Tensor,
    any_sampled: bool,
    bias_ids: Optional[torch.Tensor] = None,
    bias_vals: Optional[torch.Tensor] = None,
    patches: Optional[torch.Tensor] = None,
    pos2d: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
    scatter_batch: Optional[torch.Tensor] = None,
    scatter_pos: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """Prefill one batch into the paged cache (in place) and sample each
    row's first token (``logit_bias`` applied). input_ids [B, T]; seq_lens
    [B]; slot_mapping [B*T] (-1 = padding). 2D-RoPE tables are computed on
    the device from ``pos2d`` [T_vis, 2]; sample_keys [B, 2] the requests'
    keys, folded at the first token's position (seq_lens). Returns [B, 2]
    int64 on the device: each first token and its logprob bits
    (:func:`f32_bits`); a MoE decoder's expert counts follow ([B, 4],
    :func:`moe_counters`)."""
    b, t = input_ids.shape
    moe = moe_counters(config, b, input_ids.device)
    rope_cos = rope_sin = None
    if pos2d is not None:
        rope_cos, rope_sin = vision_rope_device(
            pos2d, config.vision.head_dim, config.vision.rope_theta
        )
    positions = torch.arange(t, device=input_ids.device).expand(b, t)
    logits, cache = vlm_prefill(
        params, config, input_ids, positions, seq_lens, patches=patches,
        rope_cos=rope_cos, rope_sin=rope_sin, segment_ids=segment_ids,
        scatter_batch=scatter_batch, scatter_pos=scatter_pos,
        last_logit_only=True, tp=tp, moe_stats=moe,
    )
    write_prefill_kv(paged, cache.k, cache.v, slot_mapping)
    if bias_ids is not None:
        add_logit_bias(logits, bias_ids, bias_vals)
    # Prefill always runs the nucleus sampler, as the JAX engine does.
    first = sample_logits(sample_keys, logits, temperature, top_p, nucleus=True,
                          any_sampled=any_sampled, positions=seq_lens)
    return _pack_first_with_logprob(first, logits, moe)


def decode_program(
    params: dict,
    config: DotsOCRConfig,
    paged: PagedKV,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    budgets: torch.Tensor,
    page_tables: torch.Tensor,
    active: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    slot_keys: torch.Tensor,
    any_sampled: bool,
    nucleus: bool,
    page_size: int,
    num_steps: int,
    with_logprobs: bool = False,
    presence: Optional[torch.Tensor] = None,
    frequency: Optional[torch.Tensor] = None,
    counts: Optional[torch.Tensor] = None,
    bias_ids: Optional[torch.Tensor] = None,
    bias_vals: Optional[torch.Tensor] = None,
    tp=None,
):
    """``num_steps`` decode iterations for every slot, all on the device.

    tokens/positions [S] int64: each slot's current token and its cache
    write position; budgets [S] int64 tokens each row may still emit;
    page_tables [S, max_pages] int32 must cover positions + num_steps;
    active [S] bool. A row stops at EOS or at its budget; stopped and
    inactive rows write the null page with length 0 (the kernel returns
    zeros for them). slot_keys [S, 2]: the token sampled at position q
    draws under ``fold_in(slot_key, q)``; ``nucleus`` is the sampler's
    static flag (:func:`sampling.sample_logits`).

    Options, each applied before sampling in the JAX program's order:
    ``bias_ids``/``bias_vals`` [S, K] (:func:`add_logit_bias`); ``counts``
    [S, V] int32 with ``presence``/``frequency`` [S] (presence and
    frequency penalties over the generated tokens, vLLM semantics; the
    counts are updated in place, one scatter a step); ``with_logprobs``
    packs each emitted token's log-probability under those logits.

    Returns (packed [S, num_steps (+ num_steps) + 2] int64: the sampled
    tokens (pad after a row stopped), with logprobs their bits, each row's
    emitted count, and, last, the context tokens the paged kernel read for
    the row, its ``seq_lens`` added over the iterations (a row live for n
    iterations from position L reads n (L + 1) + n (n - 1) / 2), and for a
    MoE decoder its expert counts over the live iterations (two more
    columns, :func:`moe_counters`); the carry
    (next tokens, next positions, next budgets: 0 for a row that emitted
    EOS), on the device, for the next chunk).
    """
    eos, pad = config.special.eos_token_id, config.special.pad_token_id
    s = tokens.shape[0]
    dev = tokens.device
    rows = torch.arange(s, device=dev)
    tokens_out = torch.full((s, num_steps), pad, dtype=torch.int64, device=dev)
    lp_out = (torch.zeros((s, num_steps), dtype=torch.float32, device=dev)
              if with_logprobs else None)
    num_decoded = torch.zeros(s, dtype=torch.int64, device=dev)
    hit_eos = torch.zeros(s, dtype=torch.bool, device=dev)
    moe = moe_counters(config, s, dev)
    done = ~active | (budgets <= 0)
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
            k_scales=paged.k_scale, v_scales=paged.v_scale, tp=tp, moe_stats=moe,
        )
        logits = logits_from_hidden(params["decoder"], config.decoder, hidden)
        if bias_ids is not None:
            add_logit_bias(logits, bias_ids, bias_vals)
        if counts is not None:
            logits = (logits - presence[:, None] * (counts > 0)
                      - frequency[:, None] * counts.to(torch.float32))
        nxt = sample_logits(slot_keys, logits, temperature, top_p, nucleus=nucleus,
                            any_sampled=any_sampled, positions=pos + 1)
        tokens_out[:, i] = torch.where(live, nxt, pad)
        if lp_out is not None:
            lp_out[:, i] = torch.where(live, token_logprob(logits, nxt), 0.0)
        if counts is not None:
            counts.scatter_add_(1, nxt[:, None], live[:, None].to(counts.dtype))
        num_decoded += live.to(torch.int64)
        pos = pos + live.to(torch.int64)
        current = torch.where(live, nxt, current)
        eos_now = live & (nxt == eos)
        hit_eos = hit_eos | eos_now
        done = done | eos_now | (live & (num_decoded >= budgets))
    cols = [tokens_out] + ([f32_bits(lp_out)] if lp_out is not None else [])
    kv_read = num_decoded * (positions + 1) + num_decoded * (num_decoded - 1) // 2
    packed = torch.cat(cols + [num_decoded[:, None], kv_read[:, None]]
                       + ([moe] if moe is not None else []), dim=1)
    return packed, (current, pos, torch.where(hit_eos, 0, budgets - num_decoded))


def encode_program(params: dict, config: DotsOCRConfig, patches: torch.Tensor,
                   pos2d: torch.Tensor, segment_ids: torch.Tensor, tp=None) -> torch.Tensor:
    """Vision encoder for one request's packed images -> merged tokens
    [T_pad / merge^2, D_llm] (2D-RoPE tables made on the device)."""
    cos, sin = vision_rope_device(pos2d, config.vision.head_dim, config.vision.rope_theta)
    return encode_images(params["vision"], config.vision, patches, cos, sin, segment_ids,
                         tp=tp)


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
    sample_keys: torch.Tensor,
    any_sampled: bool,
    page_size: int,
    kv_hi: int,
    q_offset: int,
    bias_ids: Optional[torch.Tensor] = None,
    bias_vals: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """One lockstep chunk of a chunked prefill for a batch of requests.

    embeds_chunk [B, C, D] (slices of each request's spliced embeddings;
    rows past a prompt are padding); prompt_len [B]; page_table
    [B, kv_hi / page_size]; slots [B, C] write slots (padding -> the null
    page). Samples a candidate first token (``logit_bias`` applied) from
    each row's last valid position in the chunk; the host keeps it on a
    row's final chunk. Returns [B, 2] int64 on the device (a MoE decoder's
    this chunk's expert counts after them), as :func:`prefill_program`."""
    b, c, _ = embeds_chunk.shape
    moe = moe_counters(config, b, embeds_chunk.device)
    positions = q_offset + torch.arange(c, device=embeds_chunk.device)
    hidden = decoder_prefill_extend_batched(
        params["decoder"], config.decoder, embeds_chunk, positions, prompt_len,
        paged.k, paged.v, page_table, slots, page_size, kv_hi, q_offset,
        k_scales=paged.k_scale, v_scales=paged.v_scale, tp=tp, moe_stats=moe,
    )
    last_row = (prompt_len.long() - 1 - q_offset).clamp(0, c - 1)
    hidden = hidden[torch.arange(b, device=hidden.device), last_row]
    logits = logits_from_hidden(params["decoder"], config.decoder, hidden)
    if bias_ids is not None:
        add_logit_bias(logits, bias_ids, bias_vals)
    first = sample_logits(sample_keys, logits, temperature, top_p, nucleus=True,
                          any_sampled=any_sampled, positions=prompt_len)
    return _pack_first_with_logprob(first, logits, moe)


def spec_decode_program(
    params: dict,
    config: DotsOCRConfig,
    paged: PagedKV,
    tokens_buf: torch.Tensor,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    budgets: torch.Tensor,
    gen_start: torch.Tensor,
    page_tables: torch.Tensor,
    active: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    slot_keys: torch.Tensor,
    any_sampled: bool,
    nucleus: bool,
    page_size: int,
    num_steps: int,
    spec_k: int,
    bias_ids: Optional[torch.Tensor] = None,
    bias_vals: Optional[torch.Tensor] = None,
    tp=None,
):
    """``num_steps`` speculative iterations for every slot, on the device.

    Per iteration and live slot: (1) draft: the most recent position of
    the slot's generated history whose bigram matches (previous, current)
    proposes the ``spec_k`` tokens that followed it (``current`` repeated
    when nothing matches); (2) verify: one decoder forward over the
    ``spec_k + 1`` tokens through the multi-query paged kernel, with the
    same ``logit_bias`` at every verified column (the bias is
    position-independent, so acceptance stays exact); (3) accept:
    :func:`sampling.spec_accept`. Emits 1 to ``spec_k + 1`` tokens per
    live slot and iteration; a row stops at EOS or its budget.

    tokens_buf [S, L + 1] int64 generated history by logical position (L =
    the page table's token capacity; the last column is a sink for
    dropped writes), kept on the device and updated in place; gen_start
    [S] first generated position (the prompt length); other arguments as
    in :func:`decode_program`, with page tables covering positions +
    num_steps * (spec_k + 1). Returns (packed [S, num_steps * (spec_k + 1)
    + 2] int64: emitted tokens, then each row's count, then the context
    tokens the paged kernel read for the row (its ``seq_lens`` added over
    the iterations); the carry, as :func:`decode_program`'s).
    """
    eos, pad = config.special.eos_token_id, config.special.pad_token_id
    s, length_buf = tokens_buf.shape[0], tokens_buf.shape[1] - 1
    nq = spec_k + 1
    capacity = page_tables.shape[1] * page_size
    dev = tokens.device
    rows = torch.arange(s, device=dev)
    offs = torch.arange(nq, device=dev)
    tpos = torch.arange(length_buf, device=dev)
    out = torch.full((s, num_steps * nq + 2), pad, dtype=torch.int64, device=dev)
    n_out = torch.zeros(s, dtype=torch.int64, device=dev)
    kv_read = torch.zeros(s, dtype=torch.int64, device=dev)
    hit_eos = torch.zeros(s, dtype=torch.bool, device=dev)
    done = ~active | (budgets <= 0)
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
        kv_read += seq_lens
        hidden = decoder_spec_step_paged(
            params["decoder"], config.decoder, embed_tokens(params["decoder"], x_all),
            write_pos, paged.k, paged.v, page_tables, seq_lens, slots, page_size,
            k_scales=paged.k_scale, v_scales=paged.v_scale, tp=tp,
        )
        logits = logits_from_hidden(params["decoder"], config.decoder, hidden)
        if bias_ids is not None:
            add_logit_bias(logits, bias_ids, bias_vals)
        # Keys folded at this iteration's first emitted position (pos + 1).
        a, corrective = spec_accept(logits, x_all, temperature, top_p,
                                    step_keys(slot_keys, pos + 1, any_sampled), any_sampled,
                                    nucleus)

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
        eos_now = live & (eos_idx < nq)
        hit_eos = hit_eos | eos_now
        done = done | eos_now | (live & (n_out >= budgets))
    out[:, -2] = n_out  # over the sink column of dropped writes
    out[:, -1] = kv_read
    return out, (current, pos, torch.where(hit_eos, 0, budgets - n_out))


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
    # OpenAI logit_bias: fixed per-request (token id, bias) slots; requests
    # with more entries are rejected at submit.
    logit_bias_slots: int = 32
    # Decode iterations per host sync.
    steps_per_sync: int = 8
    # Requests prefilled per dispatch.
    max_prefill_batch: int = 4
    # Adaptive chunk deepening: when every live request still has at least
    # this many tokens of budget left and none needs per-chunk host checks
    # (stream callbacks, stop strings or stop ids), nothing waits for
    # admission and nothing prefills, decode chunks run this many
    # iterations (divided by k + 1 while speculating) instead of
    # steps_per_sync; never while an EngineWorker drives the engine
    # (ContinuousBatchingEngine.arrivals). Set equal to steps_per_sync to
    # disable.
    max_steps_per_sync: int = 64
    # Pipelined decode (lookahead-1): during event-free decode (as above,
    # and no logprobs, penalties or logit_bias live) chunk N+1 is
    # dispatched off the device-resident carry before chunk N's result is
    # read, so the fetch and the host's bookkeeping overlap the device's
    # work. Rows that end inside chunk N idle through chunk N+1 (their
    # pages are freed once it lands); any scheduling event drains first.
    pipeline_decode: bool = True
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
    # decode iteration (spec_decode_program). 0 = off. Chunks with a live
    # logprobs or penalties request decode plainly.
    speculate_k: int = 0
    # Adaptive cut-off: speculation turns off for the current load after 3
    # consecutive chunks whose EWMA of emitted tokens per slot-iteration is
    # below this, and re-probes when the engine drains. <= 0 disables.
    spec_min_tokens_per_iter: float = 1.5
    # "bf16" (the model dtype) or "int8" (int8 pools + float32 scales).
    kv_cache_dtype: str = "bf16"
    # On CUDA, every decode and verify chunk runs as a CUDA graph, captured
    # at its configuration's first dispatch (engine/graphs.py). False runs
    # the same programs eagerly (the oracle of the graphed engine). Nothing
    # is captured on the CPU.
    cuda_graphs: bool = True


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
    # time.monotonic() stamps: before this engine's submit, those of the
    # EngineWorker that took the request (receipt, preprocessing start and
    # end, the engine thread's take; None where nothing stamped them; a
    # request the engine prepares itself gets its preprocessing stamped).
    # Only timing() reads them: no decision depends on a clock.
    received_at: Optional[float] = None
    prep_started_at: Optional[float] = None
    prep_ended_at: Optional[float] = None
    taken_at: Optional[float] = None
    submitted_at: float = dataclasses.field(default_factory=time.monotonic)
    finished_reason: Optional[str] = None
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    stop: List[str] = dataclasses.field(default_factory=list)
    stop_token_ids: frozenset = frozenset()
    # Sampling key ([2] int64 uint32 words): PRNGKey(seed) for a seeded
    # request, else a split of the engine's chain. Fixed at submit, so a
    # preempted request replays its sampled stream.
    sample_key: Any = None
    # OpenAI logprobs: each generated token's log-probability, aligned with
    # prior_output + output_ids.
    logprobs: bool = False
    output_logprobs: List[float] = dataclasses.field(default_factory=list)
    # OpenAI presence/frequency penalties (vLLM semantics: counts over the
    # generated tokens, subtracted from the logits before sampling).
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # OpenAI logit_bias {token id: bias}, applied at every sampling step
    # (the first token included); None = unused.
    logit_bias: Optional[Dict[int, float]] = None
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
        """Millisecond latency split (0.0 for markers never reached), from
        receipt: ``prep_wait_ms`` (receipt to preprocessing), ``prep_ms``,
        ``engine_wait_ms`` (preprocessed to this engine's submit),
        ``queue_ms`` (submit to admission), ``prefill_ms`` (admission to
        first token); they add up to ``ttft_ms``. ``total_ms`` counts from
        receipt too. ``worker_queue_ms`` is the part of ``engine_wait_ms``
        before the engine thread's take (the worker's queue, while the
        engine thread steps); the rest is the engine thread's own work up to
        the submit. It reads 0 where the take comes before preprocessing
        (a tensor-parallel leader prepares what it takes; its queue wait is
        in ``prep_wait_ms``)."""
        sub = self.submitted_at
        p1 = self.prep_ended_at or sub
        p0 = self.prep_started_at or p1
        rcv = self.received_at or p0
        take = self.taken_at or p1
        adm = self.admitted_at or sub
        ft = self.first_token_at
        fin = self.finished_at
        return {
            "prep_wait_ms": max(0.0, (p0 - rcv) * 1e3),
            "prep_ms": max(0.0, (p1 - p0) * 1e3),
            "engine_wait_ms": max(0.0, (sub - p1) * 1e3),
            "worker_queue_ms": max(0.0, (take - p1) * 1e3),
            "queue_ms": max(0.0, (adm - sub) * 1e3),
            "ttft_ms": max(0.0, (ft - rcv) * 1e3) if ft else 0.0,
            "prefill_ms": max(0.0, (ft - adm) * 1e3) if ft else 0.0,
            "decode_ms": max(0.0, (fin - ft) * 1e3) if ft and fin else 0.0,
            "total_ms": max(0.0, (fin - rcv) * 1e3) if fin else 0.0,
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
    ``OpenAIServer`` and ``EngineWorker`` use.

    ``tp``: a ``parallel.distributed.TPGroup`` whose ``plan`` is this
    rank's shard (``parallel.sharding.shard_params``), in place of the JAX
    engine's ``mesh``. ``params`` is then the rank's shard and ``config``
    the full model's config (tokenizer, special ids, vocab); the programs
    run on the plan's shard config. Every rank of the group runs one engine
    in lockstep (``serve/async_engine.py``): the host's decisions depend
    only on the submissions, cancels and step calls, never on a clock."""

    def __init__(
        self,
        params: dict,
        config: DotsOCRConfig,
        device: torch.device,
        tokenizer: Optional[TokenizerLike] = None,
        sched: Optional[SchedulerConfig] = None,
        default_max_new_tokens: int = 16384,
        tp=None,
    ):
        self.params = params
        self.config = config
        self.device = torch.device(device)
        self.tokenizer = tokenizer or default_tokenizer(config)
        self.sched = sched or SchedulerConfig()
        self.tp = tp
        self.model_config = config if tp is None else tp.plan.config
        self._kv_rep = 1 if tp is None else tp.plan.kv_replication
        if tp is not None:
            self._check_tp()
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
        # The chain that keys unseeded requests (host-side, as the JAX
        # engine's self._rng).
        self._rng = prng_key(0)
        if self.sched.kv_cache_dtype not in ("bf16", "int8"):
            raise ValueError(f"kv_cache_dtype {self.sched.kv_cache_dtype!r} not in (bf16, int8)")
        # A MoE decoder (DeepSeek's) counts its experts' assignments.
        self._moe = config.decoder.deepseek is not None
        if self._moe and (tp is not None or self.sched.speculate_k > 0):
            raise ValueError("DeepSeek's decoder serves on one device without speculation "
                             "(speculate_k 0)")
        kv_split = tp is not None and "decoder.attn" in tp.plan.row_parallel
        self.paged = PagedKV.create(
            config.decoder, self.sched.num_pages, self.sched.page_size,
            dtype=config.torch_dtype, device=self.device,
            quantized=self.sched.kv_cache_dtype == "int8",
            kv_replication=self._kv_rep, world=tp.world if kv_split else 1,
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
        self._pres = np.zeros(s, np.float32)
        self._freq = np.zeros(s, np.float32)
        vocab, kb = config.decoder.vocab_size, self.sched.logit_bias_slots
        self._bias_ids = np.full((s, kb), vocab, np.int64)  # vocab = padding
        self._bias_vals = np.zeros((s, kb), np.float32)
        # Per-slot sampling keys (each request's sample_key).
        self._slot_keys = np.zeros((s, 2), np.int64)
        self._waiting: Deque[ScheduledRequest] = deque()
        self._finished: Dict[int, ScheduledRequest] = {}
        # Finished ids that step() has returned: a finish that lands outside
        # step() (cancel()'s drain, a rejection at submit) is returned by
        # the next step().
        self._reported: set = set()
        self._next_id = 0
        # Device-resident decode chunk inputs: fixed buffers per chunk mode,
        # and the set the next chunk reads, valid while no event (admission,
        # finish, preemption, page growth, decode-mode change) happened
        # since the last chunk; None = refill from host state.
        self._inputs: Dict[Tuple[bool, bool, bool], ChunkInputs] = {}
        self._dev: Optional[ChunkInputs] = None
        # The decode chunks' CUDA graphs (None: the programs run eagerly).
        self._graphs = (DecodeGraphs(self.device)
                        if self.device.type == "cuda" and self.sched.cuda_graphs else None)
        self._int4_weights = has_int4_kernels(params["decoder"])
        # The queued warmup (queue_warmup), run one thunk per warm_tick.
        self._warm_queue: List[Callable[[], None]] = []
        # The pipelined chunk dispatched but not yet applied: {"fetch",
        # "active", "chunk", "use_lp", "use_spec", "tokens" (the most it can
        # emit), "span" (its dispatch span's id, or None)}; and the requests
        # whose pages it may still write, freed when it lands.
        self._inflight: Optional[dict] = None
        self._deferred_free: List[int] = []
        # A dispatched chunk (a synchronous one, or the predecessor of the
        # pipelined one) whose result had not landed when step() returned:
        # the next step applies it before anything reads host state.
        self._held: Optional[dict] = None
        # Whether the last step left its decode chunk to this one, and the
        # driver's probe for requests that reached it meanwhile (an
        # EngineWorker's queue; never read under tensor parallelism, where
        # every rank must take the same decisions).
        self._decode_deferred = False
        self.arrivals: Optional[Callable[[], bool]] = None
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
            # monolithic batches admitted with a decode chunk still on the device
            "admits_beside_chunk": 0,
            "prefill_chunks": 0,
            "generated_tokens": 0,
            "spec_chunks": 0,
            "spec_emitted": 0,     # tokens emitted by verify chunks
            "spec_slot_iters": 0,  # acceptance = emitted / (iters * (k + 1))
            "spec_auto_disabled": 0,
            "preemptions": 0,
            "pipelined_chunks": 0,      # decode chunks dispatched ahead of a fetch
            "chunk_input_rebuilds": 0,  # decode chunks whose inputs were uploaded
            "graph_captures": 0,  # decode chunk configurations captured as CUDA graphs
            "graph_replays": 0,   # decode chunks run as a replay (warmup included)
            # context tokens the paged kernel read, one layer's launch a
            # decode or verify iteration (the seq_lens the chunks hand it)
            "kv_tokens_read": 0,
        }
        if self._moe:
            # (token, expert) assignments that landed on a held expert, and the
            # busiest held expert's count summed over layer-iterations
            self.metrics.update(moe_routed_here=0, moe_busiest_expert=0)

    def _check_tp(self) -> None:
        """The JAX engine's TP rules, on this rank: log the decode route and
        the replication, and run eagerly where a collective cannot be
        captured. A rank's paged attention takes ``choose_paged_kernel``'s
        route on its own heads (kernel 3 at nq = 1 and the plain reference
        at nq > 1 where kernel 2 does not fit), as the JAX package's
        shard_map runs ``paged_attention_multiquery`` on each shard."""
        tp, d = self.tp, self.config.decoder
        route = choose_paged_kernel(d.head_dim, self.sched.page_size,
                                    self.sched.kv_cache_dtype == "int8", 1)
        if route != "multiquery":
            logger.info("TP=%d at head_dim %d, page_size %d, %s KV: each rank decodes its heads "
                        "through kernel 3 (v1), and verifies through the plain reference",
                        tp.world, d.head_dim, self.sched.page_size, self.sched.kv_cache_dtype)
        if self._kv_rep > 1:
            logger.info("TP=%d exceeds %d KV heads: each KV head is repeated on %d ranks "
                        "(a rank's pool holds one head)", tp.world, d.num_kv_heads,
                        self._kv_rep)
        whole = sorted(set(ROW_PARALLEL_PARTS) - tp.plan.row_parallel)
        if whole:
            logger.info("TP=%d: %s do not divide and stay whole on every rank", tp.world,
                        ", ".join(whole))
        if tp.backend == "gloo" and self.sched.cuda_graphs and self.device.type == "cuda":
            # gloo stages CUDA tensors through the host: no graph captures it.
            logger.info("TP over gloo: decode chunks run eagerly (no CUDA graphs)")
            self.sched = dataclasses.replace(self.sched, cuda_graphs=False)

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
        received_at: Optional[float] = None,
        prep_started_at: Optional[float] = None,
        prep_ended_at: Optional[float] = None,
        taken_at: Optional[float] = None,
    ) -> int:
        """Queue a request; returns its id. ``prepared`` is a
        :meth:`prepare` result built off the engine thread; the ``*_at``
        stamps are an EngineWorker's (:class:`ScheduledRequest`)."""
        sample_key = (prng_key(int(seed)) if seed is not None else self._next_rng()).numpy()
        if logit_bias:
            if len(logit_bias) > self.sched.logit_bias_slots:
                raise ValueError(f"logit_bias supports at most "
                                 f"{self.sched.logit_bias_slots} entries")
            vocab = self.config.decoder.vocab_size
            # Out-of-vocabulary ids are inert, as in the JAX engine.
            logit_bias = {int(k): float(v) for k, v in logit_bias.items()
                          if 0 <= int(k) < vocab}
        if prepared is None:
            with SPANS("prepare"):
                prep_started_at = time.monotonic()
                prepared = self.prepare(prompt, images, system_prompt=system_prompt,
                                        min_pixels=min_pixels, max_pixels=max_pixels)
                prep_ended_at = time.monotonic()
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
            sample_key=sample_key,
            logprobs=bool(logprobs),
            presence_penalty=float(presence_penalty),
            frequency_penalty=float(frequency_penalty),
            logit_bias=logit_bias or None,
            stream_cb=stream_cb,
            detok=(IncrementalDetokenizer(self.tokenizer)
                   if (stop or stream_cb is not None) else None),
            received_at=received_at, prep_started_at=prep_started_at,
            prep_ended_at=prep_ended_at, taken_at=taken_at,
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

    def _next_rng(self) -> torch.Tensor:
        """A fresh key split off the engine's chain."""
        self._rng, out = split(self._rng)
        return out

    def _put(self, x: np.ndarray) -> torch.Tensor:
        """Upload a host array. The tensor never aliases host state (on the
        CPU ``torch.from_numpy(...).to(cpu)`` would), and on the card the
        copy goes through pinned staging without blocking the host, so an
        upload made while a pipelined chunk runs does not wait for it."""
        staged = torch.from_numpy(np.ascontiguousarray(x))
        staged = staged.pin_memory() if self.device.type == "cuda" else staged.clone()
        return staged.to(self.device, non_blocking=True)

    def _bias_rows(self, reqs: Sequence[ScheduledRequest]):
        """[len(reqs), K] (ids, vals) host arrays of the requests' logit_bias
        (ids = vocab pad unused entries)."""
        ids = np.full((len(reqs), self.sched.logit_bias_slots),
                      self.config.decoder.vocab_size, np.int64)
        vals = np.zeros(ids.shape, np.float32)
        for j, req in enumerate(reqs):
            for jj, (tid, bias) in enumerate(sorted((req.logit_bias or {}).items())):
                ids[j, jj], vals[j, jj] = tid, bias
        return ids, vals

    def _batch_bias(self, reqs: Sequence[ScheduledRequest]) -> dict:
        """A prefill batch's bias arguments, or none when no request biases."""
        if not any(r.logit_bias for r in reqs):
            return {}
        ids, vals = self._bias_rows(reqs)
        return dict(bias_ids=self._put(ids), bias_vals=self._put(vals))

    def _set_slot(self, slot: int, req: ScheduledRequest) -> None:
        """A request's sampling options into its slot's host rows."""
        self._temps[slot] = req.temperature
        self._top_ps[slot] = req.top_p
        self._pres[slot] = req.presence_penalty
        self._freq[slot] = req.frequency_penalty
        self._slot_keys[slot] = req.sample_key
        ids, vals = self._bias_rows([req])
        self._bias_ids[slot], self._bias_vals[slot] = ids[0], vals[0]

    def _free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    def has_work(self) -> bool:
        return (bool(self._waiting) or self._on_device()
                or any(r is not None for r in self._slot_req))

    def _on_device(self) -> bool:
        """Whether a dispatched decode chunk has not been applied yet."""
        return self._inflight is not None or self._held is not None

    def _landed(self, flight: dict) -> bool:
        """Whether a chunk's result is on the host. Under tensor parallelism
        every rank must take the same decisions, and a landing is each
        rank's own observation: a TP engine treats every chunk as landed
        (today's schedule: applied at dispatch, admission after landing)."""
        return self.tp is not None or flight["fetch"].landed()

    def held_fetch(self) -> Optional[HostFetch]:
        """The fetch of the held chunk while it has not landed, else None.
        The next step lands that chunk first, so a caller with nothing else
        to do may wait on it (:meth:`HostFetch.wait`) or on new requests,
        whichever comes first, before stepping."""
        flight = self._held
        return flight["fetch"] if flight is not None and not self._landed(flight) else None

    def _bucket(self, n: int) -> int:
        step = self.sched.prompt_bucket_step
        return max(step, -(-n // step) * step)

    def _set_first_token(self, slot: int, req: ScheduledRequest, first: np.ndarray) -> None:
        """Promote a prefilled request to RUNNING with its first token (a
        row of a prefill program's packed [B, 2] result)."""
        token = int(first[0])
        req.state = RUNNING
        req.slot = slot
        req.output_ids = [token]
        if req.logprobs:
            req.output_logprobs.append(float(bits_f32(first[1:2])[0]))
        req.first_token_at = req.first_token_at or time.monotonic()
        self._slot_req[slot] = req
        self._tokens[slot] = token
        self._lengths[slot] = len(req.prompt_ids)
        self.metrics["prefills"] += 1
        self._dev = None  # the decode set grows; rebuild the chunk inputs
        self._update_text(slot)  # may finish on a stop string
        self._maybe_finish(slot)

    # -- admission -------------------------------------------------------

    def _chunked(self, req: ScheduledRequest) -> bool:
        ct = self.sched.prefill_chunk_tokens
        return ct > 0 and len(req.prompt_ids) > ct

    def _try_admit(self, beside: Optional[dict] = None) -> List[tuple]:
        """Admit waiting requests in order while slots and pages allow: a
        run of long (chunked) prompts together as PREFILLING, or a batch of
        short ones through one monolithic prefill.

        ``beside``: the newest decode chunk, still on the device. Admission
        then takes monolithic batches only, into slots outside the rows of
        every chunk not yet applied, with pages from the free pool (pages
        of rows that finished in flight stay deferred), and leaves the
        first tokens unread: it returns the launched batches (requests,
        slots, first-token fetch) for :meth:`_promote` once the chunks have
        landed."""
        watermark = int(self.sched.num_pages * self.sched.admit_free_page_fraction)
        busy = set()
        if beside is not None:
            for flight in (self._held, self._inflight):
                busy.update(flight["active"] if flight is not None else ())
        launched = []
        while self._waiting:
            free = [i for i in self._free_slots() if i not in busy]
            chunked = self._chunked(self._waiting[0])
            if not free or (chunked and beside is not None):
                break
            room = min(self.sched.max_prefill_batch, len(free))
            budget = self.allocator.free_pages - watermark
            batch: List[ScheduledRequest] = []
            while self._waiting and len(batch) < room and self._chunked(self._waiting[0]) == chunked:
                need = self.allocator.pages_needed(len(self._waiting[0].prompt_ids) + 1)
                if need > budget:
                    break
                budget -= need
                batch.append(self._waiting.popleft())
            if not batch:
                break
            with SPANS("admit") as span:
                if span:
                    span.note(reqs=[r.req_id for r in batch], chunked=chunked,
                              **({} if beside is None else {"beside": beside["span"]}))
                if chunked:
                    self._admit_chunked(batch)
                    continue
                slots = free[:len(batch)]
                first = self._admit_batch(batch, slots)
                if beside is None:
                    self._promote(batch, slots, first)
                else:
                    busy.update(slots)
                    launched.append((batch, slots, first))
                    self.metrics["admits_beside_chunk"] += 1
        return launched

    def _admit_chunked(self, reqs: List[ScheduledRequest]) -> None:
        """Park long requests in slots as PREFILLING: token embeddings for
        the group, then per request its vision encoder and splice. The
        bucket is a multiple of the chunk, so every chunk is an exact slice."""
        ct = self.sched.prefill_chunk_tokens
        t_bucket = max(-(-len(r.prompt_ids) // ct) * ct for r in reqs)
        with SPANS("prepare_batch") as span:
            input_ids = np.full((len(reqs), t_bucket), self.config.special.pad_token_id,
                                np.int64)
            now = time.monotonic()
            for j, req in enumerate(reqs):
                input_ids[j, :len(req.prompt_ids)] = req.prompt_ids
                self.allocator.allocate(req.req_id, len(req.prompt_ids) + 1)
                req.admitted_at = req.admitted_at or now
            ids = self._put(input_ids)
            span.note(rows=len(reqs), t=t_bucket)
        embeds = embed_tokens(self.params["decoder"], ids)
        merge = self.config.vision.spatial_merge_size**2
        for j, req in enumerate(reqs):
            packed = req.packed
            if packed is None:
                continue
            with SPANS("prepare_batch"):
                # Row-j scatter coordinates: built against the single row,
                # then its batch index remapped (0 -> j, the sentinel 1 -> B).
                sb, sp = build_scatter_indices(
                    input_ids[j:j + 1], self.config.special.imgpad_id,
                    packed.patches.shape[0] // merge, valid_rows=packed.merged_valid_rows(merge),
                )
                sb = np.where(sb == 0, j, len(reqs)).astype(np.int32)
                vision = [self._put(x) for x in (packed.patches, packed.pos2d,
                                                  packed.segment_ids, sb, sp)]
            with SPANS.whole("encode", self.device) as span:
                vision_tokens = encode_program(self.params, self.model_config, *vision[:3],
                                               tp=self.tp)
                if span:
                    span.note(reqs=[req.req_id], **image_work(packed.segment_ids))
            embeds = splice_vision_embeddings(embeds, vision_tokens, *vision[3:])
            self.metrics["chunk_embeds"] = self.metrics.get("chunk_embeds", 0) + 1
        # The decode set is unchanged until a request's last chunk, so the
        # device-resident decode inputs stay valid.
        for slot, (j, req) in zip(self._free_slots(), enumerate(reqs)):
            req.embeds = embeds[j]
            req.state = PREFILLING
            req.slot = slot
            req.prefill_pos = 0
            self._slot_req[slot] = req
            self._lengths[slot] = 0
            self._set_slot(slot, req)

    def _run_prefill_chunk(self) -> None:
        """One decoder chunk for the lockstep group of PREFILLING requests
        at the smallest offset; a row's final chunk samples its first token
        and promotes it to RUNNING."""
        prefilling = [(i, r) for i, r in enumerate(self._slot_req)
                      if r is not None and r.state == PREFILLING]
        if not prefilling:
            return
        with SPANS.whole("prefill_chunk", self.device) as span:
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
                self.params, self.model_config, self.paged,
                torch.stack([r.embeds[start:start + ct] for _, r in group]),
                self._put(plens), self._put(tables), self._put(slots), self._put(temps),
                self._put(np.array([r.top_p for _, r in group], np.float32)),
                self._put(np.stack([r.sample_key for _, r in group])),
                bool(np.any(temps > 0)), page_size=ps, kv_hi=kv_hi, q_offset=start,
                **self._batch_bias([r for _, r in group]), tp=self.tp,
            )
            self.metrics["prefill_chunks"] += 1
            first_host = None
            if self._moe:  # every chunk's expert counts
                first_host = first.cpu().numpy()
                self._count_moe(first_host[:, 2:], span)
            for j, (slot, req) in enumerate(group):
                req.prefill_pos += ct
                if req.prefill_pos < len(req.prompt_ids):
                    continue
                if first_host is None:
                    first_host = first.cpu().numpy()  # one fetch per chunk
                req.embeds = None
                self._set_first_token(slot, req, first_host[j])
            if span:
                span.note(reqs=[r.req_id for _, r in group], rows=n, t=ct, q_offset=start,
                          kv_hi=kv_hi, prompt_lens=plens.tolist())

    def _admit_batch(self, reqs: List[ScheduledRequest], slots: List[int]) -> HostFetch:
        """Launch a batch's prefill in one dispatch (on the stream, behind
        whatever is queued there); returns its first tokens' fetch."""
        n = len(reqs)
        t_bucket = self._bucket(max(len(r.prompt_ids) for r in reqs))
        with SPANS("prepare_batch") as span:
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

            vision, seg = {}, None
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
                seg = merged.segment_ids
            temps = np.array([r.temperature for r in reqs], np.float32)
            args = [self._put(x) for x in (
                input_ids, seq_lens, slot_mapping.reshape(-1), temps,
                np.array([r.top_p for r in reqs], np.float32),
                np.stack([r.sample_key for r in reqs]))]
            bias = self._batch_bias(reqs)
            span.note(rows=n, t=t_bucket)
        with SPANS.whole("prefill", self.device) as span:
            first = prefill_program(self.params, self.model_config, self.paged, *args,
                                    bool(np.any(temps > 0)), **bias, **vision, tp=self.tp)
            if span:
                span.note(reqs=[r.req_id for r in reqs], rows=n, t=t_bucket,
                          prompt_lens=seq_lens.tolist(),
                          **(image_work(seg) if seg is not None else {}))
        fetch = HostFetch(first)
        fetch.span = span
        return fetch

    def _count_moe(self, counts: np.ndarray, span) -> None:
        """Add a result's MoE counts ([rows, 2]: each row's assignments on
        the held experts, the busiest held expert's count in row 0) to the
        metrics, and note them on the span that launched it."""
        here, busiest = int(counts[:, 0].sum()), int(counts[:, 1].sum())
        self.metrics["moe_routed_here"] += here
        self.metrics["moe_busiest_expert"] += busiest
        if span:
            span.note(moe_routed_here=here, moe_busiest_expert=busiest)

    def _promote(self, reqs: List[ScheduledRequest], slots: List[int], first: HostFetch) -> None:
        """Read a prefilled batch's first tokens and promote it to RUNNING
        in ``slots``."""
        with SPANS("first_fetch"):
            span, first = first.span, first.numpy()
        if self._moe:
            self._count_moe(first[:, 2:], span)
        for j, req in enumerate(reqs):
            self._set_slot(slots[j], req)
            self._set_first_token(slots[j], req, first[j])

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
        if self._on_device():
            # A chunk on the device may still write this request's pages;
            # they go back to the pool when it lands (_drain_inflight).
            self._deferred_free.append(req.req_id)
        else:
            self.allocator.free(req.req_id)
        self._finished[req.req_id] = req
        self._slot_req[slot] = None
        self._lengths[slot] = 0
        self._dev = None  # the decode set changed

    def cancel(self, req_id: int) -> bool:
        """Abort a waiting or running request; it finishes 'cancelled'.
        Returns False if the id is unknown or already done. A running
        request first lands the in-flight chunk, which may finish it (then
        False) or other requests: the next :meth:`step` returns those."""
        for req in list(self._waiting):
            if req.req_id == req_id:
                self._waiting.remove(req)
                req.state = FINISHED
                req.finished_reason = "cancelled"
                self._finished[req_id] = req
                self._emit_stream(req, final=True)
                return True
        for req in self._slot_req:
            if req is not None and req.req_id == req_id:
                if self._on_device():
                    # Land the chunk now, so the pages are freed now rather
                    # than at a step a gone client may never drive.
                    self._drain_inflight()
                    if req.state == FINISHED:
                        return False
                self._finish(req.slot, "cancelled")
                return True
        return False

    def _preempt_youngest(self) -> None:
        """Recompute preemption: the youngest request in a slot goes back to
        the head of the waiting queue with prompt := prompt + generated so
        far; its pages are freed. A PREFILLING victim restarts its prefill
        (chunk progress and device embeddings dropped). Never called with a
        chunk in flight (its pages could still be written)."""
        candidates = [r for r in self._slot_req if r is not None]
        if not candidates:
            raise OutOfPages("no pages free and nothing to preempt")
        # The youngest is the last submitted: ids rise in submission order,
        # the same on every rank of a TP group (clocks are not).
        victim = max(candidates, key=lambda r: r.req_id)
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
        self._dev = None  # the decode set and tables changed

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

    # -- the step --------------------------------------------------------

    def _apply_chunk_results(self, flight: dict) -> None:
        """Read one decode chunk's packed result and fold it into host state
        (token append, EOS / stop / budget finishes, the spec gate). Shared
        by the synchronous path and the pipelined drain."""
        with SPANS("fetch_wait"):
            packed = flight["fetch"].numpy()  # the chunk's one fetch
        with SPANS("apply", cause=flight["span"]) as span:
            active, chunk = flight["active"], flight["chunk"]
            if self._moe:
                self._count_moe(packed[:, -2:], span)
                packed = packed[:, :-2]
            tokens_out, num_decoded, kv_read = packed[:, :-2], packed[:, -2], packed[:, -1]
            lps = None
            if flight["use_lp"]:
                w = (packed.shape[1] - 2) // 2
                tokens_out, lps = packed[:, :w], bits_f32(packed[:, w:2 * w])
            # Rows that finished while the chunk was in flight read their
            # context too: every row counts.
            kv_tokens = int(kv_read.sum())
            self.metrics["kv_tokens_read"] += kv_tokens
            if span:
                span.note(reqs=[self._slot_req[i].req_id for i in active
                                if self._slot_req[i] is not None],
                          kv_tokens=kv_tokens, iterations=chunk)
            if flight["use_spec"]:
                self.metrics["spec_emitted"] += int(num_decoded.sum())
                # The gate reads rows still live at apply time only: rows that
                # finished while this chunk was in flight emitted discards.
                live_rows = [i for i in active if self._slot_req[i] is not None]
                if live_rows:
                    self._update_spec_gate(int(num_decoded[live_rows].sum()), chunk, len(live_rows))
            self.metrics["steps"] += 1
            eos = self.config.special.eos_token_id
            for i in active:
                req = self._slot_req[i]
                if req is None:  # finished while this chunk was in flight
                    continue
                n = int(num_decoded[i])
                self._lengths[i] += n
                for t_idx, token in enumerate(tokens_out[i, :n].tolist()):
                    req.output_ids.append(token)
                    if req.logprobs and lps is not None:
                        req.output_logprobs.append(float(lps[i, t_idx]))
                    self.metrics["generated_tokens"] += 1
                    if (token == eos or token in req.stop_token_ids
                            or len(req.output_ids) >= req.max_new_tokens):
                        break
                self._tokens[i] = req.output_ids[-1]
                self._update_text(i)  # may finish on a stop string
                self._maybe_finish(i)

    def _land_held(self) -> None:
        """Apply the held chunk, if any."""
        flight, self._held = self._held, None
        if flight is not None:
            self._apply_chunk_results(flight)

    def _hold(self, flight: dict) -> None:
        """Apply a dispatched chunk at once if its result has landed (always
        on the CPU), else hold it for the next step."""
        if self._landed(flight):
            self._apply_chunk_results(flight)
        else:
            self._held = flight

    def _drain_inflight(self) -> None:
        """Land the held and the pipelined chunk, if any, and return the
        pages of the requests that finished meanwhile. Runs before any
        admission (except beside a chunk), preemption or rebuild of the
        chunk inputs from host state."""
        self._land_held()
        flight, self._inflight = self._inflight, None
        if flight is not None:
            self._apply_chunk_results(flight)
        for rid in self._deferred_free:
            self.allocator.free(rid)
        self._deferred_free.clear()

    def step(self) -> List[ScheduledRequest]:
        """Land the held chunk, admit, at most one chunked-prefill chunk,
        then one decode chunk (speculative while enabled, pipelined while
        event-free), held if its result has not landed. Returns the
        finished requests no earlier step returned.

        Where :attr:`arrivals` is set (an EngineWorker's probe: requests
        may arrive while a chunk runs), decode chunks are not deepened, and
        where it says that requests reached the caller while this step ran,
        the decode chunk waits for the next step, which admits them first
        (never two steps in a row)."""
        with SPANS("step"):
            if self._waiting and self._on_device():
                # Admission reuses freed slots and pages that a chunk on the
                # device may still write: what can go beside the newest
                # chunk while it runs is launched first, then the chunks
                # land, then the rest is admitted.
                newest = self._inflight or self._held
                launched = [] if self._landed(newest) else self._try_admit(beside=newest)
                self._drain_inflight()
                for batch in launched:
                    self._promote(*batch)
            else:
                self._land_held()
            self._try_admit()
            self._run_prefill_chunk()
            active = [i for i, r in enumerate(self._slot_req)
                      if r is not None and r.state == RUNNING]
            # None: no request can arrive while a chunk runs (the caller
            # steps the engine with all it has)
            pending = (self.arrivals() if self.arrivals is not None and self.tp is None
                       else None)
            self._decode_deferred = bool(pending) and not self._decode_deferred
            if active and not self._decode_deferred:
                with SPANS("decode"):
                    self._decode_chunk(active, pending)
            elif not active and self._inflight is not None:
                # Every row of the in-flight chunk finished when the chunk
                # before it landed: land it too, which returns their pages.
                self._drain_inflight()
            if not self._spec_enabled and not self.has_work():
                # Drained: give the next load a fresh speculation probe.
                self._spec_enabled, self._spec_ewma, self._spec_low_streak = True, None, 0
            out = [r for rid, r in self._finished.items() if rid not in self._reported]
            self._reported.update(r.req_id for r in out)
            return out

    def _decode_chunk(self, active: List[int], pending: Optional[bool] = None) -> None:
        """Choose the chunk's mode and depth, reserve its pages, and
        dispatch it off the device-resident inputs (rebuilt on events
        only); pipelined, it lands at the next step, else now.
        ``pending``: whether requests wait at the caller (None where none
        can arrive while the chunk runs). Where they can, the chunk is not
        deepened: a request that arrives meanwhile waits for the rest of
        the chunk."""
        s, chunk = self.sched.max_slots, self.sched.steps_per_sync
        cap = self.sched.max_pages_per_seq * self.sched.page_size
        live = [self._slot_req[i] for i in active]
        spec_k = self.sched.speculate_k
        # A logprobs request needs one logprob per token and a penalized one
        # changes token j + 1's logits with token j: neither fits the
        # verify's variable emission, so they decode plainly. The bias is
        # position-independent and composes with the verify.
        use_lp = any(r.logprobs for r in live)
        use_pen = any(r.presence_penalty != 0.0 or r.frequency_penalty != 0.0 for r in live)
        use_bias = any(bool(r.logit_bias) for r in live)
        use_spec = spec_k > 0 and self._spec_enabled and not use_lp and not use_pen
        per_iter = spec_k + 1 if use_spec else 1
        # Deep chunks count iterations; a verify iteration emits up to
        # per_iter tokens, so the depth scales down by it.
        deep = max(chunk, self.sched.max_steps_per_sync // per_iter)
        # Budgets are in tokens; with a chunk in flight the device is up to
        # `ahead` tokens past the host's view.
        remaining = min(r.max_new_tokens - len(r.output_ids) for r in live)
        ahead = self._inflight["tokens"] if self._inflight is not None else 0
        prefilling = any(r is not None and r.state == PREFILLING for r in self._slot_req)
        # Streams, stop strings and stop ids need the host after every chunk
        # (the device loop stops at EOS and the budget only).
        event_free = (not self._waiting and not pending and not prefilling
                      and not any(r.stream_cb is not None or r.stop or r.stop_token_ids
                                  for r in live))
        if (deep > chunk and event_free and pending is None
                and remaining - ahead >= deep * per_iter):
            chunk = deep
        # Logprobs, penalties and bias keep per-chunk host state (the
        # unpacking, the counts, the bias rows): those chunks stay
        # synchronous, as in the JAX engine.
        pipeline_now = (self.sched.pipeline_decode and event_free
                        and not (use_lp or use_pen or use_bias)
                        and remaining - ahead >= chunk * per_iter)
        mode = (use_spec, use_pen, use_bias)
        mode_flip = self._dev is not None and self._dev.mode != mode
        if self._inflight is not None and (not pipeline_now or self._dev is None or mode_flip):
            # The pipeline breaks (an event, a mode change, or inputs to
            # rebuild): land the in-flight chunk and go on from true state.
            self._drain_inflight()
            ahead = 0
            active = [i for i in active if self._slot_req[i] is not None]
        if mode_flip:
            self._dev = None

        # Pass 1: reserve the chunk's pages per slot. The target is clamped
        # to the per-sequence capacity (submit clamps the token budget), so
        # OutOfPages here always means pool pressure. With a chunk in flight
        # the pool is drained and retried first (the chunk's pages must not
        # be freed under it); then the youngest request is preempted.
        # Preemption may clear any slot, so the live set is re-read after.
        free_before = self.allocator.free_pages
        for i in active:
            req = self._slot_req[i]
            if req is None:  # preempted by an earlier iteration
                continue
            target = min(int(self._lengths[i]) + ahead + chunk * per_iter, cap)
            while True:
                try:
                    self.allocator.extend(req.req_id, target)
                    break
                except OutOfPages:
                    if self._inflight is not None:
                        self._drain_inflight()
                        ahead = 0
                        pipeline_now = False
                        # Rows reserved earlier in this pass looked `ahead`
                        # past a position that is now true: trim them back.
                        for j in active:
                            if j == i:
                                break
                            rj = self._slot_req[j]
                            if rj is not None:
                                self.allocator.trim(
                                    rj.req_id, min(int(self._lengths[j]) + chunk * per_iter, cap))
                        self._dev = None  # tables may have shrunk
                        if self._slot_req[i] is None:
                            break  # this row finished in the drain
                        target = min(int(self._lengths[i]) + chunk * per_iter, cap)
                        continue
                    self._preempt_youngest()
                    if self._slot_req[i] is None:
                        break  # this row preempted itself
        active = [i for i in active if self._slot_req[i] is not None]
        if self.allocator.free_pages != free_before:
            if self._inflight is not None and self._dev is not None:
                # Pages grew mid-pipeline: only the tables changed. The
                # tokens / positions / budgets carry lives on the device
                # and must not be rebuilt from the lagging host state.
                with SPANS("inputs"):
                    self._upload(self._dev.tables, self._tables(active))
            else:
                self._dev = None
        if not active:
            return

        if self._dev is None:
            with SPANS("inputs"):
                self._dev = self._chunk_inputs(active, mode)
            self.metrics["chunk_input_rebuilds"] += 1
        dev = self._dev
        with SPANS("dispatch", self.device) as span:
            packed = self._run_chunk(dev, self._chunk_key(dev, spec_k if use_spec else 0, chunk,
                                                          use_lp))
            fetch = HostFetch(packed)
            span.note(rows=len(active), iterations=chunk, spec_k=spec_k if use_spec else 0)
        if use_spec:
            self.metrics["spec_chunks"] += 1
            self.metrics["spec_slot_iters"] += chunk * len(active)
        flight = dict(fetch=fetch, active=list(active), chunk=chunk, use_lp=use_lp,
                      use_spec=use_spec, tokens=chunk * per_iter, span=span.id if span else None)
        if pipeline_now:
            # Lookahead-1: this chunk runs while the previous one lands.
            prev, self._inflight = self._inflight, flight
            self.metrics["pipelined_chunks"] += 1
            if prev is not None:
                self._hold(prev)
        else:
            self._hold(flight)

    def _tables(self, active: List[int]) -> np.ndarray:
        """[S, max_pages_per_seq] page tables of the active slots (others
        and padding -> the null page)."""
        tables = np.zeros((self.sched.max_slots, self.sched.max_pages_per_seq), np.int32)
        for i in active:
            tables[i] = self.allocator.padded_table(self._slot_req[i].req_id)
        return tables

    def _mode_inputs(self, mode: Tuple[bool, bool, bool]) -> ChunkInputs:
        """``mode``'s fixed input buffers, allocated at its first use."""
        dev = self._inputs.get(mode)
        if dev is None:
            sched = self.sched
            dev = self._inputs[mode] = ChunkInputs.allocate(
                mode, sched.max_slots, sched.max_pages_per_seq,
                sched.max_pages_per_seq * sched.page_size, self.config.decoder.vocab_size,
                sched.logit_bias_slots, self.device)
        return dev

    def _upload(self, dst: torch.Tensor, x: np.ndarray) -> None:
        """Copy a host array into a fixed device buffer in place: through
        pinned staging on the card, without blocking the host. Stream order
        keeps the copy behind a chunk in flight that reads the buffer."""
        staged = torch.from_numpy(np.ascontiguousarray(x))
        if self.device.type == "cuda":
            staged = staged.pin_memory()
        dst.copy_(staged, non_blocking=True)

    def _chunk_inputs(self, active: List[int], mode: Tuple[bool, bool, bool]) -> ChunkInputs:
        """Refill ``mode``'s fixed buffers from host state."""
        use_spec, use_pen, use_bias = mode
        s = self.sched.max_slots
        positions = np.zeros(s, np.int64)
        budgets = np.zeros(s, np.int64)
        active_mask = np.zeros(s, bool)
        for i in active:
            req = self._slot_req[i]
            positions[i] = self._lengths[i]
            budgets[i] = req.max_new_tokens - len(req.output_ids)
            active_mask[i] = True
        dev = self._mode_inputs(mode)
        host = [(dev.tokens, self._tokens), (dev.positions, positions), (dev.budgets, budgets),
                (dev.tables, self._tables(active)), (dev.active, active_mask),
                (dev.temps, self._temps), (dev.top_ps, self._top_ps), (dev.keys, self._slot_keys)]
        if use_bias:
            host += [(dev.bias_ids, self._bias_ids), (dev.bias_vals, self._bias_vals)]
        if use_pen:
            # Counts over the generated tokens since the last (re)admission,
            # as the JAX engine builds them.
            counts = np.zeros((s, self.config.decoder.vocab_size), np.int32)
            for i in active:
                np.add.at(counts[i], np.asarray(self._slot_req[i].output_ids, np.int64), 1)
            host += [(dev.counts, counts), (dev.pres, self._pres), (dev.freq, self._freq)]
        if use_spec:
            # Generated history by logical position (the draft source), plus
            # the sink column. After a preemption gen_start is the grown
            # prompt's length and the history holds only the tokens
            # generated since.
            cap = self.sched.max_pages_per_seq * self.sched.page_size
            buf = np.zeros((s, cap + 1), np.int64)
            gen_start = np.zeros(s, np.int64)
            for i in active:
                req = self._slot_req[i]
                plen = len(req.prompt_ids)
                gen_start[i] = plen
                end = min(plen + len(req.output_ids), cap)
                buf[i, plen:end] = req.output_ids[: end - plen]
            host += [(dev.buf, buf), (dev.gen_start, gen_start)]
        for dst, x in host:
            self._upload(dst, x)
        dev.any_sampled = bool(np.any(self._temps[active] > 0))
        dev.nucleus = bool(np.any(self._top_ps[active] < 1.0))
        return dev

    def _chunk_key(self, dev: ChunkInputs, spec_k: int, num_steps: int,
                   with_logprobs: bool) -> ChunkKey:
        _, use_pen, use_bias = dev.mode
        return chunk_key(spec_k, num_steps, dev.any_sampled, dev.nucleus, with_logprobs,
                         use_pen, use_bias, int4_act_quant(), self._int4_weights)

    def _chunk_program(self, dev: ChunkInputs, key: ChunkKey) -> Callable[[int, bool], torch.Tensor]:
        """The chunk of ``key`` over ``dev`` as ``run(num_steps, live)``,
        which returns the packed result. Live, it reads ``dev.active`` and
        writes the carry back into ``dev``; otherwise every row is inactive
        (only the null page is written) and the carry is dropped."""

        def run(num_steps: int, live: bool) -> torch.Tensor:
            common = dict(page_tables=dev.tables,
                          active=dev.active if live else torch.zeros_like(dev.active),
                          temperature=dev.temps, top_p=dev.top_ps, slot_keys=dev.keys,
                          any_sampled=key.any_sampled, nucleus=key.nucleus,
                          page_size=self.sched.page_size, num_steps=num_steps,
                          bias_ids=dev.bias_ids, bias_vals=dev.bias_vals, tp=self.tp)
            if key.spec_k:
                packed, carry = spec_decode_program(
                    self.params, self.model_config, self.paged, dev.buf, dev.tokens, dev.positions,
                    dev.budgets, dev.gen_start, spec_k=key.spec_k, **common)
            else:
                packed, carry = decode_program(
                    self.params, self.model_config, self.paged, dev.tokens, dev.positions,
                    dev.budgets, with_logprobs=key.with_logprobs, presence=dev.pres,
                    frequency=dev.freq, counts=dev.counts, **common)
            if live:
                for buf, value in zip((dev.tokens, dev.positions, dev.budgets), carry):
                    buf.copy_(value)
            return packed

        return run

    def _run_chunk(self, dev: ChunkInputs, key: ChunkKey) -> torch.Tensor:
        """One decode chunk over ``dev``: on the card a replay of its
        graph, captured at the key's first dispatch; else the program. The
        carry lands in ``dev``; returns the packed result, which must be
        copied out before the next chunk is dispatched."""
        program = self._chunk_program(dev, key)
        if self._graphs is None:
            return program(key.num_steps, True)
        packed = self._graphs.run(key, program)
        self.metrics["graph_captures"] = self._graphs.captures
        self.metrics["graph_replays"] = self._graphs.replays
        return packed

    # -- warmup ----------------------------------------------------------

    def warmup_plan(self, max_len: Optional[int] = None,
                    nucleus_variants: Sequence[bool] = (False, True)) -> List[Callable[[], None]]:
        """The warm thunks covering every decode chunk ``step()`` can
        dispatch without request options (a logprobs, penalties or
        logit_bias chunk is captured at its first dispatch), in the JAX
        plan's order: non-nucleus variants before nucleus, speculative
        before plain, shallow before deep. Each thunk runs its chunk over
        an all-inactive batch, which touches no live KV page: on the card
        it captures the greedy and the sampled graph, on the CPU it runs
        the program once. The JAX engine buckets page-table widths on its
        non-static routes, one program each up to ``max_len``'s; the
        port's tables are always ``max_pages_per_seq`` wide, so its plan has
        that one width whatever ``max_len`` is. Thunks run on the engine
        thread while the engine is idle."""
        sps, deep = self.sched.steps_per_sync, self.sched.max_steps_per_sync
        plain = [(0, sps)] + ([(0, deep)] if deep > sps else [])
        spec = []
        k = self.sched.speculate_k
        if k > 0:
            # step() divides the deep depth by the tokens an iteration emits.
            spec_deep = max(sps, deep // (k + 1))
            spec = [(k, sps)] + ([(k, spec_deep)] if spec_deep != sps else [])
        return [functools.partial(self._warm, spec_k, depth, bool(nucleus))
                for nucleus in nucleus_variants for spec_k, depth in spec + plain]

    def _warm(self, spec_k: int, depth: int, nucleus: bool) -> None:
        """One thunk of :meth:`warmup_plan` (``spec_k`` 0: plain decode)."""
        dev = self._mode_inputs((spec_k > 0, False, False))
        for buf in (dev.tokens, dev.positions, dev.budgets, dev.tables, dev.active, dev.keys,
                    dev.buf, dev.gen_start):
            if buf is not None:
                buf.zero_()
        dev.temps.fill_(1.0)
        dev.top_ps.fill_(0.5 if nucleus else 1.0)
        self._dev = None  # the next chunk refills from host state
        for any_sampled in (False, True) if self._graphs is not None else (True,):
            dev.any_sampled, dev.nucleus = any_sampled, nucleus
            self._run_chunk(dev, self._chunk_key(dev, spec_k, depth, False))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup_decode(self, max_len: Optional[int] = None,
                      nucleus_variants: Sequence[bool] = (False, True)) -> int:
        """Run the whole :meth:`warmup_plan` now, on an idle engine (server
        startup, before timing). Returns the number of thunks run."""
        if self.has_work():
            raise RuntimeError("warmup_decode must run on an idle engine")
        plan = self.warmup_plan(max_len, nucleus_variants)
        for thunk in plan:
            thunk()
        return len(plan)

    def queue_warmup(self, max_len: Optional[int] = None,
                     nucleus_variants: Sequence[bool] = (False, True),
                     vision_sizes: Sequence[Tuple[int, int]] = ((560, 420),)) -> int:
        """Queue the warmup for :meth:`warm_tick` (the server's engine
        thread runs one thunk per idle tick), so that the server binds at
        once. The first thunk submits warm requests, one blank page of each
        (height, width) in ``vision_sizes`` and one text prompt, which go
        through the normal step loop and build the kernels before any
        capture; the :meth:`warmup_plan` thunks follow once the engine is
        idle again. Returns the number of queued thunks."""

        def warm_requests():
            for h, w in vision_sizes:
                blank = Image.fromarray(np.zeros((h, w, 3), np.uint8))
                self.submit("warmup", images=[blank], temperature=0.0, max_new_tokens=8)
            self.submit("warmup text", temperature=0.0, max_new_tokens=8)

        self._warm_queue = [warm_requests] + self.warmup_plan(max_len, nucleus_variants)
        return len(self._warm_queue)

    @property
    def warm_pending(self) -> int:
        return len(self._warm_queue)

    def warm_tick(self) -> bool:
        """Run one queued warm thunk if the engine is idle (no live slot, no
        waiting request, no chunk in flight). Returns whether one ran."""
        if not self._warm_queue or self.has_work():
            return False
        self._warm_queue.pop(0)()
        return True

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
        """Serve a batch synchronously. ``seed``: an int reseeds the engine's
        chain once; a sequence reseeds it before each request's submit, so
        request i samples exactly as ``generate_one(..., seed=seed[i])``
        (the parser's batched PDF path passes seed + page_no)."""
        seeds: Optional[List[Optional[int]]] = None
        if seed is not None and not isinstance(seed, (int, np.integer)):
            seeds = [None if s is None else int(s) for s in seed]
            if len(seeds) != len(prompts):
                raise ValueError(f"seed sequence length {len(seeds)} != {len(prompts)} prompts")
        elif seed is not None:
            self._rng = prng_key(int(seed))
        n = len(prompts)
        images_per_prompt = images_per_prompt or [[] for _ in range(n)]
        temps = np.broadcast_to(np.asarray(temperature, np.float32), (n,))
        tps = np.broadcast_to(np.asarray(top_p, np.float32), (n,))
        group = max(1, self.sched.max_prefill_batch)
        ids = []
        for i in range(n):
            if seeds is not None and seeds[i] is not None:
                self._rng = prng_key(seeds[i])
            ids.append(self.submit(prompts[i], images=images_per_prompt[i],
                                   max_new_tokens=max_new_tokens, temperature=float(temps[i]),
                                   top_p=float(tps[i]), system_prompt=system_prompt,
                                   min_pixels=min_pixels, max_pixels=max_pixels, stop=stop))
            if i + 1 == group and n > group:
                # The first admission group is complete: start its device
                # work while the rest are preprocessed (as the JAX engine).
                self.step()
        self.run()
        return [self.request_text(rid) for rid in ids]

    def generate_one(self, prompt: str, images: Sequence = (), **kwargs) -> str:
        return self.generate_batch([prompt], [list(images)], **kwargs)[0]

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
        self._reported.discard(req_id)
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
