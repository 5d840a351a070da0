"""Exact host-side replica of the device n-gram drafter (greedy rows).

For GREEDY (temperature 0) rows the speculative pipeline in
``scheduler.spec_decode_program`` is fully deterministic: the draft is a
pure function of the generated-token history (last-bigram prompt lookup,
the JAX package's scheduler.py:413-435) and acceptance is the longest prefix where the
drafts reproduce the true next tokens (scheduler.py:513-515, with the
bonus/corrective token making every iteration emit ``accepted + 1``).
That means the acceptance the engine would measure on ANY deterministic
token stream is computable on the host without a model or a chip — this
module replays the exact rule, and ``tests/test_spec_realism.py`` pins it
against the real device program (a bigram-table model run through the
CPU engine produces the same totals).

Used by ``tools/spec_realism.py`` to measure draft acceptance on
realistic layout-JSON / markdown / HTML-table / SVG token streams — the
workloads ``SPECULATE_K`` ships ON for (deploy/shipping.env) — replacing
the zeros-weights full-acceptance ceiling as the evidence behind the
default (VERDICT r3 #6).

Reference analog: vLLM's [ngram] speculative config the reference's
server could enable; the reference itself documents decode degeneration
on repetitive outputs (reference/dots_ocr/utils/output_cleaner.py),
which is the same repetitiveness speculation converts into throughput.

A copy of ``dots_ocr_tpu.engine.spec_sim`` whose ``bigram_decoder_params``
builds the port's parameter tree; the port's scheduler drafts and accepts
by the same rule, so its ``spec_*`` counters match the simulator too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from dots_ocr_tpu_torch.models.init import zeros_params


@dataclass
class SpecSimResult:
    """Per-stream simulation summary."""

    spec_k: int
    num_tokens: int            # tokens emitted through spec iterations
    num_iters: int             # verify iterations (slot-iters)
    emitted_per_iter: float    # num_tokens / num_iters  (1.0 .. k+1)
    acceptance: float          # mean accepted drafts / k  (0 .. 1)
    per_iter: List[int]        # emitted tokens per iteration (trace)

    @property
    def speedup_vs_plain(self) -> float:
        """Throughput ratio at measured verify/plain step costs.

        Uses the r3 on-chip cost ratio (BENCH_SPEC_CURVE_r3: verify
        15.5 ms vs plain 11.7 ms at k=3, 64 slots) as the default model:
        tok/s ∝ emitted_per_iter / cost_ratio.
        """
        return self.emitted_per_iter / 1.33


def simulate_greedy_spec(stream: Sequence[int], spec_k: int) -> SpecSimResult:
    """Replay the device drafter + greedy acceptance over a token stream.

    ``stream`` is the true greedy generation (generated tokens only;
    ``stream[0]`` is the token the prefill step emits — speculation starts
    with it as ``current``). Returns the per-iteration emitted counts the
    device loop would produce.

    Exact correspondences to scheduler.spec_decode_program:
      * draft source window: generated history only (tpos >= gen_start+1,
        tpos <= pos-1) — prompt tokens never match;
      * LAST bigram match wins (the max over matching positions);
      * draft tokens beyond the committed position fall back to repeating
        ``current`` (the period-1-loop catcher), as does a no-match row;
      * greedy acceptance = longest prefix of drafts equal to the true
        next tokens; every iteration emits ``accepted + 1`` (the bonus /
        corrective argmax token).
    """
    if spec_k < 1:
        raise ValueError("spec_k must be >= 1")
    n = len(stream)
    per_iter: List[int] = []
    # last position (index into stream, >= 1) of each bigram
    # (stream[t-1], stream[t]) among t <= i-1; maintained incrementally so
    # long streams stay O(n).
    last_bigram: Dict[Tuple[int, int], int] = {}
    indexed = 0  # bigrams at positions t < indexed are in the dict

    i = 0
    while i < n - 1:
        # Index bigrams up to t = i-1 (the device mask: tpos <= pos-1).
        while indexed < i:
            t = indexed
            if t >= 1:
                last_bigram[(stream[t - 1], stream[t])] = t
            indexed += 1

        current = stream[i]
        t_star = -1
        if i >= 1:
            t_star = last_bigram.get((stream[i - 1], current), -1)

        draft: List[int] = []
        for j in range(1, spec_k + 1):
            if t_star >= 0 and t_star + j <= i:
                draft.append(stream[t_star + j])
            else:
                draft.append(current)

        a = 0
        while a < spec_k and i + 1 + a < n and draft[a] == stream[i + 1 + a]:
            a += 1
        m = min(a + 1, n - 1 - i)
        per_iter.append(m)
        i += m

    total = sum(per_iter)
    iters = len(per_iter)
    return SpecSimResult(
        spec_k=spec_k,
        num_tokens=total,
        num_iters=iters,
        emitted_per_iter=total / iters if iters else 0.0,
        acceptance=(total - iters) / (iters * spec_k) if iters else 0.0,
        per_iter=per_iter,
    )


def bigram_chain(table: Dict[int, int], start: int, length: int) -> List[int]:
    """The deterministic stream a bigram-table model generates greedily.

    ``table[c]`` is the successor of token c; ``start`` is the prompt's
    last token (the first generated token is ``table[start]``).
    """
    out: List[int] = []
    cur = start
    for _ in range(length):
        cur = table[cur]
        out.append(cur)
    return out


def bigram_decoder_params(config, table: Dict[int, int],
                          device: torch.device = torch.device("cuda")):
    """Parameters that make the decoder a pure bigram table (the port's
    tree on ``device``, in the config dtype).

    Requires ``config.decoder.tie_word_embeddings == False`` and
    ``hidden_size >= vocab_size``. Embedding rows are one-hot (identity
    into the first V hidden dims); every block's projections are zero so
    the residual stream passes the one-hot through untouched; the final
    RMSNorm rescales it to ``sqrt(D) * onehot``; ``lm_head[c, table[c]]
    = 1`` makes the argmax the successor — so greedy generation walks the
    table exactly, from any prompt, which gives the speculative engine a
    deterministic nontrivial stream whose acceptance the host simulator
    predicts token-for-token.
    """
    dec = config.decoder
    if dec.tie_word_embeddings:
        raise ValueError("needs an untied lm_head")
    V, D = dec.vocab_size, dec.hidden_size
    if D < V:
        raise ValueError(f"hidden_size {D} must cover vocab {V} for one-hot rows")

    params = zeros_params(config, device)
    embed = torch.zeros((V, D), dtype=config.torch_dtype, device=device)
    embed[:, :V] = torch.eye(V, dtype=config.torch_dtype, device=device)
    head = torch.zeros((D, V), dtype=config.torch_dtype, device=device)
    for c, nxt in table.items():
        head[c, nxt] = 1.0
    params["decoder"]["embed"] = embed
    params["decoder"]["lm_head"] = head
    return params
