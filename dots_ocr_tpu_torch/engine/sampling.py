"""Token sampling: greedy / temperature / top-p (port of
``dots_ocr_tpu.engine.sampling``).

Temperature rows draw by Gumbel-max over the full vocabulary, with the
noise from a ``torch.Generator``. Top-p rows build the nucleus over an exact
``torch.topk`` pool of NUCLEUS_TOP_K candidates, normalized by the true
full-vocab logsumexp. The generator gives other numbers than JAX's keys
from the same seed, so only greedy streams match the JAX package token for
token; seeded, position-keyed sampling is not ported yet. The speculative
verify's acceptance and corrective draws (:func:`spec_accept`) use the same
pool and generator.

The generator is stateful: every step draws for all rows, also for rows
whose tokens the host discards. A pipelined engine dispatches a chunk
before it has read whether the chunk before finished a row, and that
extra chunk draws too, so unseeded sampled streams (temperature > 0) may
differ from a synchronous engine's. Greedy streams draw nothing and do
not.
"""

from __future__ import annotations

import torch

NUCLEUS_TOP_K = 256


def _gumbel_argmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1)


def sample_logits(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    any_sampled: bool,
) -> torch.Tensor:
    """Next tokens [B] int64 from logits [B, V] float32.

    temperature/top_p: [B]; temperature <= 0 is greedy. ``any_sampled`` is
    the host's knowledge of whether any row samples: an all-greedy batch
    (the OCR/layout default) draws no noise and needs no host sync.
    """
    logits = logits.to(torch.float32)
    greedy = torch.argmax(logits, dim=-1)
    if not any_sampled:
        return greedy
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    # Keep tokens while the mass before them is < top_p (the first always).
    top_vals, top_idx, keep = nucleus_pool(scaled, top_p)
    pick = _gumbel_argmax(top_vals.masked_fill(~keep, float("-inf")), generator)
    token_k = torch.gather(top_idx, 1, pick[:, None])[:, 0]
    token_full = _gumbel_argmax(scaled, generator)
    sampled = torch.where(top_p < 1.0, token_k, token_full)
    return torch.where(temperature > 0, sampled, greedy)


def nucleus_pool(scaled: torch.Tensor, top_p: torch.Tensor):
    """The top-p candidate pool of :func:`sample_logits` over the last axis:
    (top_vals, top_idx, keep) with keep marking the kept prefix by true
    (full-vocab) cumulative probability. top_p broadcasts over the leading
    axes of ``scaled`` from its first."""
    k = min(NUCLEUS_TOP_K, scaled.shape[-1])
    top_vals, top_idx = torch.topk(scaled, k, dim=-1)
    top_probs = torch.exp(top_vals - torch.logsumexp(scaled, dim=-1, keepdim=True))
    tp = top_p.reshape(top_p.shape + (1,) * (scaled.dim() - top_p.dim()))
    keep = (torch.cumsum(top_probs, dim=-1) - top_probs) < tp
    return top_vals, top_idx, keep


def spec_accept(
    logits: torch.Tensor,
    x_all: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    generator: torch.Generator,
    any_sampled: bool,
    nucleus: bool,
):
    """Acceptance of one speculative verify (port of the acceptance block of
    ``dots_ocr_tpu.engine.scheduler.spec_decode_program``).

    logits [S, nq, V] float32 at the verified positions; x_all [S, nq] the
    current token then the nq - 1 drafts. Greedy rows accept the leading
    drafts that argmax reproduces. Sampled rows use exact delta-proposal
    rejection: draft d at column j is accepted with probability p_j(d)
    (the nucleus-truncated, renormalized p_j for rows with top_p < 1 when
    ``nucleus``), and on a rejection the corrective token is drawn from p_j
    with d masked, so the emitted stream has the plain sampler's
    distribution. Draws come from ``generator``.

    Returns (a [S] accepted drafts, corrective [S] token at column a).
    """
    s, nq, _ = logits.shape
    rows = torch.arange(s, device=logits.device)
    drafts = x_all[:, 1:]
    greedy = temperature <= 0
    acc = logits[:, : nq - 1].argmax(dim=-1) == drafts
    kept_vals = top_idx = None
    if any_sampled:
        scaled = logits / temperature.clamp_min(1e-6)[:, None, None]
        log_u = torch.log(torch.rand((s, nq - 1), generator=generator, device=logits.device)
                          .clamp_min(1e-20))
        logp = torch.log_softmax(scaled[:, : nq - 1], dim=-1)
        acc_sampled = log_u < logp.gather(2, drafts[..., None])[..., 0]
        if nucleus:
            top_vals, top_idx, keep = nucleus_pool(scaled, top_p)
            kept_vals = top_vals.masked_fill(~keep, float("-inf"))
            lse_kept = torch.logsumexp(kept_vals[:, : nq - 1], dim=-1)
            dmatch = (top_idx[:, : nq - 1] == drafts[..., None]) & keep[:, : nq - 1]
            lv = top_vals[:, : nq - 1].masked_fill(~dmatch, float("-inf")).amax(dim=-1)
            acc_sampled = torch.where(top_p[:, None] < 1.0, log_u < lv - lse_kept, acc_sampled)
        acc = torch.where(greedy[:, None], acc, acc_sampled)
    a = torch.cumprod(acc.to(torch.int64), dim=1).sum(dim=1)

    # Corrective (or bonus) token at column a; a rejected draft is masked
    # (for greedy rows argmax already differs from it).
    rejected = a < nq - 1
    d_a = x_all[rows, (a + 1).clamp_max(nq - 1)]
    la = logits[rows, a]
    la[rows, d_a] += torch.where(rejected, -1e30, 0.0)
    corrective = sample_logits(la, temperature, torch.ones_like(top_p), generator, any_sampled)
    if kept_vals is not None:
        kv_a, ti_a = kept_vals[rows, a], top_idx[rows, a]
        kv_a = kv_a.masked_fill((ti_a == d_a[:, None]) & rejected[:, None], float("-inf"))
        pick = _gumbel_argmax(kv_a, generator)
        corr_nuc = ti_a.gather(1, pick[:, None])[:, 0]
        corrective = torch.where((top_p < 1.0) & ~greedy, corr_nuc, corrective)
    return a, corrective
