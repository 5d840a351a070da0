"""Token sampling: greedy / temperature / top-p with seeded, position-keyed
draws (port of ``dots_ocr_tpu.engine.sampling``).

Every draw is ``jax.random``'s, bit for bit (``jax_threefry_partitionable=
True``): keys are uint32 pairs (held in int64 tensors), ``prng_key``,
``split`` and ``fold_in`` run threefry2x32 as JAX does, and categorical
draws are Gumbel-max over the same bits (``ops/sampling.py``: on the card
``split``, ``fold_in`` and ``uniform`` are one launch of the threefry kernel
each, and a draw is one launch of the draw kernel, its rows' key folds
included; their plain versions on the CPU). So a seeded
request samples the same tokens as in the JAX package, and the engine's
position-keyed chains (:func:`fold_positions`) make the draw for position
q ``fold_in(request_key, q)`` whatever is co-batched, chunked, speculated
or preempted. The one difference left is XLA:CPU's ``log``, which can
differ from torch's by an ulp: Gumbel noise agrees to ~1e-6, and a token
can flip only at a near-tie of that size.

Top-p rows build the nucleus over an exact ``torch.topk`` pool of
NUCLEUS_TOP_K candidates, normalized by the true full-vocab logsumexp (the
JAX package's ``approx_max_k`` is exact top-k on the CPU). The speculative
verify's acceptance uniforms and corrective draws (:func:`spec_accept`)
use the same keys as the JAX verify.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from dots_ocr_tpu_torch.ops.sampling import (
    MASK32,
    bits_to_gumbel,
    fold_in,
    gumbel_argmax,
    random_bits,
    split,
    uniform,
)

NUCLEUS_TOP_K = 256


def prng_key(seed: int, device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off: the seed wraps
    to 32 bits (2^32 + 5 -> 5, -1 -> 0xFFFFFFFF) and the key is
    (0, seed mod 2^32). Returns [2] int64."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def gumbel(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` per key: [..., 2] -> [..., n]."""
    return bits_to_gumbel(random_bits(keys, n))


def categorical(keys: torch.Tensor, logits: torch.Tensor,
                temperature: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gumbel-max draw over the last axis of logits [B, V]: ``keys`` is ONE
    key [2] shared by all rows (``jax.random.categorical(key, logits)``) or
    per-row keys [B, 2] (its ``vmap``). ``temperature`` [B] divides each
    row first (fused into the draw). Returns [B] int64."""
    return gumbel_argmax(logits.contiguous(), keys, temperature)


def fold_positions(slot_keys: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Per-row sampling keys: each slot's key [S, 2] folded with the
    absolute position [S] of the token being emitted. The draw for position
    q is ``fold_in(slot_key, q)`` whatever else runs, so a request's
    sampled stream is reproducible under continuous batching."""
    return fold_in(slot_keys, positions)


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


def _rows(x, b: int, device) -> torch.Tensor:
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    return x.expand(b) if x.dim() == 0 else x


def sample_logits(
    rng: torch.Tensor,
    logits: torch.Tensor,
    temperature,
    top_p,
    nucleus: bool = True,
    any_sampled: Optional[bool] = None,
    positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Next tokens [B] int64 from logits [B, V]; temperature / top_p [B]
    (or scalars); temperature <= 0 is greedy.

    ``rng`` is ONE key [2] (the batch engine's shared draw) or per-row keys
    [B, 2]. With ``positions`` [B] the rows draw under
    ``fold_positions(rng, positions)`` (the serving engine's per-request
    chains), folded inside the draw kernel on the card. ``nucleus`` is the
    JAX package's static flag: with it, top_p < 1 rows draw from the pool
    under ``fold_in(key, 0)`` and the others from the full vocabulary under
    ``fold_in(key, 1)``; without it, every row draws from the full
    vocabulary under the key itself. ``any_sampled`` is the host's
    knowledge of whether any row samples (None: read it from
    ``temperature``): an all-greedy batch draws nothing.
    """
    logits = logits.to(torch.float32)
    b = logits.shape[0]
    temperature = _rows(temperature, b, logits.device)
    top_p = _rows(top_p, b, logits.device)
    greedy = torch.argmax(logits, dim=-1)
    if any_sampled is None:
        any_sampled = bool((temperature > 0).any())
    if not any_sampled:
        return greedy
    safe_t = torch.where(temperature > 0, temperature, torch.ones_like(temperature))
    if nucleus:
        scaled = logits / safe_t[:, None]
        # Keep tokens while the mass before them is < top_p (the first always).
        top_vals, top_idx, keep = nucleus_pool(scaled, top_p)
        pick = gumbel_argmax(top_vals.masked_fill(~keep, float("-inf")), rng,
                             positions=positions, tag=0)
        token_k = torch.gather(top_idx, 1, pick[:, None])[:, 0]
        token_full = gumbel_argmax(scaled.contiguous(), rng, positions=positions, tag=1)
        sampled = torch.where(top_p < 1.0, token_k, token_full)
    else:
        sampled = gumbel_argmax(logits.contiguous(), rng, safe_t, positions=positions)
    return torch.where(temperature > 0, sampled, greedy)


def spec_accept(
    logits: torch.Tensor,
    x_all: torch.Tensor,
    temperature: torch.Tensor,
    top_p: torch.Tensor,
    it_keys: torch.Tensor,
    any_sampled: bool,
    nucleus: bool,
):
    """Acceptance of one speculative verify (port of the acceptance block of
    ``dots_ocr_tpu.engine.scheduler.spec_decode_program``).

    logits [S, nq, V] float32 at the verified positions; x_all [S, nq] the
    current token then the nq - 1 drafts; it_keys [S, 2] the rows' keys
    folded at this iteration's first emitted position. Greedy rows accept
    the leading drafts that argmax reproduces. Sampled rows use exact
    delta-proposal rejection: draft d at column j is accepted with
    probability p_j(d) (the nucleus-truncated, renormalized p_j for rows
    with top_p < 1 when ``nucleus``), against uniforms under
    ``fold_in(it_key, 0)``; on a rejection the corrective token is drawn
    from p_j with d masked, under ``fold_in(it_key, 1)``, so the emitted
    stream has the plain sampler's distribution.

    Returns (a [S] accepted drafts, corrective [S] token at column a).
    """
    s, nq, _ = logits.shape
    rows = torch.arange(s, device=logits.device)
    drafts = x_all[:, 1:]
    greedy = temperature <= 0
    r_cor = it_keys  # an all-greedy verify draws nothing
    acc = logits[:, : nq - 1].argmax(dim=-1) == drafts
    kept_vals = top_idx = None
    if any_sampled:
        r_acc, r_cor = fold_in(it_keys, 0), fold_in(it_keys, 1)
        scaled = logits / temperature.clamp_min(1e-6)[:, None, None]
        log_u = torch.log(uniform(r_acc, nq - 1, minval=1e-20))
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
    corrective = sample_logits(r_cor, la, temperature, torch.ones_like(top_p),
                               nucleus=False, any_sampled=any_sampled)
    if kept_vals is not None:
        kv_a, ti_a = kept_vals[rows, a], top_idx[rows, a]
        kv_a = kv_a + torch.where((ti_a == d_a[:, None]) & rejected[:, None], -1e30, 0.0)
        pick = categorical(r_cor, kv_a)
        corr_nuc = ti_a.gather(1, pick[:, None])[:, 0]
        corrective = torch.where((top_p < 1.0) & ~greedy, corr_nuc, corrective)
    return a, corrective
