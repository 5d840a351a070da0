"""DeepSeek-V3's mixture-of-experts block, for a device that holds a share
of the routed experts (expert parallelism without its exchange).

The router is a float32 linear over all ``n_routed_experts`` experts and
chooses as DeepSeek's ``noaux_tc`` does (:func:`route_noaux_tc`). The block
then computes only the (token, expert) assignments that land on the experts
this device holds (``DeepseekConfig.experts_held``), sorted by expert into
one grouped product a projection (``torch._grouped_mm`` with the group ends
on the device: no host sync, so a decode step is captured in a CUDA graph),
and adds the shared experts. Assignments to experts held elsewhere add
nothing here: that partial result is what a rank of an expert-parallel
deployment computes before its exchange.

Parameters (one MoE layer; kernels ``[in, out]`` as everywhere in the port):
  moe:    router [D, E] (the router's full width), correction [E] (the
          choice-only bias), gate / up [E_held, D, I], down [E_held, I, D]
  shared: gate / up [D, n_shared * I], down [n_shared * I, D] (a linear
          kernel or one of ``models/quantize.py``'s quantized dicts)
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dots_ocr_tpu_torch.models.config import DeepseekConfig
from dots_ocr_tpu_torch.models.layers import swiglu


def top_k_stable(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest values along the last axis, the lower index
    first among equal values (a stable descending sort), so that ties
    choose the same on every device."""
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


def route_noaux_tc(x: torch.Tensor, router: torch.Tensor, correction: torch.Tensor,
                   ds: DeepseekConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """DeepSeek-V3's choice over all experts for tokens x [T, D]: sigmoid
    scores of the float32 router; score plus the correction bias for the
    choice only; each group scored by the sum of its top two, the best
    ``topk_group`` groups kept (the others' experts score 0 in the choice);
    the top ``num_experts_per_tok``. Weights are the chosen experts'
    unbiased scores, divided by their sum (``norm_topk_prob``), times
    ``routed_scaling_factor``. Returns (expert ids [T, k] int64, weights
    [T, k] float32)."""
    scores = torch.sigmoid(x.to(torch.float32) @ router.to(torch.float32))
    choice = scores + correction.to(torch.float32)
    t, e = choice.shape
    groups = choice.view(t, ds.n_group, e // ds.n_group)
    group_scores = groups.topk(2, dim=-1).values.sum(dim=-1)
    kept = torch.zeros_like(group_scores, dtype=torch.bool)
    kept.scatter_(1, top_k_stable(group_scores, ds.topk_group), True)
    choice = choice.masked_fill(~kept.repeat_interleave(e // ds.n_group, dim=1), 0.0)
    idx = top_k_stable(choice, ds.num_experts_per_tok)
    weight = scores.gather(1, idx)
    if ds.norm_topk_prob and ds.num_experts_per_tok > 1:
        weight = weight / (weight.sum(dim=-1, keepdim=True) + 1e-20)
    return idx, weight * ds.routed_scaling_factor


def held_experts(x: torch.Tensor, local: torch.Tensor, weight: torch.Tensor,
                 held: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The held experts' weighted SwiGLU outputs for tokens x [T, D]:
    ``local`` [T, k] each assignment's expert among the held ones, ``held``
    [T, k] whether it is computed here, ``weight`` [T, k] its routing weight.
    The assignments are sorted by expert (the others last) and run as one
    grouped product a projection (``torch._grouped_mm``: rows [ends[g-1],
    ends[g]) times expert g; rows past ends[-1] are not computed and hold no
    defined value). Returns (float32 [T, D], the assignments each held
    expert took [E_held] int64)."""
    t, k = local.shape
    n_held = gate.shape[0]
    key = torch.where(held, local, n_held).reshape(-1)
    order = torch.argsort(key, stable=True)
    per_expert = torch.zeros(n_held + 1, dtype=torch.int64, device=x.device)
    per_expert.scatter_add_(0, key, torch.ones_like(key))
    ends = per_expert[:n_held].cumsum(0).to(torch.int32)
    xs = x[order // k].to(gate.dtype)
    h = (F.silu(torch._grouped_mm(xs, gate, offs=ends).to(torch.float32)).to(xs.dtype)
         * torch._grouped_mm(xs, up, offs=ends))
    y = torch._grouped_mm(h, down, offs=ends)
    computed = torch.arange(t * k, device=x.device) < ends[-1]
    contrib = torch.where(computed[:, None],
                          y.to(torch.float32) * weight.reshape(-1)[order][:, None], 0.0)
    back = torch.empty_like(contrib)
    back[order] = contrib  # each assignment back to its (token, slot): a fixed order of sums
    return back.view(t, k, -1).sum(dim=1), per_expert[:n_held]


def moe_block(h: torch.Tensor, moe: dict, shared: dict, ds: DeepseekConfig,
              live: Optional[torch.Tensor] = None,
              stats: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MoE layer's output for normed hidden states h [B, ..., D]: the
    shared experts plus the held experts' part. ``live`` [B, ...] bool: the
    tokens that count (padding and idle slots are routed but neither
    computed nor counted). ``stats`` [B, 2] int64, added to in place:
    column 0 each row's assignments that landed on a held expert, [0, 1]
    the busiest held expert's count."""
    b, d = h.shape[0], h.shape[-1]
    x = h.reshape(-1, d)
    idx, weight = route_noaux_tc(x, moe["router"], moe["correction"], ds)
    first, count = ds.experts_held
    local = idx - first
    held = (local >= 0) & (local < count)
    if live is not None:
        held = held & live.reshape(-1, 1)
    routed, per_expert = held_experts(x, local, weight, held, moe["gate"], moe["up"], moe["down"])
    if stats is not None:
        stats[:, 0] += held.view(b, -1).sum(dim=1)
        stats[0, 1] += per_expert.max()
    out = routed + swiglu(x, shared["gate"], shared["up"], shared["down"]).to(torch.float32)
    return out.to(h.dtype).view(h.shape)
