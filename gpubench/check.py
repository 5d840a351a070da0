"""What decides ``correct``: the served tokens held to the plain reference,
and the run's own accounting.

Once the window has closed and the program is freed, two samples of the
requests the program finished, each drawn from the seed with the longest
always in it, go through ``served_gaps`` of the configuration's
``arch/<arch>.py``: the gaps by which the served tokens' logits lie below
the reference's best. One sample is of
greedy requests (the decode path without the draw), the other of sampled
ones (the draw and the sampled verify's acceptance). Each sample's mean gap
and, where the cell names a limit for it, its widest must stay under the
cell's limits (``cells/<workload>.json``, set from the readings PERF.md
gives): ``served_gap`` / ``served_gap_mean`` for the greedy sample,
``sampled_gap`` / ``sampled_gap_mean`` for the sampled one. A sound draw at
the mixes' temperature of 0.1 nearly always takes the top token, so its
gaps stay near the greedy ones; a draw that leaves it reads far above. Two
exact checks ride along: the reference's prompt length equals the
program's for every compared request, and the tokens the requests were
served add up to the engine's counters.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from gpubench.loadgen import Traffic


def pick(requests, limits: dict, seed: int, greedy: bool = True) -> List:
    """The longest finished greedy (or sampled) request, then others in a
    seeded order until ``check_tokens`` tokens or ``check_requests``
    requests."""
    done = [r for r in requests if r.spec.greedy == greedy and r.spec.index < 10**9
            and r.error is None and r.reason not in (None, "cancelled") and r.n_out > 0]
    if not done:
        return []
    done.sort(key=lambda r: (-r.n_out, r.spec.index))
    rest = done[1:]
    order = np.random.default_rng([int(seed), 99 if greedy else 98]).permutation(len(rest))
    out = [done[0]]
    for k in order:
        if (sum(r.n_out for r in out) >= limits["check_tokens"]
                or len(out) >= limits["check_requests"]):
            break
        out.append(rest[k])
    return out


def gap_stats(gaps: "torch.Tensor") -> Dict[str, float]:
    """The spread of the served tokens' gaps: mean, the share of tokens the
    reference would not have put first, quantiles."""
    g = gaps.float()
    q = torch.quantile(g, torch.tensor([0.5, 0.9, 0.99], device=g.device)).tolist()
    return {"mean": float(g.mean()), "flip_share": float((g > 0).float().mean()),
            "p50": q[0], "p90": q[1], "p99": q[2]}


def check(cell, record, totals: Dict[str, float], seed: int, device, dtype):
    """(checked: name -> {"value", "limit"}, passing when value <= limit;
    facts about the check for the result's ``info``)."""
    from gpubench.run import weight_seed

    limits, dims, arch = cell.limits, cell.config["model"], cell.arch
    served = sum(r.n_out for r in record.requests)
    counted = int(totals.get("generated_tokens", 0)) + int(totals.get("prefills", 0))
    checked = {"token_count_gap": {"value": abs(served - counted), "limit": 0}}
    samples = {"served": pick(record.requests, limits, seed, greedy=True),
               "sampled": pick(record.requests, limits, seed, greedy=False)}
    kinds = ("served", "sampled")
    for kind in kinds:
        short = "tokens_short" if kind == "served" else "sampled_tokens_short"
        compared = sum(r.n_out for r in samples[kind])
        checked[short] = {"value": max(0, limits["min_compared_tokens"] - compared), "limit": 0}
    gaps: Dict[str, "torch.Tensor"] = {}
    prompt_gap = 0
    t = time.perf_counter()
    if any(samples.values()):
        weights = arch.make_weights(dims, weight_seed(seed), device, dtype,
                                    cell.config.get("weights"))
        traffic = Traffic(cell.mix, seed, dims)
        quantize = cell.config["serving"]["QUANTIZE"]
        for kind in kinds:
            if not samples[kind]:
                continue
            got = []
            for r in samples[kind]:
                ids = arch.prompt_ids(cell.mix["prompt"], r.spec.vision_tokens, dims)
                prompt_gap = max(prompt_gap, abs(len(ids) - r.prompt_len))
                got.append(arch.served_gaps(weights, dims, quantize, traffic.pixels(r.spec),
                                            cell.mix["prompt"], r.tokens))
            gaps[kind] = torch.cat(got)
        del weights
    checked["prompt_len_gap"] = {"value": prompt_gap, "limit": 0}
    info = {"reference_s": 0.0}
    for kind in kinds:
        every = gaps.get(kind)
        name = "served_gap" if kind == "served" else "sampled_gap"
        if name in limits:
            checked[name] = {"value": None if every is None else float(every.max()),
                             "limit": limits[name]}
        checked[name + "_mean"] = {"value": None if every is None else float(every.mean()),
                                   "limit": limits[name + "_mean"]}
        prefix = "gap_" if kind == "served" else "sampled_gap_"
        info[prefix + "requests"] = len(samples[kind])
        info[prefix + "tokens"] = sum(r.n_out for r in samples[kind])
        if every is not None:
            info.update({prefix + k: v for k, v in gap_stats(every).items()})
    info["reference_s"] = time.perf_counter() - t
    return checked, info
