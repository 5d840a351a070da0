"""The one traffic generator: a mix is a data file of parameters
(``traffic/<name>.json``) and this reads it.

A closed loop starts near its steady mix: each caller's first request
has a budget drawn uniformly below its full length, and these first
requests (sizes, budgets, where each stands in its budget) are the same for
every seed, so that every run starts from the same mix; the seed orders
every request after them.

Every draw is stratified: a quantity takes the ``strata`` quantiles of its
distribution, each once, in an order the seed permutes (a fresh permutation
for every further block of ``strata`` requests). So every seed sends the
same sizes and the same gaps, in another order, and runs of one cell do the
same work whatever the seed. A mix's keys:

  loop             "closed" (``callers`` each wait for their reply) or
                   "open" (Poisson arrivals at ``rate_per_s``)
  prompt           the instruction text of every request
  megapixels       {"low", "high"}: the page's area before smart_resize,
                   log-uniform
  aspect           {"low", "high"}: width over height, log-uniform
  max_new_tokens   {"low", "high"}: the token budget, log-uniform
  temperature, top_p
  greedy_every     every n-th request is greedy (temperature 0); the
                   correctness check compares greedy and sampled requests
                   apart
  warmup_requests  requests of the extreme sizes sent during set-up (open
                   loop: their shapes are then warm when the window opens)
  strata           quantiles per block (default 256)
  requests         open loop: the most requests a run sends (default: as
                   many as its window holds). With ``strata`` equal to it,
                   and the block's gaps adding up to less than the window,
                   every seed sends exactly one block: the same sizes,
                   budgets and gaps, only their order drawn from the seed
  order            "permute" (default: each seed draws its own order) or
                   "rotate": every seed sends one fixed order (seed 0's),
                   each block started at a point the seed draws, so that
                   the same requests arrive together, with the same gaps
                   between them, in every run
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from gpubench import work


@dataclasses.dataclass
class RequestSpec:
    index: int
    height: int
    width: int
    max_new_tokens: int
    temperature: float
    top_p: float
    seed: int
    patches: int
    vision_tokens: int

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0


class Traffic:
    def __init__(self, mix: dict, seed: int, dims: dict):
        self.mix, self.seed, self.dims = mix, int(seed), dims
        self.strata = int(mix.get("strata", 256))
        self._perms: Dict[tuple, np.ndarray] = {}
        self.rotate = mix.get("order", "permute") == "rotate"
        self.offset = (int(np.random.default_rng([self.seed, 0x726F74]).integers(self.strata))
                       if self.rotate else 0)

    # -- stratified draws ------------------------------------------------------

    def _perm(self, what: str, block: int, seed: int) -> np.ndarray:
        key = (what, block, seed)
        if key not in self._perms:
            tag = sum(ord(ch) << (8 * (k % 4)) for k, ch in enumerate(what))
            rng = np.random.default_rng([seed, tag, block])
            self._perms[key] = rng.permutation(self.strata)
        return self._perms[key]

    def _quantile(self, what: str, index: int, fixed: bool = False) -> float:
        """The index-th draw's quantile in (0, 1) of the ``what`` stream;
        ``fixed``: the same for every seed."""
        seed = 0 if fixed or self.rotate else self.seed
        if self.rotate and not fixed:
            index = self._rotated(index)
        k = self._perm(what, index // self.strata, seed)[index % self.strata]
        return (k + 0.5) / self.strata

    def _rotated(self, index: int) -> int:
        """Where the index-th request stands in the fixed order of "rotate"."""
        block, k = divmod(index, self.strata)
        return block * self.strata + (k + self.offset) % self.strata

    def _log_uniform(self, what: str, index: int, fixed: bool = False) -> float:
        r = self.mix[what]
        lo, hi = math.log(r["low"]), math.log(r["high"])
        return math.exp(lo + self._quantile(what, index, fixed) * (hi - lo))

    # -- requests -------------------------------------------------------------

    def request(self, index: int, first_of_caller: bool = False) -> RequestSpec:
        area = self._log_uniform("megapixels", index, first_of_caller) * 1e6
        aspect = self._log_uniform("aspect", index, first_of_caller)
        h, w = work.smart_resize(max(1, round(math.sqrt(area / aspect))),
                                 max(1, round(math.sqrt(area * aspect))))
        budget = self._log_uniform("max_new_tokens", index, first_of_caller)
        if first_of_caller:
            budget *= self._quantile("first_budget", index, fixed=True)
        every = int(self.mix.get("greedy_every", 0))
        place = self._rotated(index) if self.rotate else index
        greedy = every > 0 and place % every == every - 1
        patches, merged = work.page_patches(h, w, self.dims)
        rs = np.random.default_rng([self.seed, index, 7]).integers(0, 2**31 - 1)
        return RequestSpec(
            index=index, height=h, width=w, max_new_tokens=max(1, int(round(budget))),
            temperature=0.0 if greedy else float(self.mix["temperature"]),
            top_p=float(self.mix["top_p"]), seed=int(rs), patches=patches,
            vision_tokens=merged)

    def pixels(self, spec: RequestSpec) -> np.ndarray:
        """The page: a seeded 56 x 56 tile of noise repeated over the page
        (the size, not the content, sets the work on random weights)."""
        rng = np.random.default_rng([self.seed, spec.index, 11])
        tile = rng.integers(0, 256, (56, 56, 3), dtype=np.uint8)
        reps = (-(-spec.height // 56), -(-spec.width // 56), 1)
        return np.ascontiguousarray(np.tile(tile, reps)[:spec.height, :spec.width])

    def warmup(self) -> List[RequestSpec]:
        """Set-up requests at the mix's extreme page sizes and a short budget,
        numbered after every request a run can send."""
        n = int(self.mix.get("warmup_requests", 0))
        out = []
        for j in range(n):
            area = self.mix["megapixels"]["high" if j % 2 == 0 else "low"] * 1e6
            h, w = work.smart_resize(round(math.sqrt(area)), round(math.sqrt(area)))
            patches, merged = work.page_patches(h, w, self.dims)
            out.append(RequestSpec(index=10**9 + j, height=h, width=w, max_new_tokens=8,
                                   temperature=float(self.mix["temperature"]),
                                   top_p=float(self.mix["top_p"]), seed=j, patches=patches,
                                   vision_tokens=merged))
        return out

    def gaps(self, count: int) -> List[float]:
        """The open loop's first ``count`` inter-arrival gaps (s): quantiles
        of the exponential distribution at ``rate_per_s``."""
        rate = float(self.mix["rate_per_s"])
        return [-math.log(1.0 - self._quantile("gaps", i)) / rate for i in range(count)]


def max_requests(mix: dict, seconds: float) -> Optional[int]:
    """How many requests an open loop can send in ``seconds`` (with room)."""
    if mix["loop"] != "open":
        return None
    room = int(mix["rate_per_s"] * seconds * 3 + 64)
    return min(room, int(mix["requests"])) if "requests" in mix else room
