"""CUDA graphs of the decode programs: the port's counterpart of the JAX
engine's compiled chunk programs.

The JAX engine compiles ``decode_program`` / ``spec_decode_program`` into
one XLA program a chunk (a ``lax.while_loop`` over the chunk's iterations)
the first time each static configuration is dispatched, and dispatches that
program once a chunk after. Eagerly, the port's programs launch every
operation of every iteration from the host. Here each chunk configuration
is captured once as one CUDA graph over the scheduler's fixed input buffers
(``scheduler.ChunkInputs``), ``num_steps`` iterations in one graph, and
every later chunk with that configuration is one ``replay()``.

The key (:class:`ChunkKey`) holds every static argument of the programs and
no more. Two keys that give the same program are made equal by
:func:`chunk_key`: ``nucleus`` only matters when a row samples, the int4
activation mode only when the weights are int4.

All graphs of an engine share one memory pool. Replays never overlap (one
stream, one engine thread), so a graph's temporaries may reuse another's;
a graph's outputs may be overwritten by the next replay of another graph,
so the caller copies what it needs (the packed result, through
``scheduler.HostFetch``) before the next replay is enqueued, and the carry
is written back into the input buffers inside the graph.

Capture happens at a key's first dispatch: one eager iteration of the
program over an all-inactive batch on the capture stream first (it builds
the kernels, sets their attributes and creates the library handles, none of
which a capture may do; it touches only the null page), then the capture of
the whole chunk. A capture or a replay that fails raises: there is no eager
fallback.

Under tensor-parallel serving over NCCL a chunk's all-reduces
(``ops/tp.py::tp_all_reduce``) are captured with it, each rank capturing
and replaying the same chunks in lockstep; gloo's host-staged all-reduce
cannot be captured, so an engine over gloo runs its chunks eagerly.

The kernel wrappers (and the all-reduce) count launches in Python ints (``<wrapper>.launches``
and its siblings), which move only while a graph is captured. The counter
deltas of a capture are kept with its graph and added at every replay, and
the capture's own increments are taken back (its kernels did not run).
"""

from __future__ import annotations

import dataclasses
import gc
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from dots_ocr_tpu_torch.ops.flash_attention import flash_attention
from dots_ocr_tpu_torch.ops.int4_matmul import int4_matmul
from dots_ocr_tpu_torch.ops.int8_matmul import w8a16_matmul
from dots_ocr_tpu_torch.ops.mla_attention import mla_paged_decode
from dots_ocr_tpu_torch.ops.paged_attention import (
    paged_attention_multiquery_bf16,
    paged_attention_multiquery_int8,
    paged_attention_stacked,
)
from dots_ocr_tpu_torch.ops.sampling import gumbel_argmax, threefry_grid
from dots_ocr_tpu_torch.ops.tp import tp_all_reduce
from dots_ocr_tpu_torch.ops.window_attention import window_attention

# Background warmup captures on the engine thread while the HTTP threads
# run: only the capturing thread is barred from unsafe CUDA calls.
CAPTURE_MODE = "thread_local"

# Every kernel wrapper; each counts its launches in attributes ending in
# "launches".
WRAPPERS = (flash_attention, paged_attention_multiquery_bf16, paged_attention_multiquery_int8,
            paged_attention_stacked, window_attention, int4_matmul, w8a16_matmul, gumbel_argmax,
            threefry_grid, tp_all_reduce, mla_paged_decode)

Counter = Tuple[Callable, str]


def launch_counts() -> Dict[Counter, int]:
    """Every wrapper's launch counters: {(wrapper, attribute): count}."""
    return {(fn, name): value for fn in WRAPPERS for name, value in vars(fn).items()
            if name.endswith("launches")}


def add_launches(deltas: Dict[Counter, int]) -> None:
    for (fn, name), delta in deltas.items():
        setattr(fn, name, getattr(fn, name) + delta)


class ChunkKey(NamedTuple):
    """The static arguments of one decode chunk program."""

    spec_k: int          # 0: decode_program; k > 0: spec_decode_program
    num_steps: int
    any_sampled: bool
    nucleus: bool
    with_logprobs: bool
    penalties: bool
    bias: bool
    int4_act: bool       # W4A8 (DOTS_INT4_ACT, read at dispatch)


def chunk_key(spec_k: int, num_steps: int, any_sampled: bool, nucleus: bool,
              with_logprobs: bool, penalties: bool, bias: bool, int4_act: bool,
              int4_weights: bool) -> ChunkKey:
    """The key of a chunk, with arguments that cannot change the program
    folded away: an all-greedy chunk never reads ``nucleus``
    (``sampling.sample_logits`` returns the argmax before it, and
    ``spec_accept`` reads it only when a row samples), and the int4
    activation mode is read only by int4 linears."""
    return ChunkKey(spec_k, num_steps, any_sampled, nucleus and any_sampled, with_logprobs,
                    penalties, bias, int4_act and int4_weights)


@dataclasses.dataclass
class _Captured:
    graph: "torch.cuda.CUDAGraph"
    packed: torch.Tensor
    launches: Dict[Counter, int]


class DecodeGraphs:
    """One engine's captured decode chunks, keyed by :class:`ChunkKey`."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self._graphs: Dict[ChunkKey, _Captured] = {}
        self.captures = 0
        self.replays = 0

    def __contains__(self, key: ChunkKey) -> bool:
        return key in self._graphs

    def __len__(self) -> int:
        return len(self._graphs)

    def run(self, key: ChunkKey, program: Callable[[int, bool], torch.Tensor]) -> torch.Tensor:
        """Replay ``key``'s graph on the current stream, capturing it first
        if it is new, and return its packed output (valid until the next
        replay of any graph of this engine). ``program(num_steps, live)``
        runs the chunk on the fixed inputs and returns the packed result:
        live, it writes the carry back into them; not live, every row is
        inactive and nothing is kept."""
        entry = self._graphs.get(key)
        if entry is None:
            entry = self._graphs[key] = self._capture(key, program)
        entry.graph.replay()
        add_launches(entry.launches)
        self.replays += 1
        return entry.packed

    def _capture(self, key: ChunkKey, program: Callable[[int, bool], torch.Tensor]) -> _Captured:
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            program(1, False)  # lazy set-up, outside the capture
        current.wait_stream(self.stream)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        # A graph that dies inside the capture (a dropped engine's, freed by
        # the cyclic collector) would destroy itself there, which a capture
        # does not permit: collect first, and not during the capture.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode=CAPTURE_MODE):
                packed = program(key.num_steps, True)
        finally:
            if collecting:
                gc.enable()
        after = launch_counts()
        add_launches({c: before[c] - after[c] for c in before})  # nothing ran yet
        self.captures += 1
        return _Captured(graph, packed, {c: after[c] - before[c] for c in before
                                         if after[c] != before[c]})

    def pool_bytes(self) -> Optional[int]:
        """Bytes the caching allocator holds in this engine's graph pool
        (its segments), or None where the allocator does not say."""
        total, seen = 0, False
        for segment in torch.cuda.memory_snapshot():
            pool = segment.get("segment_pool_id")
            if pool is None:
                continue
            seen = True
            if tuple(pool) == tuple(self.pool):
                total += segment["total_size"]
        return total if seen else None
