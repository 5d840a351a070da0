"""Megatron-style parameter shards for tensor-parallel serving and
training, and the batch split of data parallelism (port of
``dots_ocr_tpu.parallel.sharding``).

The JAX package places one parameter tree on a ``("data", "model")`` mesh
with PartitionSpecs, and GSPMD inserts the all-reduces. A rank of the port
holds only its own pieces: :func:`shard_params` cuts the tree by
:func:`param_partition_specs` (the JAX tree with, per leaf, the axis that
is split over the ranks or None) and returns the rank's shard config, whose
head and intermediate counts are the rank's, so that the port's model
functions run on it unchanged but for one all-reduce after each
row-parallel linear (``ShardPlan.row_parallel``).

The rules, as in the JAX package: wq, wk, wv (and their biases), gate and
up are column-parallel, wo and down row-parallel, in the decoder and the
vision tower alike; the merger's fc1 (and b1) column-parallel, fc2
row-parallel, b2 added once after the sum. A split is made only where it
divides (:func:`_axis`).

Where the port departs from ``param_partition_specs`` (:data:`REPLICATED`,
listed by the tests):

* the tied embedding / lm_head stays whole on every rank, so every rank
  computes the same logits and draws the same token. The vocab split does
  not fit the W8A16 kernel (151,936 / 2 = 75,968 columns is not a multiple
  of its 128-column tiles, ``ops/int8_matmul.py::COLS``), and the gathered
  logits would need an all_gather, which torch.distributed's gloo backend
  does not offer for CUDA tensors (its table lists broadcast and all_reduce
  only). The int8 table is 233 MB a rank;
* ``patch_embed`` stays whole (its output is the residual stream every rank
  needs whole);
* an attention whose heads do not divide the ranks (no KV replica rule
  fits either, :func:`kernel_tp_degree`) stays whole, where the JAX
  package splits its columns mid-head and lets GSPMD reshard: a rank's
  kernel needs whole heads;
* under KV replication (more ranks than KV heads, :func:`paged_kv_specs`)
  wk / wv are not split evenly: rank r takes the whole of KV head
  ``r // kv_replication`` (the JAX package repeats the fresh K/V instead).

An int8 weight-only intermediate shard (gate / up columns, down rows) that
is not a multiple of 128 is padded with zero columns and zero down rows to
the next multiple: the W8A16 kernel takes N % 128 == 0 only
(``ops/int8_matmul.py::_check``), and 8,960 / 4 = 2,240 is not. The pad
adds exact zeros: its gate and up outputs are 0, silu(0) * 0 = 0, and zero
rows of down add nothing (the longer contraction may only sum in another
order).

Training adds :func:`unshard_params` (the exact inverse of
:func:`shard_params`, for whole-tensor checkpoints), :func:`leaf_roles`
(which leaves are split, whole, or split by KV head over replicas: the
global norm counts each element once), :func:`shard_batch` (``batch_specs``:
a data rank's contiguous block of rows) and :func:`kv_cache_spec`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.quantize import is_int4_kernel
from dots_ocr_tpu_torch.ops.tp import kernel_tp_degree

# The leaves the port keeps whole where the JAX package splits them (module
# notes); the attention and KV-replication departures depend on the counts.
REPLICATED = (("decoder", "embed"), ("decoder", "lm_head"),
              ("vision", "patch_embed", "kernel"), ("vision", "patch_embed", "bias"))
PAD_MULTIPLE = 128
ROW_PARALLEL_PARTS = ("decoder.attn", "decoder.mlp", "vision.attn", "vision.mlp",
                      "vision.merger")


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One rank's shard: its config (head and intermediate counts of the
    rank), the parts whose row-parallel output is a partial sum to reduce,
    the KV replication factor, and the intermediate pads."""

    rank: int
    world: int
    config: DotsOCRConfig
    row_parallel: frozenset
    kv_replication: int = 1
    decoder_pad: int = 0
    vision_pad: int = 0


def _axis(world: int, dim_size: int) -> bool:
    """Split a dim over the ranks if it divides; else replicate."""
    return world > 1 and dim_size % world == 0


def kv_replication(config: DotsOCRConfig, world: int) -> int:
    """The JAX engine's ``_kv_rep``: with more ranks than KV heads (2 KV
    heads on 4 ranks) that still divide the query heads, each KV head is
    repeated on ``world // kv_heads`` contiguous ranks."""
    d = config.decoder
    if world > 1 and d.num_kv_heads % world and world % d.num_kv_heads == 0 \
            and d.num_heads % world == 0:
        return world // d.num_kv_heads
    return 1


def _sharded_parts(config: DotsOCRConfig, world: int) -> Dict[str, bool]:
    d, v = config.decoder, config.vision
    rep = kv_replication(config, world)
    return {
        "decoder.attn": kernel_tp_degree(world, d.num_heads, d.num_kv_heads * rep) > 1,
        "decoder.mlp": _axis(world, d.intermediate_size),
        "vision.attn": kernel_tp_degree(world, v.num_heads) > 1,
        "vision.mlp": _axis(world, v.intermediate_size),
        "vision.merger": _axis(world, v.merge_dim),
    }


def param_partition_specs(config: DotsOCRConfig, world: int) -> Dict[str, Any]:
    """The JAX ``param_partition_specs`` tree with, per leaf, the axis split
    over the ranks (the position of "model" in its PartitionSpec) or None."""
    d = config.decoder
    parts = _sharded_parts(config, world)

    def attn_specs(sharded: bool, has_bias: bool):
        col, row = (2, 1) if sharded else (None, None)
        specs = {"wq": col, "wk": col, "wv": col, "wo": row}
        if has_bias:
            specs.update({"bq": 1 if sharded else None, "bk": 1 if sharded else None,
                          "bv": 1 if sharded else None})
        return specs

    def mlp_specs(sharded: bool):
        return {"gate": 2 if sharded else None, "up": 2 if sharded else None,
                "down": 1 if sharded else None}

    decoder = {
        "embed": None,
        "blocks": {
            "input_norm": None,
            "post_attn_norm": None,
            "attn": attn_specs(parts["decoder.attn"], d.qkv_bias),
            "mlp": mlp_specs(parts["decoder.mlp"]),
        },
        "final_norm": None,
    }
    if not d.tie_word_embeddings:
        decoder["lm_head"] = None
    merger = parts["vision.merger"]
    vision = {
        "patch_embed": {"kernel": None, "bias": None},
        "blocks": {
            "norm1": None,
            "norm2": None,
            "attn": attn_specs(parts["vision.attn"], config.vision.qkv_bias),
            "mlp": mlp_specs(parts["vision.mlp"]),
        },
        "post_norm": None,
        "merger": {"norm": None, "fc1": 1 if merger else None, "b1": 0 if merger else None,
                   "fc2": 0 if merger else None, "b2": None},
    }
    return {"vision": vision, "decoder": decoder}


def _expand_quant_specs(params, specs):
    """Mirror quantized kernels in the spec tree: the int8 codes
    (``qint8``, or W8A8 vision's ``qint8_act``) keep the kernel's axis, the
    per-output-column scale is split only with a column-parallel kernel
    (its last axis). int4 kernels are refused: TP serves int8 or bf16."""
    if isinstance(params, dict) and ("qint8" in params or "qint8_act" in params):
        qkey = "qint8" if "qint8" in params else "qint8_act"
        q = params[qkey]
        scale_axis = None
        if specs is not None and specs == q.dim() - 1:
            scale_axis = params["scale"].dim() - 1
        return {qkey: specs, "scale": scale_axis}
    if is_int4_kernel(params):
        raise ValueError("--quantize int4 does not compose with tensor parallelism "
                         "(as in the JAX server)")
    if isinstance(params, dict):
        return {k: _expand_quant_specs(params[k], specs[k]) for k in params}
    return specs


def paged_kv_specs(config: DotsOCRConfig, world: int) -> Tuple[int, int]:
    """(the rank's KV-pool width in heads, the KV replication factor): the
    pool holds the rank's KV heads when the decoder attention is split
    (one head each under replication), else every head."""
    rep = kv_replication(config, world)
    if _sharded_parts(config, world)["decoder.attn"]:
        return config.decoder.num_kv_heads * rep // world, rep
    return config.decoder.num_kv_heads, 1


def _pad_to(n: int) -> int:
    return -(-n // PAD_MULTIPLE) * PAD_MULTIPLE


def _narrow(x: torch.Tensor, axis: int, pieces: int, piece: int) -> torch.Tensor:
    size = x.shape[axis] // pieces
    return x.narrow(axis, piece * size, size)


def _pad(x: torch.Tensor, axis: int, extra: int, value: float) -> torch.Tensor:
    shape = list(x.shape)
    shape[axis] = extra
    return torch.cat([x, x.new_full(shape, value)], dim=axis)


def shard_params(params: dict, config: DotsOCRConfig, rank: int,
                 world: int) -> Tuple[dict, ShardPlan]:
    """Rank ``rank``'s pieces of a full parameter tree (plain, int8
    weight-only or W8A8 leaves) and its :class:`ShardPlan`. Split leaves
    are fresh contiguous tensors, so the full tree can be freed; whole
    leaves are the input's own tensors."""
    parts = _sharded_parts(config, world)
    specs = _expand_quant_specs(params, param_partition_specs(config, world))
    rep = kv_replication(config, world) if parts["decoder.attn"] else 1
    d, v = config.decoder, config.vision

    def int8_weights(kernel) -> bool:
        return isinstance(kernel, dict) and "qint8" in kernel

    def pad_for(inter: int, sharded: bool, gate) -> int:
        if not sharded or not int8_weights(gate):
            return 0
        shard = inter // world
        return _pad_to(shard) - shard

    decoder_pad = pad_for(d.intermediate_size, parts["decoder.mlp"],
                          params["decoder"]["blocks"]["mlp"]["gate"])
    vision_pad = pad_for(v.intermediate_size, parts["vision.mlp"],
                         params["vision"]["blocks"]["mlp"]["gate"])

    def cut(path: Tuple[str, ...], x: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
        if axis is None:
            return x
        pieces, piece = world, rank
        if rep > 1 and path[0] == "decoder" and {"wk", "wv", "bk", "bv"} & set(path):
            pieces, piece = world // rep, rank // rep  # the rank's whole KV head
        out = _narrow(x, axis, pieces, piece)
        pad = decoder_pad if path[0] == "decoder" else vision_pad
        if "mlp" in path and pad:
            # gate / up columns, down rows; a padded column's scale is 1
            out = _pad(out, axis, pad, 1.0 if path[-1] == "scale" else 0.0)
        return out.clone(memory_format=torch.contiguous_format)

    def walk(path, p, s):
        if isinstance(p, dict):
            return {k: walk(path + (k,), p[k], s[k]) for k in p}
        return cut(path, p, s)

    tree = walk((), params, specs)
    shard_config = config.replace(
        decoder=dataclasses.replace(
            d,
            num_heads=d.num_heads // world if parts["decoder.attn"] else d.num_heads,
            num_kv_heads=paged_kv_specs(config, world)[0],
            intermediate_size=(d.intermediate_size // world + decoder_pad
                               if parts["decoder.mlp"] else d.intermediate_size)),
        vision=dataclasses.replace(
            v,
            num_heads=v.num_heads // world if parts["vision.attn"] else v.num_heads,
            intermediate_size=(v.intermediate_size // world + vision_pad
                               if parts["vision.mlp"] else v.intermediate_size)),
    )
    plan = ShardPlan(rank=rank, world=world, config=shard_config,
                     row_parallel=frozenset(k for k, on in parts.items() if on),
                     kv_replication=rep, decoder_pad=decoder_pad, vision_pad=vision_pad)
    return tree, plan


def _kv_leaf(path: Tuple[str, ...]) -> bool:
    return path[0] == "decoder" and bool({"wk", "wv", "bk", "bv"} & set(path))


def _walk_specs(params: dict, config: DotsOCRConfig, world: int):
    """(path, leaf, split axis or None) of every leaf of ``params``."""
    specs = _expand_quant_specs(params, param_partition_specs(config, world))

    def walk(path, p, sp):
        if isinstance(p, dict):
            for k in p:
                yield from walk(path + (k,), p[k], sp[k])
        else:
            yield path, p, sp

    return walk((), params, specs)


def unshard_params(shards: List[dict], plan: ShardPlan, config: DotsOCRConfig) -> dict:
    """The whole tree from the model ranks' shards (``shards[r]`` is rank
    r's :func:`shard_params` tree, ``plan`` any rank's plan): split leaves
    concatenated, one piece a KV head under replication, the int8 pads
    dropped; a whole leaf is rank 0's. ``unshard_params(shards, plan,
    config)`` of the shards of ``x`` equals ``x`` bit for bit."""
    tree: Dict[str, Any] = {}
    for path, leaf, axis in _walk_specs(shards[0], config, plan.world):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if axis is None:
            node[path[-1]] = leaf
            continue
        pieces = [_leaf(s, path) for s in shards]
        if plan.kv_replication > 1 and _kv_leaf(path):
            pieces = pieces[::plan.kv_replication]
        pad = plan.decoder_pad if path[0] == "decoder" else plan.vision_pad
        if "mlp" in path and pad:
            pieces = [p.narrow(axis, 0, p.shape[axis] - pad) for p in pieces]
        node[path[-1]] = torch.cat(pieces, dim=axis)
    return tree


def _leaf(tree: dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def leaf_roles(params: dict, config: DotsOCRConfig, world: int) -> Dict[str, str]:
    """Each leaf's dotted name -> "split" (a shard a rank), "whole" (every
    rank holds all of it) or "kv_replica" (split by KV head, each head on
    ``kv_replication`` ranks)."""
    rep = kv_replication(config, world) if _sharded_parts(config, world)["decoder.attn"] else 1
    roles = {}
    for path, _, axis in _walk_specs(params, config, world):
        name = ".".join(path)
        if axis is None:
            roles[name] = "whole"
        else:
            roles[name] = "kv_replica" if rep > 1 and _kv_leaf(path) else "split"
    return roles


def data_rows(batch_size: int, data: int, data_rank: int) -> Tuple[int, int]:
    """[start, end) of data rank ``data_rank``'s contiguous block of rows,
    as ``P("data")`` splits them; ``np.array_split``'s blocks where the
    batch does not divide."""
    bounds = np.cumsum([0] + [len(b) for b in np.array_split(np.arange(batch_size), data)])
    return int(bounds[data_rank]), int(bounds[data_rank + 1])


def shard_batch(batch, data: int, data_rank: int):
    """A data rank's rows of a ``TrainBatch`` (``batch_specs``'s split):
    the token arrays cut to :func:`data_rows`; the packed vision inputs
    stay whole (every data rank encodes every image, as the JAX CLI and
    ``dryrun_multichip`` place only the token arrays), and each merged
    vision row is sent to its local row, or to the sentinel (local B, T)
    where its row is another rank's."""
    if data == 1:
        return batch
    b, t = batch.input_ids.shape
    start, end = data_rows(b, data, data_rank)
    rows = {k: getattr(batch, k)[start:end]
            for k in ("input_ids", "positions", "seq_lens", "target_ids", "loss_mask")}
    if batch.scatter_batch is not None:
        sb = batch.scatter_batch
        mine = (sb >= start) & (sb < end)
        rows["scatter_batch"] = torch.where(mine, sb - start, end - start).to(sb.dtype)
        rows["scatter_pos"] = torch.where(mine, batch.scatter_pos, t).to(batch.scatter_pos.dtype)
    return batch._replace(**rows)


def kv_cache_spec(config: DotsOCRConfig, data: int, model: int) -> Tuple[bool, int]:
    """``kv_cache_spec``'s dense cache [L, B, S, KV, hd] on a rank: (whether
    its batch rows are split over the data ranks, the KV heads it holds:
    split over the model ranks where they divide, else all of them)."""
    kv = config.decoder.num_kv_heads
    return data > 1, kv // model if _axis(model, kv) else kv
