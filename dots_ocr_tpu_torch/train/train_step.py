"""Multimodal training step over the full VLM (port of
``dots_ocr_tpu.train.train_step``): masked next-token cross entropy, AdamW
with global-norm clipping, optional per-layer remat.

The model runs the JAX loss's path, ``attn_impl="xla"`` (dense attention,
differentiated by autograd): no attention kernel has a backward, in either
package. The optimizer reproduces optax's ``chain(clip_by_global_norm(c),
adamw(lr, b1, b2, weight_decay=wd))`` in plain torch, one leaf at a time;
JAX has no kernel for it either. Parameters and moments are updated in
place, where the JAX step donates its state and returns new arrays.

Over a (data, model) layout of ranks (``tp``, a
``parallel.distributed.TPGroup``) each rank holds its shard of the state
(:func:`shard_train_state`) and its data rank's rows of the batch
(``parallel.sharding.shard_batch``), and the step computes what the JAX step
computes under ``jax.set_mesh(make_mesh(data, model))``, the single-device
step on the whole batch: the model's f / g collectives (``ops/tp.py``), the
loss's numerator on the rank's rows over the denominator summed over the
data group, the gradients summed (not averaged) over the data group and,
for a KV head repeated on several ranks, over its replicas, and a global
norm that counts every element once (:func:`sharded_global_norm`).
Clipping and AdamW are elementwise, so they run on each shard unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.models.rope import vision_grid_positions, vision_rope_table
from dots_ocr_tpu_torch.models.vlm import build_scatter_indices, vlm_prefill
from dots_ocr_tpu_torch.ops.tp import train_all_reduce
from dots_ocr_tpu_torch.parallel.distributed import join_replica_groups
from dots_ocr_tpu_torch.parallel.sharding import leaf_roles, shard_params


class TrainBatch(NamedTuple):
    """One packed multimodal batch (padded to static shapes)."""

    input_ids: torch.Tensor       # [B, T]
    positions: torch.Tensor       # [B, T]
    seq_lens: torch.Tensor        # [B]
    target_ids: torch.Tensor      # [B, T] next-token targets
    loss_mask: torch.Tensor       # [B, T] 1.0 on supervised positions
    # Packed vision inputs (None for text-only batches).
    patches: Optional[torch.Tensor] = None
    rope_cos: Optional[torch.Tensor] = None
    rope_sin: Optional[torch.Tensor] = None
    segment_ids: Optional[torch.Tensor] = None
    scatter_batch: Optional[torch.Tensor] = None
    scatter_pos: Optional[torch.Tensor] = None


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState``: the step count (int32) and the moment
    trees, in the parameters' dtype."""

    count: torch.Tensor
    mu: Any
    nu: Any


class TrainState(NamedTuple):
    params: Any
    opt_state: AdamState
    step: torch.Tensor  # int32 scalar on the parameters' device


def tree_items(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(dotted name, leaf) of a nested dict, in insertion order."""
    out = []
    for key, value in tree.items():
        name = f"{prefix}{key}"
        out += tree_items(value, name + ".") if isinstance(value, dict) else [(name, value)]
    return out


def tree_from_items(items) -> Dict[str, Any]:
    """Inverse of :func:`tree_items`."""
    tree: Dict[str, Any] = {}
    for name, value in items:
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _zeros_like(tree):
    return {k: _zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v)
            for k, v in tree.items()}


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    top = torch.iinfo(count.dtype).max
    return torch.where(count < top, count + 1, count)


def _squares(tensors) -> torch.Tensor:
    return torch.stack([torch.sum(torch.square(t), dtype=torch.float32) for t in tensors]).sum()


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(t * t), in float32."""
    return _squares(tensors).sqrt()


def sharded_global_norm(named_grads, roles: Dict[str, str], tp) -> torch.Tensor:
    """optax's global norm of the whole gradient, from one rank's shards:
    the squares of split leaves summed over the model group, those of a
    KV-replicated leaf once a KV head (on the head's first replica), those
    of a whole leaf once (every rank holds them equal). float32."""
    rep = tp.plan.kv_replication
    split = [g for name, g in named_grads if roles[name] == "split"
             or (roles[name] == "kv_replica" and tp.rank % rep == 0)]
    whole = [g for name, g in named_grads if roles[name] == "whole"]
    total = _squares(split) if split else torch.zeros((), device=tp.device)
    if tp.world > 1:
        total = train_all_reduce(total, tp)
    if whole:
        total = total + _squares(whole)
    return total.sqrt()


@dataclass(frozen=True)
class AdamW:
    """optax's ``chain(clip_by_global_norm(grad_clip), adamw(learning_rate,
    b1, b2, eps, eps_root=0, weight_decay))``, applied in place.

    Each rule as optax writes it: the gradients are clipped only when their
    global norm g is >= ``grad_clip``, to ``(t / g) * grad_clip`` (not
    ``clip_grad_norm_``'s ``t * c / (g + 1e-6)``); the moments are
    ``(1 - b) * g^k + b * m``; the update is ``m̂ / (sqrt(v̂) + eps)`` with
    each moment divided by ``1 - b ** count`` (computed in float32, then
    cast to the moment's dtype), plus ``weight_decay * p`` on every leaf
    (norms and biases included), times ``-learning_rate``. The global norm
    sums in float32 (optax sums a bf16 leaf in bf16).
    """

    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    eps: float = 1e-8

    def init(self, params) -> AdamState:
        device = tree_items(params)[0][1].device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device),
                         _zeros_like(params), _zeros_like(params))

    def update(self, params, grads: List[torch.Tensor], state: AdamState,
               g_norm: Optional[torch.Tensor] = None) -> Tuple[AdamState, torch.Tensor]:
        """One step: ``params`` and the moments are updated in place, in
        the order of :func:`tree_items`. Returns (the new state, the global
        norm of ``grads`` before clipping: ``g_norm`` when given, the
        norm of a sharded gradient). No host sync."""
        if g_norm is None:
            g_norm = global_norm(grads)
        keep = g_norm < self.grad_clip
        count = _safe_increment(state.count)
        bc1, bc2 = (1 - torch.full((), b, device=count.device).pow(count)
                    for b in (self.b1, self.b2))
        mus, nus = tree_items(state.mu), tree_items(state.nu)
        for (_, p), g, (_, m), (_, v) in zip(tree_items(params), grads, mus, nus):
            g = torch.where(keep, g, (g / g_norm.to(g.dtype)) * self.grad_clip)
            m.copy_((1 - self.b1) * g + self.b1 * m)
            v.copy_((1 - self.b2) * (g * g) + self.b2 * v)
            u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype)) + self.eps)
            u = (u + self.weight_decay * p) * -self.learning_rate
            p.add_(u)
        return AdamState(count, state.mu, state.nu), g_norm


def make_optimizer(
    learning_rate: float = 1e-5,
    weight_decay: float = 0.01,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip: float = 1.0,
) -> AdamW:
    return AdamW(learning_rate, weight_decay, b1, b2, grad_clip)


def _check_float(params) -> None:
    for name, p in tree_items(params):
        if not p.is_floating_point():
            raise ValueError(f"training needs a float parameter tree: {name} is {p.dtype} "
                             "(a quantized tree has no gradient, in the JAX package either)")


def init_train_state(params, optimizer: AdamW) -> TrainState:
    _check_float(params)
    state = optimizer.init(params)
    return TrainState(params, state, torch.zeros_like(state.count))


def shard_for_training(params, config: DotsOCRConfig, tp):
    """This rank's shard of a whole float tree
    (``parallel.sharding.shard_params``), with ``tp.plan`` set and, under KV
    replication, the replica groups joined: every rank calls it together.
    The whole tree can be freed afterwards."""
    _check_float(params)
    shard, tp.plan = shard_params(params, config, tp.rank, tp.world)
    if tp.replica_group is None:
        join_replica_groups(tp, tp.plan.kv_replication)
    return shard


def shard_train_state(state: TrainState, config: DotsOCRConfig, tp) -> TrainState:
    """This rank's shard of a whole state (a restored checkpoint): params as
    :func:`shard_for_training`, mu and nu cut the same way."""
    params = shard_for_training(state.params, config, tp)
    mu, _ = shard_params(state.opt_state.mu, config, tp.rank, tp.world)
    nu, _ = shard_params(state.opt_state.nu, config, tp.rank, tp.world)
    return TrainState(params, AdamState(state.opt_state.count, mu, nu), state.step)


def from_numpy_train_state(opt_state_numpy, config: DotsOCRConfig,
                           device: torch.device) -> AdamState:
    """The JAX optimizer state of :func:`make_optimizer`'s chain, converted
    to numpy (``jax.tree.map(np.asarray, opt_state)``), as the port's
    :class:`AdamState` on ``device``: optax's ``ScaleByAdamState`` (count,
    mu, nu) is found in the chain's nested tuples (clipping and decay hold
    no state), mu / nu through :func:`from_numpy_params` (config dtype)."""
    def find(node):
        if hasattr(node, "_fields") and {"count", "mu", "nu"} <= set(node._fields):
            return node
        for child in node if isinstance(node, tuple) else ():
            found = find(child)
            if found is not None:
                return found
        return None

    adam = find(opt_state_numpy)
    if adam is None:
        raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")
    count = torch.tensor(int(np.asarray(adam.count)), dtype=torch.int32, device=device)
    return AdamState(count, from_numpy_params(adam.mu, config, device),
                     from_numpy_params(adam.nu, config, device))


def loss_fn(
    params, config: DotsOCRConfig, batch: TrainBatch, remat: bool = False, tp=None
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked next-token cross entropy (float32 logits); ``remat``
    recomputes the decoder layers in the backward pass.

    Under ``tp`` the params are the rank's shard, the batch its data
    rank's rows: the loss is the rank's part of the global masked mean
    (its rows' sum over ``max(global mask sum, 1)``, detached, the JAX
    step's denominator), so the data group's gradients sum to the global
    one; the metrics are the global values."""
    def data_sum(t: torch.Tensor) -> torch.Tensor:
        if tp is None or tp.data == 1:
            return t
        return train_all_reduce(t.detach().clone(), tp, tp.data_group)

    logits, _ = vlm_prefill(
        params, config if tp is None else tp.plan.config, batch.input_ids, batch.positions,
        batch.seq_lens, patches=batch.patches, rope_cos=batch.rope_cos,
        rope_sin=batch.rope_sin, segment_ids=batch.segment_ids,
        scatter_batch=batch.scatter_batch, scatter_pos=batch.scatter_pos, attn_impl="xla",
        remat=remat, tp=tp,
    )
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    target_logprobs = logprobs.gather(-1, batch.target_ids.long()[..., None])[..., 0]
    mask = batch.loss_mask.to(torch.float32)
    denom = data_sum(mask.sum()).clamp_min(1.0)
    total = -(target_logprobs * mask).sum()
    loss = total / denom
    correct = ((logits.argmax(dim=-1) == batch.target_ids) * mask).sum()
    metrics = {"loss": data_sum(total) / denom, "accuracy": data_sum(correct) / denom,
               "tokens": denom}
    return loss, metrics


def train_step(
    state: TrainState,
    batch: TrainBatch,
    config: DotsOCRConfig,
    optimizer: AdamW,
    remat: bool = False,
    tp=None,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step; the state's tensors are updated in place (the
    JAX step donates them). Metrics are detached device scalars: loss,
    accuracy, tokens and grad_norm (before clipping).

    ``tp``: the rank's group over a (data, model) layout; ``state`` is then
    the rank's shard (:func:`shard_train_state`), ``batch`` its data rank's
    rows (``parallel.sharding.shard_batch``) and ``config`` the whole
    model's. Every rank issues the same collectives in the same order,
    whatever its rows."""
    items = tree_items(state.params)
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    params = tree_from_items(zip((name for name, _ in items), leaves))
    loss, metrics = loss_fn(params, config, batch, remat, tp)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    del loss, params, leaves
    g_norm = None
    if tp is not None:
        grads, g_norm = _reduce_gradients([name for name, _ in items], grads, config, tp)
    opt_state, g_norm = optimizer.update(state.params, grads, state.opt_state, g_norm)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = g_norm
    return TrainState(state.params, opt_state, state.step + 1), metrics


def _reduce_gradients(names: List[str], grads: List[torch.Tensor], config: DotsOCRConfig,
                      tp) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """A rank's gradients of its shard -> the global gradient's shard, and
    the global norm: each leaf summed over the data group, a KV-replicated
    leaf also over its replicas (each replica's query heads give a part),
    in tree order on every rank."""
    roles = leaf_roles(tree_from_items(zip(names, grads)), config, tp.world)
    out = []
    for name, g in zip(names, grads):
        g = g.contiguous()
        if tp.data > 1:
            train_all_reduce(g, tp, tp.data_group)
        if roles[name] == "kv_replica":
            train_all_reduce(g, tp, tp.replica_group)
        out.append(g)
    return out, sharded_global_norm(list(zip(names, out)), roles, tp)


def make_dummy_batch(
    config: DotsOCRConfig,
    batch_size: int = 2,
    seq_len: int = 16,
    vision_tokens: int = 0,
    seed: int = 0,
    device: torch.device = torch.device("cuda"),
) -> TrainBatch:
    """Synthetic batch from a numpy seed (the JAX package's arrays): random
    ids, and with ``vision_tokens`` an image span per row over a square
    grid of random float32 patches."""
    rng = np.random.RandomState(seed)
    vocab = config.decoder.vocab_size
    ids = rng.randint(1, vocab - 8, (batch_size, seq_len)).astype(np.int32)
    vision = {}
    if vision_tokens > 0:
        merge = config.vision.spatial_merge_size**2
        sp = config.special
        n_raw = vision_tokens * merge
        ids[:, 0] = sp.img_id
        ids[:, 1 : 1 + vision_tokens] = sp.imgpad_id
        ids[:, 1 + vision_tokens] = sp.endofimg_id
        total = batch_size * vision_tokens
        patches = rng.randn(total * merge, config.vision.patch_dim).astype(np.float32)
        grid = int(np.sqrt(n_raw))
        if grid * grid != n_raw:
            raise ValueError("vision_tokens must give a square grid")
        pos2d = np.concatenate([vision_grid_positions(grid, grid) for _ in range(batch_size)])
        cos, sin = vision_rope_table(pos2d, config.vision.head_dim, config.vision.rope_theta)
        seg = np.repeat(np.arange(batch_size, dtype=np.int32), n_raw)
        sb, sp_idx = build_scatter_indices(ids, sp.imgpad_id, total)
        vision = dict(patches=patches, rope_cos=cos, rope_sin=sin, segment_ids=seg,
                      scatter_batch=sb, scatter_pos=sp_idx)

    targets = np.roll(ids, -1, axis=1)
    mask = np.ones((batch_size, seq_len), np.float32)
    mask[:, -1] = 0.0
    positions = np.broadcast_to(np.arange(seq_len, dtype=np.int32), ids.shape)
    return batch_to_device(dict(
        input_ids=ids, positions=positions, seq_lens=np.full((batch_size,), seq_len, np.int32),
        target_ids=targets, loss_mask=mask, **vision), device)


def batch_to_device(arrays: Dict[str, np.ndarray], device: torch.device) -> TrainBatch:
    """Numpy batch arrays -> a :class:`TrainBatch` of tensors on ``device``."""
    return TrainBatch(**{k: torch.from_numpy(np.array(v)).to(device)
                         for k, v in arrays.items()})
