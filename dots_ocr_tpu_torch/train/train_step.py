"""Multimodal training step over the full VLM (port of
``dots_ocr_tpu.train.train_step``): masked next-token cross entropy, AdamW
with global-norm clipping, optional per-layer remat.

The model runs the JAX loss's path, ``attn_impl="xla"`` (dense attention,
differentiated by autograd): no attention kernel has a backward, in either
package. The optimizer reproduces optax's ``chain(clip_by_global_norm(c),
adamw(lr, b1, b2, weight_decay=wd))`` in plain torch, one leaf at a time;
JAX has no kernel for it either. Parameters and moments are updated in
place, where the JAX step donates its state and returns new arrays.
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


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(t * t), in float32."""
    return torch.stack([torch.sum(torch.square(t), dtype=torch.float32)
                        for t in tensors]).sum().sqrt()


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

    def update(self, params, grads: List[torch.Tensor],
               state: AdamState) -> Tuple[AdamState, torch.Tensor]:
        """One step: ``params`` and the moments are updated in place, in
        the order of :func:`tree_items`. Returns (the new state, the global
        norm of ``grads`` before clipping). No host sync."""
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


def init_train_state(params, optimizer: AdamW) -> TrainState:
    state = optimizer.init(params)
    return TrainState(params, state, torch.zeros_like(state.count))


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
    params, config: DotsOCRConfig, batch: TrainBatch, remat: bool = False
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Masked next-token cross entropy (float32 logits); ``remat``
    recomputes the decoder layers in the backward pass."""
    logits, _ = vlm_prefill(
        params, config, batch.input_ids, batch.positions, batch.seq_lens,
        patches=batch.patches, rope_cos=batch.rope_cos, rope_sin=batch.rope_sin,
        segment_ids=batch.segment_ids, scatter_batch=batch.scatter_batch,
        scatter_pos=batch.scatter_pos, attn_impl="xla", remat=remat,
    )
    logprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    target_logprobs = logprobs.gather(-1, batch.target_ids.long()[..., None])[..., 0]
    mask = batch.loss_mask.to(torch.float32)
    denom = mask.sum().clamp_min(1.0)
    loss = -(target_logprobs * mask).sum() / denom
    accuracy = ((logits.argmax(dim=-1) == batch.target_ids) * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": accuracy, "tokens": denom}


def train_step(
    state: TrainState,
    batch: TrainBatch,
    config: DotsOCRConfig,
    optimizer: AdamW,
    remat: bool = False,
) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One optimizer step; the state's tensors are updated in place (the
    JAX step donates them). Metrics are detached device scalars: loss,
    accuracy, tokens and grad_norm (before clipping)."""
    items = tree_items(state.params)
    leaves = [p.detach().requires_grad_(True) for _, p in items]
    params = tree_from_items(zip((name for name, _ in items), leaves))
    loss, metrics = loss_fn(params, config, batch, remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    del loss, params, leaves
    opt_state, g_norm = optimizer.update(state.params, grads, state.opt_state)
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = g_norm
    return TrainState(state.params, opt_state, state.step + 1), metrics


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
