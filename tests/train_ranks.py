"""The rank side of ``test_torch_train_tp.py``: training over a (data, model)
layout of gloo ranks on the CPU, each process running the port alone (no
jax import).

``run_worker(slot, workdir)`` reads ``inputs.pkl`` (the JAX init as numpy,
and the layouts in order), and for each layout whose world holds ``slot``
joins that layout's group as rank ``slot`` through a ``file://`` store of its
own, runs the layout's scenarios and leaves the group; a slot outside a
layout skips it. Rank 0's results (whole states gathered through
``gather_train_state``) and every rank's own checks go to
``worker{slot}.pkl`` (a traceback in place of the results if it failed).
"""

from __future__ import annotations

import os
import pickle
import traceback

import numpy as np
import torch

from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.models.layers import linear
from dots_ocr_tpu_torch.ops.tp import copy_to_model, row_reduce, train_all_reduce
from dots_ocr_tpu_torch.parallel.distributed import destroy, initialize_distributed
from dots_ocr_tpu_torch.parallel.sharding import ShardPlan, shard_batch, shard_params
from dots_ocr_tpu_torch.train.checkpoint import (
    gather_train_state,
    restore_checkpoint,
    save_checkpoint,
)
from dots_ocr_tpu_torch.train.train_step import (
    AdamState,
    TrainState,
    global_norm,
    init_train_state,
    make_dummy_batch,
    make_optimizer,
    shard_for_training,
    shard_train_state,
    sharded_global_norm,
    train_step,
    tree_from_items,
    tree_items,
)

CPU = torch.device("cpu")
CFG = DotsOCRConfig.tiny()
SEQ, VISION_TOKENS = 16, 4


def numpy_state(state) -> dict:
    """A whole TrainState as numpy trees (params, mu, nu) and ints."""
    def flat(tree):
        return {name: t.detach().numpy().copy() for name, t in tree_items(tree)}

    return {"params": flat(state.params), "mu": flat(state.opt_state.mu),
            "nu": flat(state.opt_state.nu), "count": int(state.opt_state.count),
            "step": int(state.step)}


def state_from_numpy(d: dict) -> TrainState:
    """Inverse of :func:`numpy_state`."""
    def tree(flat):
        return tree_from_items((k, torch.from_numpy(v.copy())) for k, v in flat.items())

    return TrainState(tree(d["params"]),
                      AdamState(torch.tensor(d["count"], dtype=torch.int32), tree(d["mu"]),
                                tree(d["nu"])),
                      torch.tensor(d["step"], dtype=torch.int32))


def batch(batch_size: int, seed: int):
    return make_dummy_batch(CFG, batch_size=batch_size, seq_len=SEQ,
                            vision_tokens=VISION_TOKENS, seed=seed, device=CPU)


def _metrics(m) -> dict:
    return {k: float(v) for k, v in m.items()}


def steps(tp, inputs, layout, seeds, remat=False, state=None):
    """``train_step`` over ``seeds`` from the JAX init (or ``state``, a
    rank's shard): each step's metrics, the gathered state after the last
    (rank 0), and the shard."""
    opt = make_optimizer(learning_rate=inputs["lr"])
    if state is None:
        params = from_numpy_params(inputs["params"], CFG, CPU)
        state = init_train_state(shard_for_training(params, CFG, tp), opt)
    metrics = []
    for seed in seeds:
        b = shard_batch(batch(layout["batch"], seed), tp.data, tp.data_rank)
        before = train_all_reduce.launches
        state, m = train_step(state, b, CFG, opt, remat=remat, tp=tp)
        metrics.append({**_metrics(m), "all_reduces": train_all_reduce.launches - before})
    whole = gather_train_state(state, CFG, tp)
    return {"metrics": metrics, "state": None if whole is None else numpy_state(whole)}, state


def scenario_mlp(tp, inputs):
    """f and g on a column -> row MLP: this rank's gradients of x and of its
    weight shards (the test holds them to one process's)."""
    x = torch.from_numpy(inputs["mlp"]["x"]).requires_grad_(True)
    w1 = torch.from_numpy(inputs["mlp"]["w1"])
    w2 = torch.from_numpy(inputs["mlp"]["w2"])
    c = torch.from_numpy(inputs["mlp"]["c"])
    n = w1.shape[1] // tp.world
    w1 = w1[:, tp.rank * n:(tp.rank + 1) * n].clone().requires_grad_(True)
    w2 = w2[tp.rank * n:(tp.rank + 1) * n].clone().requires_grad_(True)
    saved, tp.plan = tp.plan, ShardPlan(tp.rank, tp.world, CFG, frozenset({"decoder.mlp"}))
    h = torch.tanh(linear(copy_to_model(x, tp, "decoder.mlp"), w1))
    out = linear(h, w2, reduce=row_reduce(tp, "decoder.mlp"))
    (out * c).sum().backward()
    tp.plan = saved
    return {"out": out.detach().numpy(), "x": x.grad.numpy(), "w1": w1.grad.numpy(),
            "w2": w2.grad.numpy()}


def scenario_norm(tp, inputs):
    """``sharded_global_norm`` of random gradients cut as the parameters
    are, against ``global_norm`` of the whole."""
    from dots_ocr_tpu_torch.parallel.sharding import leaf_roles

    whole = from_numpy_params(inputs["grads"], CFG, CPU)
    shard, _ = shard_params(whole, CFG, tp.rank, tp.world)
    named = tree_items(shard)
    norm = sharded_global_norm(named, leaf_roles(shard, CFG, tp.world), tp)
    return {"sharded": float(norm), "whole": float(global_norm([t for _, t in
                                                               tree_items(whole)]))}


def run_layout(tp, inputs, layout, workdir):
    out = {}
    res, _ = steps(tp, inputs, layout, [0])
    out["step"] = res
    if "three" in layout["scenarios"]:
        out["three"], _ = steps(tp, inputs, layout, [0, 1, 2])
    if "remat" in layout["scenarios"]:
        out["remat"], _ = steps(tp, inputs, layout, [0], remat=True)
    if "checkpoint" in layout["scenarios"]:
        # a TP checkpoint after one step, then the next step from memory
        ckpt = os.path.join(workdir, "ckpt_tp")
        out["saved"], state = steps(tp, inputs, layout, [0])
        save_checkpoint(ckpt, state, CFG, tp=tp)
        out["after_save"], _ = steps(tp, inputs, layout, [1], state=state)
        # the one-process checkpoint of the test, restored on this layout,
        # and the same state from memory: the next step from each
        restored, cfg = restore_checkpoint(os.path.join(workdir, "ckpt_one"), CPU)
        assert cfg == CFG
        out["restored"], _ = steps(tp, inputs, layout, [1],
                                   state=shard_train_state(restored, CFG, tp))
        memory = state_from_numpy(inputs["one_state"])
        out["memory"], _ = steps(tp, inputs, layout, [1],
                                 state=shard_train_state(memory, CFG, tp))
    if "one" in layout["scenarios"] and tp.global_rank == 0:
        # the one-process step in this process (the same CPU threads)
        opt = make_optimizer(learning_rate=inputs["lr"])
        state = init_train_state(from_numpy_params(inputs["params"], CFG, CPU), opt)
        state, m = train_step(state, batch(layout["batch"], 0), CFG, opt)
        out["one"] = {"metrics": [_metrics(m)], "state": numpy_state(state)}
    if "mlp" in layout["scenarios"]:
        out["mlp"] = scenario_mlp(tp, inputs)
    if "norm" in layout["scenarios"]:
        out["norm"] = scenario_norm(tp, inputs)
    out["kv_replication"] = tp.plan.kv_replication
    out["row_parallel"] = sorted(tp.plan.row_parallel)
    return out


def run_worker(slot: int, workdir: str) -> None:
    torch.set_num_threads(1)
    results = {}
    try:
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        for layout in inputs["layouts"]:
            world = layout["data"] * layout["model"]
            if slot >= world:
                continue
            tp = initialize_distributed("gloo", slot, world,
                                        f"file://{workdir}/store_{layout['name']}",
                                        device=CPU, timeout_s=120,
                                        model_parallel=layout["model"])
            results[layout["name"]] = run_layout(tp, inputs, layout, workdir)
            destroy(tp)
    except BaseException:  # noqa: BLE001 - the test reports it
        results = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"worker{slot}.pkl"), "wb") as f:
        pickle.dump(results, f)


def ranks_grads(seed: int = 5) -> dict:
    """Random gradient-shaped arrays (numpy, the JAX tree's layout) for the
    norm scenario."""
    from dots_ocr_tpu_torch.models.init import init_params

    rng = np.random.RandomState(seed)
    params = init_params(CFG, CPU, torch.Generator().manual_seed(seed))
    return _numpy_tree(params, rng)


def _numpy_tree(tree, rng):
    return {k: _numpy_tree(v, rng) if isinstance(v, dict)
            else rng.randn(*v.shape).astype(np.float32) for k, v in tree.items()}


def run_card_train_rank(rank: int, world: int, workdir: str, backend: str) -> None:
    """One rank of ``test_torch_cuda.py``'s training cases: the tiny float32
    config (2 + 2 layers) at TP = ``world`` on the card (``gloo``: every rank
    on cuda:0; ``nccl``: a GPU a rank), one step from a seeded init on 2
    rows with vision; rank 0 writes the gathered state and the metrics to
    ``card{rank}.pkl`` (every rank its metrics, or the traceback)."""
    out = {}
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        tp = initialize_distributed(backend, rank, world, f"file://{workdir}/store", device=dev,
                                    timeout_s=300, model_parallel=world)
        from dots_ocr_tpu_torch.models.init import init_params

        opt = make_optimizer(learning_rate=1e-3)
        params = init_params(CFG, CPU, torch.Generator().manual_seed(0))
        params = {k: _to(v, dev) for k, v in params.items()}
        state = init_train_state(shard_for_training(params, CFG, tp), opt)
        b = make_dummy_batch(CFG, batch_size=2, seq_len=SEQ, vision_tokens=VISION_TOKENS,
                             seed=0, device=dev)
        state, m = train_step(state, shard_batch(b, tp.data, tp.data_rank), CFG, opt, tp=tp)
        out["metrics"] = _metrics(m)
        whole = gather_train_state(state, CFG, tp)
        if whole is not None:
            out["state"] = numpy_state(whole)
        destroy(tp)
    except BaseException:  # noqa: BLE001 - the test reports it
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"card{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}
