"""The rank side of ``test_torch_tp.py``: one process per rank of a
tensor-parallel group over gloo on the CPU, each running the port alone
(no jax import).

``run_rank(rank, world, workdir)`` joins the group through a ``file://``
store in ``workdir``, reads ``inputs.pkl`` (numpy parameter trees and the
scenarios), runs every scenario on its shard and writes what it saw to
``rank{rank}.pkl`` (a traceback in place of the results if it failed).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import pickle
import traceback

import numpy as np
import torch
from PIL import Image

from dots_ocr_tpu_torch.engine import kv_cache as tkv
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models import decoder as tdec
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.models.layers import linear, swiglu
from dots_ocr_tpu_torch.ops.tp import tp_all_reduce
from dots_ocr_tpu_torch.parallel.distributed import destroy, initialize_distributed
from dots_ocr_tpu_torch.parallel.sharding import shard_params
from dots_ocr_tpu_torch.serve.async_engine import EngineWorker, Submission, follow

CPU = torch.device("cpu")


def make_config(name: str) -> DotsOCRConfig:
    """"tiny"; "quad": tiny with 4 vision heads of 8 (every head count
    divides 4 ranks); "windowed": tiny with 4 x 4-patch windows in vision
    layer 0 (layer 1 full)."""
    cfg = DotsOCRConfig.tiny()
    if name == "quad":
        cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, num_heads=4, head_dim=8))
    elif name == "windowed":
        cfg = cfg.replace(vision=dataclasses.replace(cfg.vision, window_size=4,
                                                     full_attn_layers=(1,)))
    return cfg


def image(seed: int) -> Image.Image:
    return Image.fromarray(np.random.RandomState(seed).randint(0, 255, (64, 80, 3), np.uint8))


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _shard(tp, inputs, spec):
    cfg = make_config(spec["config"])
    full = from_numpy_params(inputs["params"][spec["params"]], cfg, CPU)
    params, tp.plan = shard_params(full, cfg, tp.rank, tp.world)
    return cfg, params


def run_layers(tp, inputs, spec):
    """A prefill-extend chunk into empty pools, a decode step and a k = 2
    verify step on the rank's shard; the all-reduced hidden states and
    the rank's pools."""
    cfg, params = _shard(tp, inputs, spec)
    d, shard = cfg.decoder, tp.plan.config.decoder
    x = spec["inputs"]
    world = tp.world if "decoder.attn" in tp.plan.row_parallel else 1
    paged = tkv.PagedKV.create(d, x["num_pages"], x["page"], torch.float32, CPU,
                               quantized=spec["quantized"],
                               kv_replication=tp.plan.kv_replication, world=world)
    scales = dict(k_scales=paged.k_scale, v_scales=paged.v_scale)
    out = {"kv_width": paged.k[0].shape[0]}
    out["extend"] = tdec.decoder_prefill_extend_batched(
        params["decoder"], shard, _t(x["embeds"]), _t(x["positions"]), _t(x["plen"]),
        paged.k, paged.v, _t(x["tables"]), _t(x["slots"]), x["page"], x["kv_hi"], 0,
        tp=tp, **scales).numpy()
    out["decode"] = tdec.decoder_decode_step_paged(
        params["decoder"], shard, _t(x["dec_embeds"]), _t(x["dec_pos"]), paged.k, paged.v,
        _t(x["tables"]), _t(x["dec_lens"]), _t(x["dec_slots"]), x["page"], tp=tp,
        **scales).numpy()
    out["verify"] = tdec.decoder_spec_step_paged(
        params["decoder"], shard, _t(x["ver_embeds"]), _t(x["ver_pos"]), paged.k, paged.v,
        _t(x["tables"]), _t(x["ver_lens"]), _t(x["ver_slots"]), x["page"], tp=tp,
        **scales).numpy()
    out["pools"] = [t.numpy().copy() for t in paged.k + paged.v]
    return out


def _slice(t: torch.Tensor, axis: int, tp) -> torch.Tensor:
    n = t.shape[axis] // tp.world
    return t.narrow(axis, tp.rank * n, n).contiguous()


def _kernel_shard(kernel, axis: int, tp):
    """The rank's rows (``axis`` 0) or columns (1) of a numpy kernel: a
    bf16 array as float32, or ``{"qint8" | "qint8_act", "scale"}`` (the
    per-column scale follows a column split)."""
    if not isinstance(kernel, dict):
        return _slice(torch.from_numpy(kernel).to(torch.bfloat16), axis, tp)
    out = {k: _slice(torch.from_numpy(v), axis, tp) for k, v in kernel.items() if k != "scale"}
    scale = torch.from_numpy(kernel["scale"])
    out["scale"] = scale if axis == 0 else _slice(scale, 0, tp)
    return out


def run_row_parallel(tp, inputs, spec):
    """In bf16, for each kind of kernel (plain, int8, W8A8): a row-parallel
    linear with a bias (x's columns and the kernel's rows split over the
    ranks, as wo's) and an MLP (gate / up columns, down rows) on the rank's
    slices; the reduced outputs as float32."""
    x = spec["inputs"]
    reduce = functools.partial(tp_all_reduce, tp=tp)
    xs = _slice(torch.from_numpy(x["x"]).to(torch.bfloat16), 1, tp)
    h = torch.from_numpy(x["h"]).to(torch.bfloat16)
    bias = torch.from_numpy(x["bias"]).to(torch.bfloat16)
    out = {}
    for kind, ks in x["kernels"].items():
        lin = linear(xs, _kernel_shard(ks["wo"], 0, tp), bias, reduce=reduce)
        mlp = swiglu(h, _kernel_shard(ks["gate"], 1, tp), _kernel_shard(ks["up"], 1, tp),
                     _kernel_shard(ks["down"], 0, tp), reduce=reduce)
        assert lin.dtype == mlp.dtype == torch.bfloat16
        out[kind] = {"linear": lin.float().numpy(), "mlp": mlp.float().numpy()}
    return out


def _requests(spec):
    return [(text, [image(seed)] if seed is not None else [], kw)
            for text, seed, kw in spec["requests"]]


def _engine(tp, inputs, spec):
    cfg, params = _shard(tp, inputs, spec)
    return ContinuousBatchingEngine(params, cfg, CPU, sched=SchedulerConfig(**spec["sched"]),
                                    default_max_new_tokens=8, tp=tp)


def _counters(metrics: dict) -> dict:
    """The engine's counters: its host timings (``t_*``) differ by rank."""
    return {k: v for k, v in metrics.items() if not k.startswith("t_")}


def run_engine(tp, inputs, spec):
    """Each request through ``submit`` / ``run`` on every rank (SPMD):
    tokens, finish reasons and logprobs, the counters, the pool width."""
    eng = _engine(tp, inputs, spec)
    rids = [eng.submit(text, images=imgs, **kw) for text, imgs, kw in _requests(spec)]
    eng.run()
    # whether an image is packed window-major in whole windows (the
    # windowed layers' branch in models/vision.py)
    vis = eng.config.vision
    packs = [eng.prepare(text, imgs).packed for text, imgs, _ in _requests(spec)
             if imgs and vis.window_size]
    windowed = [p.window_ids is not None and len(p.segment_ids) % vis.window_size**2 == 0
                for p in packs]
    out = []
    for rid in rids:
        req = eng.finished_request(rid)
        out.append((list(req.prior_output) + list(req.output_ids), req.finished_reason,
                    [round(x, 4) for x in req.output_logprobs]))
        eng.take_finished(rid)
    return dict(requests=out, metrics=_counters(eng.metrics), kv_rep=eng._kv_rep,
                kv_width=eng.paged.k[0].shape[0], free_pages=eng.allocator.free_pages,
                reduces=tp_all_reduce.launches, windowed=windowed)


def run_worker(tp, inputs, spec):
    """Rank 0 serves through ``EngineWorker`` (its ticks broadcast), the
    others through ``follow``: the rank's counters at the end, and rank 0's
    results."""
    eng = _engine(tp, inputs, spec)
    results = None
    if tp.rank == 0:
        worker = EngineWorker(eng)
        try:
            futures = [worker.submit(Submission(prompt=text, images=imgs, system_prompt=None,
                                                **kw))
                       for text, imgs, kw in _requests(spec)]
            results = [f.result(timeout=300) for f in futures]
        finally:
            worker.shutdown()
    else:
        follow(eng)
    return dict(metrics=_counters(eng.metrics), free_pages=eng.allocator.free_pages,
                has_work=eng.has_work(),
                results=None if results is None else [
                    (r["completion_tokens"], r["finish_reason"], r["text"]) for r in results])


KINDS = {"layers": run_layers, "row_parallel": run_row_parallel, "engine": run_engine,
         "worker": run_worker}


def run_rank(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    results = {}
    try:
        tp = initialize_distributed("gloo", rank, world, f"file://{workdir}/store",
                                    device=CPU, timeout_s=120)
        with open(os.path.join(workdir, "inputs.pkl"), "rb") as f:
            inputs = pickle.load(f)
        for name, spec in inputs["scenarios"].items():
            results[name] = KINDS[spec["kind"]](tp, inputs, spec)
        destroy(tp)
    except BaseException:  # noqa: BLE001 - the test reports it
        results = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


def run_nccl_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of ``test_torch_cuda.py``'s NCCL test (a GPU a rank): a
    small bf16 model with head_dim 128 served greedy twice on the rank's
    shard, with the decode chunks as CUDA graphs and eagerly; writes the
    tokens, the graphed engine's counters and the all-reduces to
    ``nccl{rank}.pkl``."""
    out = {}
    try:
        dev = torch.device("cuda", rank)
        tp = initialize_distributed("nccl", rank, world, f"file://{workdir}/store", device=dev,
                                    timeout_s=300)
        cfg = DotsOCRConfig.tiny().replace(dtype="bfloat16")
        cfg = cfg.replace(decoder=dataclasses.replace(
            cfg.decoder, hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128,
            intermediate_size=512))
        from dots_ocr_tpu_torch.models.init import init_params

        full = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0), scale=0.3)
        params, tp.plan = shard_params(full, cfg, rank, world)
        prompts = ["graphs over nccl", "a second prompt"]
        for name, graphs in (("graphed", True), ("eager", False)):
            sched = SchedulerConfig(num_pages=64, page_size=128, max_slots=4,
                                    max_pages_per_seq=8, steps_per_sync=4, cuda_graphs=graphs)
            eng = ContinuousBatchingEngine(params, cfg, dev, sched=sched, tp=tp)
            before = tp_all_reduce.launches
            rids = [eng.submit(p, max_new_tokens=24, temperature=0.0) for p in prompts]
            eng.run()
            out[name] = [eng.finished_request(r).output_ids for r in rids]
            if graphs:
                out["metrics"] = _counters(eng.metrics)
                out["reduces"] = tp_all_reduce.launches - before
            del eng
        destroy(tp)
    except BaseException:  # noqa: BLE001 - the test reports it
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"nccl{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def card_route_config() -> DotsOCRConfig:
    """bf16, head_dim 128 (kernel 3 takes 64 or 128), 4 query heads over 2
    KV heads: at TP = 2 a rank holds 2 query heads over one KV head."""
    cfg = DotsOCRConfig.tiny().replace(dtype="bfloat16")
    return cfg.replace(decoder=dataclasses.replace(
        cfg.decoder, hidden_size=256, num_heads=4, num_kv_heads=2, head_dim=128,
        intermediate_size=512))


def card_route_logits(params, tp, dev) -> dict:
    """A 40-token prompt into int8 pools at page 64 by one prefill-extend
    chunk up to its last three tokens, a k = 2 verify step over those three
    (nq = 3: the plain reference where kernel 2 does not fit) and a decode
    step of the last one (nq = 1: kernel 3): the four rows' logits as
    float32 numpy, and kernel 3's int8 launches in the decode step."""
    from dots_ocr_tpu_torch.ops.paged_attention import paged_attention_stacked

    cfg = card_route_config()
    d = cfg.decoder if tp is None else tp.plan.config.decoder
    page, t = 64, 40
    n = t - 3
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(1, t, d.hidden_size).astype(np.float32)).to(dev, torch.bfloat16)
    world = 1 if tp is None else tp.world
    paged = tkv.PagedKV.create(cfg.decoder, 4, page, torch.bfloat16, dev, quantized=True,
                               world=world)
    scales = dict(k_scales=paged.k_scale, v_scales=paged.v_scale)
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
    pos = torch.arange(t, device=dev)
    slots = pos + page  # page 1, then page 2

    def lens(v):
        return torch.tensor([v], dtype=torch.int32, device=dev)

    p = params["decoder"]
    with torch.no_grad():
        tdec.decoder_prefill_extend_batched(p, d, x[:, :n], pos[:n], lens(n), paged.k, paged.v,
                                            table, slots[None, :n], page, page, 0, tp=tp,
                                            **scales)
        verify = tdec.decoder_spec_step_paged(p, d, x[:, n:], pos[None, n:], paged.k, paged.v,
                                              table, lens(n + 1), slots[None, n:], page, tp=tp,
                                              **scales)[0]
        before = paged_attention_stacked.int8_launches
        decode = tdec.decoder_decode_step_paged(p, d, x[:, -1], pos[-1:], paged.k, paged.v, table,
                                                lens(t), slots[-1:], page, tp=tp, **scales)
        launches = paged_attention_stacked.int8_launches - before
        logits = tdec.logits_from_hidden(p, d, torch.cat([verify, decode]))
    return {"logits": logits.float().cpu().numpy(), "kernel3": launches,
            "kv_width": paged.k[0].shape[0]}


def run_card_route_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of ``test_torch_cuda.py``'s TP = 2 int8-KV page-64 case:
    gloo on cuda:0, the seeded bf16 model's shard, :func:`card_route_logits`
    and a greedy request served by the engine at page 64; writes
    ``route{rank}.pkl``."""
    out = {}
    try:
        from dots_ocr_tpu_torch.models.init import init_params
        from dots_ocr_tpu_torch.ops.paged_attention import paged_attention_stacked

        dev = torch.device("cuda", 0)
        tp = initialize_distributed("gloo", rank, world, f"file://{workdir}/store", device=dev,
                                    timeout_s=300)
        cfg = card_route_config()
        full = init_params(cfg, dev, torch.Generator(device=dev).manual_seed(0), scale=0.3)
        params, tp.plan = shard_params(full, cfg, rank, world)
        out.update(card_route_logits(params, tp, dev))
        sched = SchedulerConfig(num_pages=64, page_size=64, max_slots=2, max_pages_per_seq=8,
                                steps_per_sync=4, kv_cache_dtype="int8")
        eng = ContinuousBatchingEngine(params, cfg, dev, sched=sched, tp=tp)
        before = paged_attention_stacked.int8_launches
        rid = eng.submit("kernel 3 under tensor parallelism", max_new_tokens=12,
                         temperature=0.0)
        eng.run()
        out["tokens"] = eng.finished_request(rid).output_ids
        out["served_kernel3"] = paged_attention_stacked.int8_launches - before
        destroy(tp)
    except BaseException:  # noqa: BLE001 - the test reports it
        out = {"error": traceback.format_exc()}
    with open(os.path.join(workdir, f"route{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
