"""Tensor-parallel serving of the port against the JAX package on the CPU.

The port runs one process per rank over gloo (``tests/tp_ranks.py``, a
``file://`` store under ``tmp_path``); the JAX side runs its engine on a
``make_mesh(data=1, model=N)`` mesh of conftest's virtual CPU devices, on
the same weights (``init_params`` -> numpy -> ``from_numpy_params`` ->
``shard_params`` on every rank). One spawn per world size (2 and 4) runs
every scenario; the tests assert on its results.

- Sharding: the port's specs against JAX ``param_partition_specs`` (the
  listed departures only), shards that concatenate back to the tree
  (plain, int8 and W8A8 leaves), ``kernel_tp_degree``, the zero pad of an
  int8 intermediate shard at 8,960 / 4 = 2,240.
- Layers: the all-reduced prefill-extend, decode and verify outputs at TP
  = 2 (and 4) against JAX's single-device functions within 1e-5, and each
  rank's pool against its heads of the JAX pool; in bf16, a row-parallel
  linear and MLP (plain, int8 and W8A8 weights) against the JAX functions
  on one device and on the mesh, to the bf16 ulp.
- Engine: greedy tokens equal to the JAX mesh engine's in the scenarios of
  ``tests/test_serving_tp.py`` (decode, vision with 16-token chunks, int8
  KV, ``speculate_k=3``, KV replication, the seeded sampling surface), and
  a windowed vision tower (kernel 1 a window under TP).
- Lockstep: a dry pool that preempts, served through rank 0's
  ``EngineWorker`` and the followers' ``follow``; equal counters on every
  rank.
- The server: ``--tensor-parallel-size 2 --tp-backend gloo`` on the CPU
  answers as TP = 1 over HTTP, survives a cancelled stream, fails (and
  does not hang) when a follower is killed; int4, ``--engine batch`` and
  nccl without GPUs are refused.
"""

import functools
import json
import multiprocessing
import os
import pickle
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.engine import kv_cache as jkv
from dots_ocr_tpu.engine.scheduler import ContinuousBatchingEngine as JaxEngine
from dots_ocr_tpu.engine.scheduler import SchedulerConfig as JaxSched
from dots_ocr_tpu.models import decoder as jdec
from dots_ocr_tpu.models import layers as jlayers
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.models.quantize import quantize_kernel as jax_quantize_kernel
from dots_ocr_tpu.models.quantize import quantize_kernel_act as jax_quantize_kernel_act
from dots_ocr_tpu.ops.tp import kernel_tp_degree as jax_kernel_tp_degree
from dots_ocr_tpu.parallel.sharding import make_mesh
from dots_ocr_tpu.parallel.sharding import param_partition_specs as jax_specs
from dots_ocr_tpu.parallel.sharding import shard_params as jax_shard
from dots_ocr_tpu_torch.engine.kv_cache import PageAllocator
from dots_ocr_tpu_torch.models import quantize as tq
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params, init_params
from dots_ocr_tpu_torch.models.layers import swiglu
from dots_ocr_tpu_torch.ops.tp import kernel_tp_degree
from dots_ocr_tpu_torch.parallel import sharding
from dots_ocr_tpu_torch.serve import server as torch_server

import tp_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SCHED = dict(num_pages=64, page_size=8, max_slots=4, max_pages_per_seq=32,
             prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=2)
GREEDY = dict(temperature=0.0)
PAGE, NUM_PAGES, MAX_PAGES = 8, 24, 6
LAYER_ATOL = 1e-5


def _jax_config(name):
    """The JAX twin of ``tp_ranks.make_config``."""
    import dataclasses

    cfg = JaxConfig.tiny()
    if name == "quad":
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, num_heads=4, head_dim=8))
    elif name == "windowed":
        cfg = dataclasses.replace(
            cfg, vision=dataclasses.replace(cfg.vision, window_size=4, full_attn_layers=(1,)))
    return cfg


def _engine_spec(params, config, sched, requests):
    return dict(kind="engine", params=params, config=config, sched={**SCHED, **sched},
                requests=requests)


def _layer_inputs():
    """A 16-token chunk of two prompts (16 and 11 tokens) into empty
    pools, then a decode step at each prompt's end and a k = 2 verify."""
    rng = np.random.RandomState(11)
    d = DotsOCRConfig.tiny().decoder
    plen = np.array([16, 11])
    alloc = PageAllocator(NUM_PAGES, PAGE, MAX_PAGES)
    slots = np.zeros((2, 16), np.int64)
    for row in range(2):
        alloc.allocate(row, int(plen[row]) + 6)
        slots[row, :plen[row]] = alloc.slot_mapping(row, 0, int(plen[row]))
    tables = np.stack([alloc.padded_table(r) for r in range(2)]).astype(np.int32)
    base = plen + 1
    return dict(
        page=PAGE, num_pages=NUM_PAGES, kv_hi=16, plen=plen, tables=tables,
        embeds=rng.randn(2, 16, d.hidden_size).astype(np.float32),
        positions=np.arange(16), slots=slots,
        dec_embeds=rng.randn(2, d.hidden_size).astype(np.float32), dec_pos=plen,
        dec_lens=(plen + 1).astype(np.int32),
        dec_slots=np.array([alloc.slot_mapping(r, int(plen[r]), 1)[0] for r in range(2)]),
        ver_embeds=rng.randn(2, 3, d.hidden_size).astype(np.float32),
        ver_pos=base[:, None] + np.arange(3), ver_lens=(base + 1).astype(np.int32),
        ver_slots=np.stack([alloc.slot_mapping(r, int(base[r]), 3) for r in range(2)]),
    )


@functools.lru_cache(maxsize=None)
def _row_parallel_inputs():
    """bf16 values (as float32) for a row-parallel linear x [48, 256] .
    wo [256, 128] + bias and an MLP h [48, 128] -> gate / up [128, 256] ->
    down [256, 128]; each weight plain, int8 and W8A8 (the JAX package's
    quantizers)."""
    rng = np.random.RandomState(15)

    def bf16(*shape, scale=1.0):
        return np.asarray(jnp.asarray(rng.randn(*shape) * scale, jnp.bfloat16), np.float32)

    weights = dict(wo=bf16(256, 128, scale=0.1), gate=bf16(128, 256, scale=0.1),
                   up=bf16(128, 256, scale=0.1), down=bf16(256, 128, scale=0.1))
    quant = {"int8": jax_quantize_kernel, "w8a8": jax_quantize_kernel_act}
    kernels = {"plain": weights}
    for kind, fn in quant.items():
        kernels[kind] = {name: {k: np.asarray(v) for k, v in fn(jnp.asarray(w)).items()}
                         for name, w in weights.items()}
    return dict(x=bf16(48, 256), h=bf16(48, 128), bias=bf16(128), kernels=kernels)


def _requests_vision():
    return [("describe", 0, dict(max_new_tokens=6, **GREEDY))]


def _sampling_requests():
    return [("seeded sampled", None, dict(temperature=0.9, top_p=0.9, seed=77,
                                          max_new_tokens=8)),
            ("penalized row", None, dict(frequency_penalty=1.5, max_new_tokens=8, **GREEDY)),
            ("biased row", None, dict(logit_bias={10: -100.0}, max_new_tokens=8, **GREEDY)),
            ("logprob row", None, dict(logprobs=True, max_new_tokens=8, **GREEDY))]


# The worker scenario: five text prompts of up to 40 new tokens on a pool
# of 22 pages of 8 (four of them need ~38 pages): the youngest are
# preempted and recomputed.
DRY = [(text, None, dict(max_new_tokens=40, temperature=0.0, top_p=1.0))
       for text in ("hello world", "a second, longer text prompt",
                    "a third prompt, the longest of the three by far", "four",
                    "fifth request here")]

SCENARIOS = {
    2: {
        "layers": dict(kind="layers", params="tiny", config="tiny", quantized=False),
        "decode": _engine_spec("tiny", "tiny", {}, [
            ("hello tensor parallel", None, dict(max_new_tokens=8, **GREEDY)),
            ("a second request", None, dict(max_new_tokens=8, **GREEDY))]),
        "row_parallel": dict(kind="row_parallel"),
        "vision_chunked": _engine_spec("tiny", "tiny", dict(prefill_chunk_tokens=16),
                                       _requests_vision()),
        "vision_windowed": _engine_spec("tiny", "windowed", dict(prefill_chunk_tokens=16),
                                        _requests_vision()),
        "int8_kv": _engine_spec("tiny", "tiny", dict(kv_cache_dtype="int8"),
                                [("int8 tp", None, dict(max_new_tokens=6, **GREEDY))]),
        "spec": _engine_spec("tiny", "tiny", dict(speculate_k=3), [
            ("spec tp alpha", None, dict(max_new_tokens=12, **GREEDY)),
            ("spec tp beta", None, dict(max_new_tokens=12, **GREEDY))]),
        "sampling": _engine_spec("tiny", "tiny", {}, _sampling_requests()),
        "dry_pool": dict(kind="worker", params="tiny", config="tiny",
                         sched={**SCHED, "num_pages": 22}, requests=DRY),
    },
    4: {
        "layers": dict(kind="layers", params="tiny", config="tiny", quantized=False),
        "kv_replication": _engine_spec("tiny", "tiny", {}, [
            ("four way", None, dict(max_new_tokens=6, **GREEDY))]),
        "quad_vision_spec": _engine_spec("quad", "quad", dict(
            speculate_k=3, prefill_chunk_tokens=16),
            [("replicated kv kernels", 3, dict(max_new_tokens=10, **GREEDY))]),
    },
}


@pytest.fixture(scope="module")
def jax_params():
    return {name: jax_init(jax.random.PRNGKey(0 if name == "tiny" else 2),
                           _jax_config(name), scale=0.3)
            for name in ("tiny", "quad")}


def _spawn(world, workdir, jax_params):
    inputs = {"params": {k: jax.tree.map(np.asarray, v) for k, v in jax_params.items()},
              "scenarios": SCENARIOS[world]}
    for spec in inputs["scenarios"].values():
        if spec["kind"] == "layers":
            spec["inputs"] = _layer_inputs()
        elif spec["kind"] == "row_parallel":
            spec["inputs"] = _row_parallel_inputs()
    with open(os.path.join(workdir, "inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=tp_ranks.run_rank, args=(rank, world, str(workdir)))
             for rank in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    out = []
    for rank in range(world):
        path = os.path.join(workdir, f"rank{rank}.pkl")
        assert os.path.exists(path), f"rank {rank} wrote nothing (exit {procs[rank].exitcode})"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"rank {rank}:\n{res['error']}"
        out.append(res)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params):
    """({world: [rank 0's results, rank 1's, ...]}, {(world, name): the JAX
    mesh engine's run}): both worlds spawn at once (separate stores) and
    the JAX engines run meanwhile."""
    results = {}
    errors = []
    # made here: tmp_path_factory is not thread-safe
    workdirs = {world: tmp_path_factory.mktemp(f"tp{world}") for world in SCENARIOS}

    def run(world):
        try:
            results[world] = _spawn(world, workdirs[world], jax_params)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(w,)) for w in SCENARIOS]
    for t in threads:
        t.start()
    with ThreadPoolExecutor(4) as pool:  # independent engines, compiled concurrently
        futures = {(w, name): pool.submit(_jax_engine_run, jax_params, w, spec)
                   for w, sc in SCENARIOS.items() for name, spec in sc.items()
                   if spec["kind"] == "engine"}
        futures["layers"] = pool.submit(_jax_layers, jax_params, False)
        futures["row_parallel"] = pool.submit(_jax_row_parallel)
        jax_side = {key: f.result() for key, f in futures.items()}
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results, jax_side


def _jax_engine_run(jax_params, world, spec):
    cfg = _jax_config(spec["config"])
    mesh = make_mesh(data=1, model=world)
    eng = JaxEngine(jax_shard(jax_params[spec["params"]], cfg, mesh), cfg,
                    sched=JaxSched(**spec["sched"]), default_max_new_tokens=8, mesh=mesh)
    out = []
    rids = [eng.submit(text, images=imgs, **kw)
            for text, imgs, kw in tp_ranks._requests(spec)]
    eng.run()
    for rid in rids:
        req = eng.finished_request(rid)
        out.append((list(req.prior_output) + list(req.output_ids), req.finished_reason,
                    list(req.output_logprobs)))
    return out, eng


# -- sharding -------------------------------------------------------------


def _model_axis(spec):
    """The position of "model" in a JAX PartitionSpec, or None."""
    for i, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple) and "model" in entry):
            return i
    return None


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def _departures(cfg, world):
    """The leaves the port keeps whole where JAX splits them: the listed
    replicated leaves, and a tower's attention whose heads do not divide."""
    out = set(sharding.REPLICATED)
    parts = sharding.param_partition_specs(cfg, world)
    for tower in ("decoder", "vision"):
        attn = parts[tower]["blocks"]["attn"]
        if attn["wq"] is None:
            out |= {(tower, "blocks", "attn", k) for k in attn}
    return out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", ["tiny", "quad", "flagship"])
def test_partition_specs_split_where_jax_splits(name, world):
    tcfg = (DotsOCRConfig.flagship() if name == "flagship"
            else tp_ranks.make_config(name))
    jcfg = JaxConfig.flagship() if name == "flagship" else _jax_config(name)
    ours = dict(_leaves(sharding.param_partition_specs(tcfg, world)))
    theirs = {path: _model_axis(spec) for path, spec in _leaves(
        jax_specs(jcfg, make_mesh(data=1, model=world)))}
    assert set(ours) == set(theirs)
    departures = _departures(tcfg, world)
    for path, axis in ours.items():
        if path in departures:
            assert axis is None, path
        else:
            assert axis == theirs[path], (path, axis, theirs[path])
    # the listed replicated leaves are the ones JAX does split
    assert all(theirs[p] is not None for p in sharding.REPLICATED if p in theirs)
    if name == "flagship":
        # every head count divides 2 and 4: only the listed leaves depart
        assert departures == set(sharding.REPLICATED)


def _unshard(pieces, full, path, axis, plan0, world):
    """Rebuild a full leaf from the ranks' pieces: one piece a KV head
    under replication, padding stripped."""
    if axis is None:
        for p in pieces:
            assert p is full or torch.equal(p, full), path
        return full
    rep = plan0.kv_replication
    if rep > 1 and path[0] == "decoder" and {"wk", "wv", "bk", "bv"} & set(path):
        pieces = pieces[::rep]
    pad = plan0.decoder_pad if path[0] == "decoder" else plan0.vision_pad
    if "mlp" in path and pad:
        pieces = [p.narrow(axis, 0, p.shape[axis] - pad) for p in pieces]
    return torch.cat(pieces, dim=axis)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "int8", "w8a8"])
def test_shards_concatenate_back(kind, world):
    cfg = DotsOCRConfig.tiny()
    params = init_params(cfg, CPU, torch.Generator().manual_seed(3))
    if kind == "int8":
        params = tq.quantize_decoder_params(params)
    elif kind == "w8a8":
        params = tq.quantize_vision_params(params)
    shards = [sharding.shard_params(params, cfg, r, world) for r in range(world)]
    plan0 = shards[0][1]
    if kind == "int8":
        assert plan0.decoder_pad == 128 - 128 // world  # a shard of 64 or 32 pads to 128
    specs = dict(_leaves(sharding._expand_quant_specs(
        params, sharding.param_partition_specs(cfg, world))))
    full = dict(_leaves(params))
    for path, leaf in full.items():
        pieces = [dict(_leaves(tree))[path] for tree, _ in shards]
        rebuilt = _unshard(pieces, leaf, path, specs[path], plan0, world)
        assert torch.equal(rebuilt, leaf), path
    # the shard config describes the shard
    d = plan0.config.decoder
    q = dict(_leaves(shards[0][0]))
    w = q[("decoder", "blocks", "attn", "wq", "qint8")] if kind == "int8" else \
        q[("decoder", "blocks", "attn", "wq")]
    assert w.shape[-1] == d.num_heads * d.head_dim
    assert d.num_kv_heads == (1 if world == 4 else cfg.decoder.num_kv_heads // world)
    assert plan0.kv_replication == (2 if world == 4 else 1)


def test_kernel_tp_degree_matches_jax():
    for world in (1, 2, 4, 8):
        mesh = make_mesh(data=1, model=world)
        for heads in [(12, 2, 12), (4, 2, 2), (4, 4, 4), (16, 8, 16), (6, 3), (8,), (3, 1)]:
            assert kernel_tp_degree(world, *heads) == jax_kernel_tp_degree(
                mesh, "model", *heads), (world, heads)
    assert kernel_tp_degree(None, 3) == jax_kernel_tp_degree(None, "model", 3) == 1


def test_int8_intermediate_pad_is_exact():
    """8,960 / 4 = 2,240 int8 columns pad to 2,304 (the W8A16 kernel's
    128-column tiles): each rank's MLP output equals its unpadded slice's
    (the pad adds exact zeros; only the product's summation order may
    change with the longer contraction), and the ranks' outputs sum to the
    full MLP's."""
    import dataclasses

    cfg = DotsOCRConfig.tiny()
    cfg = cfg.replace(decoder=dataclasses.replace(cfg.decoder, intermediate_size=8960))
    params = tq.quantize_decoder_params(init_params(cfg, CPU, torch.Generator().manual_seed(4)))
    x = torch.from_numpy(np.random.RandomState(4).randn(5, 64).astype(np.float32))
    full_mlp = {k: {kk: vv[0] for kk, vv in v.items()}
                for k, v in params["decoder"]["blocks"]["mlp"].items()}
    full = swiglu(x, full_mlp["gate"], full_mlp["up"], full_mlp["down"])
    total = torch.zeros_like(full)
    for rank in range(4):
        tree, plan = sharding.shard_params(params, cfg, rank, 4)
        mlp = {k: {kk: vv[0] for kk, vv in v.items()}
               for k, v in tree["decoder"]["blocks"]["mlp"].items()}
        assert plan.decoder_pad == 64 and plan.config.decoder.intermediate_size == 2304
        assert mlp["gate"]["qint8"].shape == (64, 2304) and mlp["down"]["qint8"].shape == (2304, 64)
        padded = swiglu(x, mlp["gate"], mlp["up"], mlp["down"])
        cols = slice(rank * 2240, (rank + 1) * 2240)
        bare = swiglu(
            x, {"qint8": full_mlp["gate"]["qint8"][:, cols], "scale": full_mlp["gate"]["scale"][cols]},
            {"qint8": full_mlp["up"]["qint8"][:, cols], "scale": full_mlp["up"]["scale"][cols]},
            {"qint8": full_mlp["down"]["qint8"][cols], "scale": full_mlp["down"]["scale"]})
        np.testing.assert_allclose(padded.numpy(), bare.numpy(), rtol=0, atol=1e-7)
        total += padded
    np.testing.assert_allclose(total.numpy(), full.numpy(), rtol=0, atol=1e-5)


# -- layers and engines against JAX ---------------------------------------


def _jax_layers(jax_params, quantized):
    jc = JaxConfig.tiny()
    x = _layer_inputs()
    jp = jax_params["tiny"]["decoder"]
    paged = jkv.PagedKV.create(jc.decoder, NUM_PAGES, PAGE, dtype=jnp.float32,
                               quantized=quantized)
    k, v, ks, vs = paged.k, paged.v, paged.k_scale, paged.v_scale
    out = {}
    h, k, v, ks, vs = jdec.decoder_prefill_extend_batched(
        jp, jc.decoder, jnp.asarray(x["embeds"]), jnp.asarray(x["positions"]),
        jnp.asarray(x["plen"]), k, v, jnp.asarray(x["tables"][:, :2]),
        jnp.asarray(x["slots"], jnp.int32), PAGE, 16, 0, attn_impl="xla",
        k_scales=ks, v_scales=vs)
    out["extend"] = np.asarray(h)
    h, k, v, ks, vs = jdec.decoder_decode_step_paged(
        jp, jc.decoder, jnp.asarray(x["dec_embeds"]), jnp.asarray(x["dec_pos"]), k, v,
        jnp.asarray(x["tables"]), jnp.asarray(x["dec_lens"]),
        jnp.asarray(x["dec_slots"], jnp.int32), PAGE, attn_impl="reference",
        k_scales=ks, v_scales=vs)
    out["decode"] = np.asarray(h)
    h, k, v, ks, vs = jdec.decoder_spec_step_paged(
        jp, jc.decoder, jnp.asarray(x["ver_embeds"]), jnp.asarray(x["ver_pos"]), k, v,
        jnp.asarray(x["tables"]), jnp.asarray(x["ver_lens"]),
        jnp.asarray(x["ver_slots"], jnp.int32), PAGE, attn_impl="reference",
        k_scales=ks, v_scales=vs)
    out["verify"] = np.asarray(h)
    out["pools"] = [np.asarray(t) for t in list(k) + list(v)]
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_layers_match_jax_single_device(ranks, world):
    ranks, jax_side = ranks
    ref = jax_side["layers"]
    plen = _layer_inputs()["plen"]
    rep = 2 if world == 4 else 1
    for rank, res in enumerate(ranks[world]):
        got = res["layers"]
        assert got["kv_width"] == 1
        for row in range(2):
            np.testing.assert_allclose(got["extend"][row, :plen[row]],
                                       ref["extend"][row, :plen[row]],
                                       rtol=0, atol=LAYER_ATOL)
        np.testing.assert_allclose(got["decode"], ref["decode"], rtol=0, atol=LAYER_ATOL)
        np.testing.assert_allclose(got["verify"], ref["verify"], rtol=0, atol=LAYER_ATOL)
        head = rank // rep
        # past the null page, where both sides send padding rows' writes;
        # K / V reach ~6.5 here, so 1e-5 of their magnitude too
        for ours, theirs in zip(got["pools"], ref["pools"]):
            np.testing.assert_allclose(ours[0, PAGE:], theirs[head, PAGE:], rtol=LAYER_ATOL,
                                       atol=LAYER_ATOL)


def _jax_row_parallel():
    """``_row_parallel_inputs`` through the JAX linear and swiglu on one
    device, op by op ("single"), and jitted on a model=2 mesh ("mesh"): x's
    columns and wo's / down's rows split, gate / up's columns split; GSPMD
    sums the float32 (W8A8: int32) partial products and takes W8A8's row
    amax over both halves."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(data=1, model=2)
    x = _row_parallel_inputs()

    def put(a, *spec):
        return jax.device_put(a, NamedSharding(mesh, P(*spec)))

    def kernel(k, axis):
        spec = ("model", None) if axis == 0 else (None, "model")
        if not isinstance(k, dict):
            return put(jnp.asarray(k, jnp.bfloat16), *spec)
        out = {name: put(v, *spec) for name, v in k.items() if name != "scale"}
        out["scale"] = put(k["scale"], None if axis == 0 else "model")
        return out

    xs = put(jnp.asarray(x["x"], jnp.bfloat16), None, "model")
    h = put(jnp.asarray(x["h"], jnp.bfloat16), None, None)
    bias = jnp.asarray(x["bias"], jnp.bfloat16)
    def whole(k):
        if not isinstance(k, dict):
            return jnp.asarray(k, jnp.bfloat16)
        return {name: jnp.asarray(v) for name, v in k.items()}

    out = {}
    for kind, ks in x["kernels"].items():
        lin = jax.jit(jlayers.linear)(xs, kernel(ks["wo"], 0), bias)
        mlp = jax.jit(jlayers.swiglu)(h, kernel(ks["gate"], 1), kernel(ks["up"], 1),
                                      kernel(ks["down"], 0))
        lin1 = jlayers.linear(jnp.asarray(x["x"], jnp.bfloat16), whole(ks["wo"]), bias)
        mlp1 = jlayers.swiglu(jnp.asarray(x["h"], jnp.bfloat16), whole(ks["gate"]),
                              whole(ks["up"]), whole(ks["down"]))
        out[kind] = {"linear": {"mesh": np.asarray(lin, np.float32),
                                "single": np.asarray(lin1, np.float32)},
                     "mlp": {"mesh": np.asarray(mlp, np.float32),
                             "single": np.asarray(mlp1, np.float32)}}
    return out


@pytest.mark.parametrize("kind", ["plain", "int8", "w8a8"])
@pytest.mark.parametrize("layer", ["linear", "mlp"])
def test_bf16_row_parallel_matches_jax_mesh(ranks, kind, layer):
    """In bf16 a row-parallel linear's partial products are summed in
    float32 (W8A8: int32, over a row amax taken across the ranks) before
    the bias and the cast, as GSPMD's psum in the JAX package: every rank's
    output is the JAX function's on one device and on the mesh, but for an
    element whose float32 sum lands on the other side of a bf16 rounding
    boundary (1 ulp, rare). Summing bf16 partials would move many
    elements, some by more than an ulp. (W8A8 is held to one device only:
    the mesh's jit rewrites its ``amax / 127`` as ``amax * (1 / 127)``,
    which the port and the JAX function op by op do not.)"""
    ranks, jax_side = ranks
    refs = jax_side["row_parallel"][kind][layer]
    for res in ranks[2]:
        got = res["row_parallel"][kind][layer]
        for name in ("single",) if kind == "w8a8" else ("single", "mesh"):
            err = np.abs(got - refs[name])
            assert np.all(err <= 2.0**-7 * np.abs(refs[name])), (name, float(err.max()))
            assert np.mean(err > 0) <= 0.01, (name, np.mean(err > 0))


ENGINE_CASES = [(w, name) for w, sc in SCENARIOS.items() for name, spec in sc.items()
                if spec["kind"] == "engine"]


@pytest.mark.parametrize("world,name", ENGINE_CASES)
def test_engine_tokens_match_jax_mesh_engine(ranks, world, name):
    ranks, jax_side = ranks
    spec = SCENARIOS[world][name]
    theirs, jeng = jax_side[(world, name)]
    for res in ranks[world]:
        got = res[name]
        assert [(t, r) for t, r, _ in got["requests"]] == [(t, r) for t, r, _ in theirs]
        for (_, _, ours_lp), (_, _, ref_lp) in zip(got["requests"], theirs):
            np.testing.assert_allclose(ours_lp, ref_lp, rtol=0, atol=1e-4)
        assert got["kv_rep"] == jeng._kv_rep
        # a rank's pool holds its KV heads: the JAX pool's width / world
        assert got["kv_width"] == jeng.paged.k[0].shape[0] // world
        assert got["free_pages"] == spec["sched"]["num_pages"] - 1
    counters = [res[name]["metrics"] for res in ranks[world]]
    assert all(c == counters[0] for c in counters)
    for key in ("prefill_chunks", "spec_chunks"):
        assert counters[0].get(key, 0) == jeng.metrics.get(key, 0), key
    if name == "kv_replication":
        assert jeng._kv_rep == 2 and got["kv_width"] == 1
    if name in ("spec", "quad_vision_spec"):
        assert counters[0]["spec_chunks"] >= 1
    if name in ("vision_chunked", "vision_windowed", "quad_vision_spec"):
        assert counters[0]["prefill_chunks"] >= 2
    if name == "vision_windowed":
        assert all(r[name]["windowed"] == [True] for r in ranks[world])


def test_lockstep_dry_pool_counters_equal_on_every_rank(ranks):
    res = ranks[0][2]
    results = res[0]["dry_pool"]["results"]
    assert len(results) == len(DRY)
    assert all(n == 40 or reason == "stop" for n, reason, _ in results)
    counters = [r["dry_pool"]["metrics"] for r in res]
    assert counters[0]["preemptions"] >= 1
    assert all(c == counters[0] for c in counters)
    for r in res:
        assert not r["dry_pool"]["has_work"] and r["dry_pool"]["free_pages"] == 22 - 1


# -- the server ------------------------------------------------------------


@pytest.mark.parametrize("flags,reason", [
    (["--quantize", "int4", "--tp-backend", "gloo"], "--quantize int4 is single-chip only"),
    (["--engine", "batch", "--tp-backend", "gloo"], "needs --engine continuous"),
    (["--tp-backend", "nccl"], "needs 2 CUDA devices"),
])
def test_server_refuses_what_tp_does_not_serve(flags, reason):
    argv = ["--random-tiny", "--platform", "cpu", "--tensor-parallel-size", "2"] + flags
    with pytest.raises(SystemExit, match=re.escape(reason)):
        torch_server.main(argv)
    if "nccl" not in flags:
        return
    # the command line exits non-zero with the reason
    proc = subprocess.run([sys.executable, "-m", "dots_ocr_tpu_torch.serve.server", *argv],
                          env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode != 0 and reason in proc.stderr


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


SERVE = ["--random-tiny", "--platform", "cpu", "--num-pages", "64", "--page-size", "8",
         "--max-slots", "4", "--max-seq-tokens", "512", "--steps-per-sync", "4",
         "--prefill-chunk-tokens", "16"]


def _start(tmp_path, name, extra):
    port = _port()
    log = open(tmp_path / f"{name}.log", "w+")
    proc = subprocess.Popen([sys.executable, "-m", "dots_ocr_tpu_torch.serve.server", *SERVE,
                             "--port", str(port), *extra], stdout=log, stderr=subprocess.STDOUT,
                            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO,
                            start_new_session=True)
    return proc, port, log


def _wait(proc, port, log, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        assert proc.poll() is None, open(log.name).read()
        try:
            urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=2)
            return
        except OSError:
            time.sleep(0.3)
    raise AssertionError(open(log.name).read())


def _chat(port, text, timeout=60, **kw):
    body = json.dumps({"model": "model", "messages": [{"role": "user", "content": text}],
                       **kw}).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def test_server_tp2_over_gloo_answers_cancels_and_fails_on_a_dead_rank(tmp_path):
    tp2 = _start(tmp_path, "tp2", ["--tensor-parallel-size", "2", "--tp-backend", "gloo"])
    tp1 = _start(tmp_path, "tp1", [])
    try:
        for proc, port, log in (tp1, tp2):
            _wait(proc, port, log)
        port1, port2 = tp1[1], tp2[1]
        # the same text as TP = 1
        a = _chat(port1, "hello tensor parallel", max_tokens=12, temperature=0.0)
        b = _chat(port2, "hello tensor parallel", max_tokens=12, temperature=0.0)
        assert a[0] == b[0] == 200
        assert b[1]["choices"][0]["message"]["content"] == \
            a[1]["choices"][0]["message"]["content"]
        # a stream cancelled mid-decode: the server serves on
        body = json.dumps({"model": "model", "stream": True, "temperature": 1.0, "seed": 3,
                           "max_tokens": 400,
                           "messages": [{"role": "user", "content": "stream me"}]}).encode()
        with socket.create_connection(("127.0.0.1", port2)) as sock:
            sock.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                         b"Content-Type: application/json\r\nContent-Length: "
                         + str(len(body)).encode() + b"\r\n\r\n" + body)
            assert b"data:" in sock.recv(4096) + sock.recv(4096)
        c = _chat(port2, "after the cancel", max_tokens=6, temperature=0.0)
        assert c[0] == 200 and c[1]["choices"][0]["finish_reason"] in ("length", "stop")
        # kill the follower: the request in flight fails, and so does the next one, fast
        pid = int(re.search(r"TP rank 1: pid (\d+)", open(tp2[2].name).read()).group(1))
        results = []
        t = threading.Thread(target=lambda: results.append(_chat(
            port2, "in flight", max_tokens=2000, temperature=1.0, seed=5, timeout=90)))
        t.start()
        time.sleep(0.5)
        os.kill(pid, signal.SIGKILL)
        t.join(timeout=90)
        assert not t.is_alive() and results[0][0] != 200
        t0 = time.time()
        after = _chat(port2, "after the loss", max_tokens=4, temperature=0.0)
        assert after[0] != 200 and "tensor-parallel group lost" in json.dumps(after[1])
        assert time.time() - t0 < 10
    finally:
        for proc, _, log in (tp1, tp2):
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait(timeout=30)
            log.close()

