"""Training over a (data, model) layout of ranks on the CPU: the port's
``train_step`` under ``tp`` against the JAX ``train_step`` on
``make_mesh(data, model)`` and against the port's one-process step.

The port runs one gloo process a rank (``tests/train_ranks.py``): four
workers spawned once, each joining every layout whose world holds it (a
``file://`` store a layout). The JAX side runs meanwhile in a subprocess on
conftest's 8 virtual CPU devices, with ``--xla_allow_excess_precision=false``
and the highest matmul precision (as ``test_torch_train.py`` runs it), the
batch placed by ``batch_specs`` as in ``__graft_entry__.dryrun_multichip``
where its rows divide over the data axis, and unplaced where they do not
(the JAX CLI places no batch). Both start from ``init_params(PRNGKey(0))``
of ``DotsOCRConfig.tiny()`` in float32, on ``make_dummy_batch`` rows of 16
tokens with 4 merged vision tokens.

Layouts: TP = 2; TP = 4 (2 KV heads on 4 ranks: each repeated on 2, the
vision attention's 2 heads whole); model 2 x data 2; data 2; data 2 over an
uneven batch of 3 rows, and over 1 row (data rank 1 holds none). Tolerances are ``test_three_train_steps_match_jax``'s:
loss and grad_norm 1e-5 relative, accuracy exactly, every updated leaf
within 1e-5 relative plus ``STEP_ATOL`` but the key biases
(``ROUNDING_NOISE``, whose exact gradient is 0). What must not move at all
is held bit for bit: remat against no remat, a checkpoint's state, the
step after a restore against the step from memory.
"""

import json
import math
import multiprocessing
import os
import pickle
import re
import socket
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.models.init import init_params as jax_init
from dots_ocr_tpu.parallel.distributed import multihost_mesh
from dots_ocr_tpu.parallel.sharding import kv_cache_spec as jax_kv_cache_spec
from dots_ocr_tpu.parallel.sharding import make_mesh
from dots_ocr_tpu_torch.engine import kv_cache as tkv
from dots_ocr_tpu_torch.models import quantize as tq
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params, init_params
from dots_ocr_tpu_torch.models.layers import linear
from dots_ocr_tpu_torch.ops.paged_attention import choose_paged_kernel
from dots_ocr_tpu_torch.parallel import sharding
from dots_ocr_tpu_torch.parallel.distributed import Layout, make_layout
from dots_ocr_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from dots_ocr_tpu_torch.train.train_step import (
    init_train_state,
    make_optimizer,
    train_step,
    tree_items,
)

import train_ranks
from test_torch_train import LR, ROUNDING_NOISE, STEP_ATOL

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CFG = DotsOCRConfig.tiny()
WORKERS = 4
LAYOUTS = [
    dict(name="tp2", data=1, model=2, batch=2, scenarios=("three", "remat", "checkpoint", "mlp")),
    dict(name="tp4", data=1, model=4, batch=2, scenarios=("norm",)),
    dict(name="m2d2", data=2, model=2, batch=2, scenarios=("norm",)),
    dict(name="d2", data=2, model=1, batch=2, scenarios=()),
    dict(name="d2_uneven", data=2, model=1, batch=3, scenarios=()),
    # one row: data rank 1 has none, and issues every collective all the same
    dict(name="d2_empty", data=2, model=1, batch=1, scenarios=("one",)),
]
REQUIRED = ["tp2", "tp4", "m2d2", "d2", "d2_uneven"]
BY_NAME = {lay["name"]: lay for lay in LAYOUTS}

JAX_SIDE = """
import json, pickle, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
import numpy as np
from jax.sharding import NamedSharding
from dots_ocr_tpu.models.config import DotsOCRConfig
from dots_ocr_tpu.models.init import init_params
from dots_ocr_tpu.parallel.sharding import batch_specs, make_mesh, shard_params
from dots_ocr_tpu.train import train_step as ts

spec = json.loads(sys.argv[1])
cfg = DotsOCRConfig.tiny()
host = lambda tree: jax.tree.map(np.asarray, tree)
opt = ts.make_optimizer(learning_rate=spec["lr"])
out = {}
for lay in spec["layouts"]:
    data, model = lay["data"], lay["model"]
    mesh = make_mesh(data=data, model=model, devices=jax.devices()[:data * model])
    params = shard_params(init_params(jax.random.PRNGKey(0), cfg), cfg, mesh)
    state = ts.init_train_state(params, opt)
    steps = []
    for seed in lay["seeds"]:
        batch = ts.make_dummy_batch(cfg, batch_size=lay["batch"], seq_len=16, vision_tokens=4,
                                    seed=seed)
        if data > 1 and lay["batch"] % data == 0:
            tok, seq = batch_specs(mesh)
            put = lambda x, s: jax.device_put(x, NamedSharding(mesh, s))
            batch = batch._replace(
                input_ids=put(batch.input_ids, tok), positions=put(batch.positions, tok),
                seq_lens=put(batch.seq_lens, seq), target_ids=put(batch.target_ids, tok),
                loss_mask=put(batch.loss_mask, tok))
        with jax.set_mesh(mesh):
            state, m = ts.train_step(state, batch, cfg, opt)
        steps.append(dict(metrics=host(m), params=host(state.params)))
    out[lay["name"]] = steps
with open(spec["out"], "wb") as f:
    pickle.dump(out, f)
"""


def _jax_numpy_params():
    return jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), JaxConfig.tiny()))


def _seeds(lay):
    return [0, 1, 2] if "three" in lay["scenarios"] else [0]


def _one_process(batch_size, seeds, state=None):
    """The port's one-process steps from the JAX init (or ``state``):
    [(metrics, whole state)] after each step."""
    opt = make_optimizer(learning_rate=LR)
    if state is None:
        state = init_train_state(from_numpy_params(_jax_numpy_params(), CFG, CPU), opt)
    out = []
    for seed in seeds:
        state, m = train_step(state, train_ranks.batch(batch_size, seed), CFG, opt)
        out.append(({k: float(v) for k, v in m.items()}, train_ranks.numpy_state(state)))
    return out


def _mlp_inputs():
    rng = np.random.RandomState(7)
    return {"x": rng.randn(6, 16).astype(np.float32), "w1": rng.randn(16, 32).astype(np.float32),
            "w2": rng.randn(32, 16).astype(np.float32), "c": rng.randn(6, 16).astype(np.float32)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(rank results by layout: a list by rank, the JAX mesh steps by
    layout, the workdir): the workers and the JAX subprocess run at once."""
    workdir = tmp_path_factory.mktemp("train_tp")
    one = _one_process(2, [0])[0][1]
    save_checkpoint(str(workdir / "ckpt_one"), train_ranks.state_from_numpy(one), CFG)
    inputs = {"params": _jax_numpy_params(), "lr": LR, "layouts": LAYOUTS,
              "one_state": one, "mlp": _mlp_inputs(), "grads": train_ranks.ranks_grads()}
    with open(workdir / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)

    jax_out = workdir / "jax.pkl"
    spec = dict(lr=LR, out=str(jax_out),
                layouts=[dict(lay, seeds=_seeds(lay)) for lay in LAYOUTS])
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false "
                         "--xla_force_host_platform_device_count=8")
    jax_proc = {}

    def jax_side():
        jax_proc["p"] = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(spec)],
                                       env=env, capture_output=True, text=True, timeout=600,
                                       cwd=REPO)

    thread = threading.Thread(target=jax_side)
    thread.start()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=train_ranks.run_worker, args=(slot, str(workdir)))
             for slot in range(WORKERS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=400)
    for p in procs:
        if p.is_alive():
            p.kill()
    thread.join()
    assert jax_proc["p"].returncode == 0, jax_proc["p"].stderr[-3000:]
    with open(jax_out, "rb") as f:
        jax_steps = pickle.load(f)
    workers = []
    for slot in range(WORKERS):
        path = workdir / f"worker{slot}.pkl"
        assert path.exists(), f"worker {slot} wrote nothing (exit {procs[slot].exitcode})"
        with open(path, "rb") as f:
            res = pickle.load(f)
        assert "error" not in res, f"worker {slot}:\n{res['error']}"
        workers.append(res)
    ranks = {lay["name"]: [w[lay["name"]] for w in workers if lay["name"] in w]
             for lay in LAYOUTS}
    for lay in LAYOUTS:
        assert len(ranks[lay["name"]]) == lay["data"] * lay["model"], lay["name"]
    return ranks, jax_steps, workdir


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        out.update(_flat(v, name + ".") if isinstance(v, dict) else {name: np.asarray(v)})
    return out


def _hold(metrics, params, want_metrics, want_params, label):
    """``test_three_train_steps_match_jax``'s tolerances."""
    for key in ("loss", "grad_norm"):
        assert math.isclose(metrics[key], float(want_metrics[key]), rel_tol=1e-5), (
            label, key, metrics[key], float(want_metrics[key]))
    assert metrics["accuracy"] == float(want_metrics["accuracy"]), label
    assert metrics["tokens"] == float(want_metrics["tokens"]), label
    got, want = _flat(params), _flat(want_params)
    assert set(got) == set(want), label
    for name, w in want.items():
        assert got[name].shape == w.shape, (label, name)
        if name in ROUNDING_NOISE:
            continue
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=STEP_ATOL,
                                   err_msg=f"{label}: {name}")


def _equal_states(a, b, label):
    for tree in ("params", "mu", "nu"):
        assert set(a[tree]) == set(b[tree])
        for name in a[tree]:
            assert a[tree][name].dtype == b[tree][name].dtype, (label, tree, name)
            np.testing.assert_array_equal(a[tree][name], b[tree][name],
                                          err_msg=f"{label}: {tree}.{name}")
    assert a["count"] == b["count"] and a["step"] == b["step"], label


@pytest.mark.parametrize("name", REQUIRED)
def test_train_step_matches_jax_mesh_and_one_process(run, name):
    ranks, jax_steps, _ = run
    lay = BY_NAME[name]
    got = ranks[name][0]["step"]
    metrics, state = got["metrics"][0], got["state"]
    want = jax_steps[name][0]
    _hold(metrics, state["params"], want["metrics"], want["params"], f"{name} vs JAX mesh")
    one_metrics, one_state = _one_process(lay["batch"], [0])[0]
    _hold(metrics, state["params"], one_metrics, one_state["params"], f"{name} vs one process")
    # every rank reports the same global metrics, and issued the same collectives
    for res in ranks[name][1:]:
        assert res["step"]["metrics"] == got["metrics"], name
        assert res["step"]["state"] is None


def test_a_data_rank_without_rows_issues_every_collective(run):
    """One row over 2 data ranks: rank 1 holds none and still issues every
    collective, and the step is the one-process step: bit for bit against
    it taken in the rank's process (rank 1 adds exact zeros), the metrics
    within the tolerances of the JAX mesh step. (Its leaves are not held to
    JAX's: at one row the port's one-process step itself moves one
    vision.patch_embed.kernel element past STEP_ATOL of JAX's below 8 CPU
    threads, as these ranks run, and within it at 8: a gradient near
    rounding noise that Adam scales to a step.)"""
    ranks, jax_steps, _ = run
    got = ranks["d2_empty"][0]
    assert got["step"]["metrics"][0]["tokens"] == 15.0
    _equal_states(got["step"]["state"], got["one"]["state"], "one row vs one process")
    ours = {k: v for k, v in got["step"]["metrics"][0].items() if k != "all_reduces"}
    assert ours == got["one"]["metrics"][0]
    want = jax_steps["d2_empty"][0]["metrics"]
    for key in ("loss", "grad_norm"):
        assert math.isclose(ours[key], float(want[key]), rel_tol=1e-5), key
    assert ours["accuracy"] == float(want["accuracy"])
    counts = [res["step"]["metrics"][0]["all_reduces"] for res in ranks["d2_empty"]]
    assert counts[0] == counts[1] > 0


def test_layouts_split_where_expected(run):
    ranks, _, _ = run
    assert ranks["tp2"][0]["row_parallel"] == sorted(sharding.ROW_PARALLEL_PARTS)
    # 2 vision heads on 4 ranks: the vision attention stays whole
    assert "vision.attn" not in ranks["tp4"][0]["row_parallel"]
    assert all(res["kv_replication"] == 2 for res in ranks["tp4"])
    assert ranks["d2"][0]["row_parallel"] == []


def test_three_tp2_steps_match_jax_and_one_process(run):
    ranks, jax_steps, _ = run
    got = ranks["tp2"][0]["three"]
    ones = _one_process(2, [0, 1, 2])
    for i, (metrics, want, (one_m, _)) in enumerate(zip(got["metrics"], jax_steps["tp2"], ones)):
        for key in ("loss", "grad_norm"):
            assert math.isclose(metrics[key], float(want["metrics"][key]), rel_tol=1e-5), i
            assert math.isclose(metrics[key], one_m[key], rel_tol=1e-5), i
    _hold(got["metrics"][-1], got["state"]["params"], jax_steps["tp2"][-1]["metrics"],
          jax_steps["tp2"][-1]["params"], "third TP = 2 step vs JAX mesh")
    _hold(got["metrics"][-1], got["state"]["params"], ones[-1][0], ones[-1][1]["params"],
          "third TP = 2 step vs one process")


def test_remat_equals_no_remat_under_tp(run):
    ranks, _, _ = run
    for res in ranks["tp2"]:
        a, b = res["step"]["metrics"][0], res["remat"]["metrics"][0]
        assert {k: v for k, v in a.items() if k != "all_reduces"} == \
            {k: v for k, v in b.items() if k != "all_reduces"}
        # the recomputed forward runs the layers' collectives again
        assert b["all_reduces"] > a["all_reduces"]
    _equal_states(ranks["tp2"][0]["step"]["state"], ranks["tp2"][0]["remat"]["state"], "remat")


def test_every_rank_issues_the_same_collectives(run):
    """All ranks of a layout count the same collectives a step (a rank
    that skipped one would hang the others); TP = 2's count: per layer f
    and g at the attention and the MLP in both towers, f / g at the merger,
    the data-free gradient sums (none) and one norm all-reduce."""
    ranks, _, _ = run
    for lay in LAYOUTS:
        counts = {res["step"]["metrics"][0]["all_reduces"] for res in ranks[lay["name"]]}
        assert len(counts) == 1, (lay["name"], counts)
    layers = CFG.decoder.num_layers + CFG.vision.num_layers
    assert ranks["tp2"][0]["step"]["metrics"][0]["all_reduces"] == 4 * layers + 2 + 1


def test_fg_pair_gradients_match_one_process(run):
    """f before a column-parallel linear and g after a row-parallel one:
    each rank's output and gradient of x equal one process's, and its
    weight gradients are its slices of the whole ones. (An all-reduce whose
    backward sums again would double every gradient here.)"""
    ranks, _, _ = run
    x = _mlp_inputs()
    xt = torch.from_numpy(x["x"]).requires_grad_(True)
    w1 = torch.from_numpy(x["w1"]).requires_grad_(True)
    w2 = torch.from_numpy(x["w2"]).requires_grad_(True)
    out = linear(torch.tanh(linear(xt, w1)), w2)
    (out * torch.from_numpy(x["c"])).sum().backward()
    for rank, res in enumerate(ranks["tp2"]):
        got = res["mlp"]
        cols = slice(rank * 16, (rank + 1) * 16)
        np.testing.assert_allclose(got["out"], out.detach().numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["x"], xt.grad.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["w1"], w1.grad.numpy()[:, cols], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["w2"], w2.grad.numpy()[cols], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tp4", "m2d2"])
def test_sharded_global_norm_counts_each_element_once(run, name):
    """Split leaves summed over the model group, KV-replicated ones once a
    KV head (TP = 4), whole ones once: the whole tree's norm."""
    ranks, _, _ = run
    for res in ranks[name]:
        assert math.isclose(res["norm"]["sharded"], res["norm"]["whole"], rel_tol=1e-6)


def test_tp2_checkpoint_restores_at_tp1(run):
    """A TP = 2 checkpoint holds whole tensors: restored in one process it
    equals the gathered state bit for bit, and the next step from it
    equals the next TP = 2 step from memory within the tolerances."""
    ranks, _, workdir = run
    res = ranks["tp2"][0]
    restored, cfg = restore_checkpoint(str(workdir / "ckpt_tp"), CPU)
    assert cfg == CFG
    _equal_states(train_ranks.numpy_state(restored), res["saved"]["state"], "TP = 2 checkpoint")
    (metrics, state), = _one_process(2, [1], state=restored)
    _hold(metrics, state["params"], res["after_save"]["metrics"][0],
          res["after_save"]["state"]["params"], "restored at TP = 1")


def test_tp1_checkpoint_restores_at_tp2(run):
    """A one-process checkpoint restored and sharded at TP = 2: its next
    step equals, bit for bit, the TP = 2 step from the same state held in
    memory, and the one-process step within the tolerances."""
    ranks, _, _ = run
    res = ranks["tp2"][0]
    assert res["restored"]["metrics"] == res["memory"]["metrics"]
    _equal_states(res["restored"]["state"], res["memory"]["state"], "TP = 1 checkpoint")
    one = _one_process(2, [0])[0][1]
    (metrics, after), = _one_process(2, [1], state=train_ranks.state_from_numpy(one))
    _hold(res["restored"]["metrics"][0], res["restored"]["state"]["params"], metrics,
          after["params"], "restored at TP = 2")


def test_layout_matches_make_mesh_and_multihost_mesh():
    """Rank r sits where ``make_mesh`` puts device r (row-major (data,
    model)); ``multihost_mesh`` over 8 devices has the same order; the
    divisibility rules of ``auto_mesh`` and ``multihost_mesh``."""
    devices = jax.devices()[:8]
    for data, model in [(1, 8), (2, 4), (4, 2), (8, 1), (2, 2), (1, 2)]:
        mesh = make_mesh(data=data, model=model, devices=devices[:data * model])
        lay = make_layout(data * model, model)
        assert lay == Layout(data, model)
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        for rank in range(data * model):
            d, m = lay.coords(rank)
            assert devices[rank].id == ids[d, m]
            assert rank in lay.model_ranks(d) and rank in lay.data_ranks(m)
        for d in range(data):
            assert [devices[r].id for r in lay.model_ranks(d)] == list(ids[d])
        for m in range(model):
            assert [devices[r].id for r in lay.data_ranks(m)] == list(ids[:, m])
    for model in (1, 2, 4, 8):
        mesh = multihost_mesh(model_parallel=model)
        ids = np.vectorize(lambda d: d.id)(mesh.devices)
        lay = make_layout(8, model, local_world=8)
        assert ids.shape == (lay.data, lay.model)
        assert [ids[lay.coords(r)] for r in range(8)] == [d.id for d in jax.devices()]
    with pytest.raises(AssertionError):
        multihost_mesh(model_parallel=3)
    with pytest.raises(ValueError, match="not divisible"):
        make_layout(8, 3)
    with pytest.raises(ValueError, match="cross a node"):
        make_layout(8, 4, local_world=2)
    assert Layout(2, 4).replica_ranks(1, 1, 2) == [6, 7]


@pytest.mark.parametrize("name", ["tiny", "flagship"])
@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (2, 2), (2, 1), (1, 4), (2, 4)])
def test_kv_cache_spec_matches_jax(name, data, model):
    tcfg = getattr(DotsOCRConfig, name)()
    spec = jax_kv_cache_spec(getattr(JaxConfig, name)(),
                             make_mesh(data=data, model=model,
                                       devices=jax.devices()[:data * model]))
    rows_split, heads = sharding.kv_cache_spec(tcfg, data, model)
    assert rows_split == (spec[1] == "data")
    kv = tcfg.decoder.num_kv_heads
    assert heads == (kv // model if spec[3] == "model" else kv)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("kind", ["plain", "int8", "w8a8"])
def test_unshard_inverts_shard(kind, world):
    params = init_params(CFG, CPU, torch.Generator().manual_seed(3))
    if kind == "int8":
        params = tq.quantize_decoder_params(params)
    elif kind == "w8a8":
        params = tq.quantize_vision_params(params)
    shards = [sharding.shard_params(params, CFG, r, world) for r in range(world)]
    whole = sharding.unshard_params([t for t, _ in shards], shards[0][1], CFG)
    got, want = dict(tree_items(whole)), dict(tree_items(params))
    assert list(got) == list(want)
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


def test_shard_batch_rows_and_vision_rows():
    """A data rank's rows are its block of ``np.array_split``; the packed
    vision inputs stay whole and each merged row lands in its local row or
    the sentinel."""
    b = train_ranks.batch(3, 0)
    assert [sharding.data_rows(3, 2, r) for r in range(2)] == [(0, 2), (2, 3)]
    for rank, (start, end) in enumerate([(0, 2), (2, 3)]):
        part = sharding.shard_batch(b, 2, rank)
        assert torch.equal(part.input_ids, b.input_ids[start:end])
        assert torch.equal(part.patches, b.patches)
        local = part.scatter_batch
        mine = (b.scatter_batch >= start) & (b.scatter_batch < end)
        assert torch.equal(local[mine], b.scatter_batch[mine] - start)
        assert bool((local[~mine] == end - start).all())
        assert bool((part.scatter_pos[~mine] == b.input_ids.shape[1]).all())
    assert sharding.shard_batch(b, 1, 0) is b


def test_quantized_tree_is_refused_for_training():
    params = tq.quantize_decoder_params(init_params(CFG, CPU, torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="float parameter tree"):
        init_train_state(params, make_optimizer())


def test_tp_decode_route_matches_jax_shard_map(monkeypatch):
    """Queue C item 14 on the CPU: under TP = 2 at int8 KV, page 64, the
    JAX package's default decode runs ``paged_attention_multiquery`` on each
    head shard, which falls back to kernel 3 at nq = 1 and to the XLA
    reference at nq > 1; a rank of the port takes ``choose_paged_kernel``'s
    route on its own pool of one KV head, the same one. The pool's int8
    scales are the rank's heads' contiguous block of the flat scales, as
    ``paged_kv_specs`` splits them."""
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    import dots_ocr_tpu.ops.paged_attention as jpa
    from dots_ocr_tpu.engine import kv_cache as jkv
    from dots_ocr_tpu.ops.tp import paged_attention_multiquery_tp
    from dots_ocr_tpu.parallel.sharding import paged_kv_specs

    page, pages, world = 64, 4, 2
    mesh = make_mesh(data=1, model=world, devices=jax.devices()[:world])
    taken = []

    def spy(route, fn):
        def wrapped(*args, **kwargs):
            taken.append(route)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(jpa, "paged_attention",
                        spy("v1", lambda q, *a, **k: jnp.zeros_like(q)))
    monkeypatch.setattr(jpa, "paged_attention_multiquery_reference",
                        spy("xla", lambda q, *a, **k: jnp.zeros_like(q)))
    d = JaxConfig.tiny().decoder
    shard = sharding.shard_params(init_params(CFG, CPU, torch.Generator().manual_seed(0)),
                                  CFG, 0, world)[1].config.decoder
    pool = tkv.PagedKV.create(CFG.decoder, pages, page, torch.float32, CPU, quantized=True,
                              world=world)
    assert pool.k[0].shape[0] == shard.num_kv_heads == 1
    assert pool.k_scale[0].shape == (pages * page,)
    # the tiny shard's head_dim, and the flagship's (128)
    for head_dim in (shard.head_dim, 128):
        for nq in (1, 3):
            taken.clear()
            q = jax.device_put(jnp.zeros((2, nq, d.num_heads, head_dim), jnp.bfloat16),
                               NamedSharding(mesh, P(None, None, "model", None)))
            kv = jax.device_put(jnp.zeros((d.num_kv_heads, pages, page, head_dim), jnp.int8),
                                NamedSharding(mesh, P("model")))
            sc = jax.device_put(jnp.ones((d.num_kv_heads, pages, page), jnp.float32),
                                NamedSharding(mesh, P("model")))
            paged_attention_multiquery_tp(q, kv, kv, jnp.ones((2,), jnp.int32),
                                          jnp.zeros((2, pages), jnp.int32), mesh=mesh,
                                          k_scales=sc, v_scales=sc)
            route = choose_paged_kernel(head_dim, page, True, nq)
            assert route == ("v1" if nq == 1 else "xla")
            assert taken and set(taken) == {route}, (head_dim, nq, taken)
    # the flat scales: each rank's block of the JAX pool's [KV * N_slots]
    spec = paged_kv_specs(JaxConfig.tiny(), mesh, quantized=True).k_scale[0]
    assert spec == P("model")
    slots = torch.tensor([3, 70, 130])
    rows = torch.randn(3, d.num_kv_heads, d.head_dim)
    whole = tkv.PagedKV.create(CFG.decoder, pages, page, torch.float32, CPU, quantized=True)
    tkv.write_kv_rows(whole, 0, slots, rows, rows)
    jpool = jkv.PagedKV.create(d, pages, page, dtype=jnp.float32, quantized=True)
    assert jpool.k_scale[0].shape == whole.k_scale[0].shape
    n = pages * page
    for rank in range(world):
        mine = tkv.PagedKV.create(CFG.decoder, pages, page, torch.float32, CPU,
                                  quantized=True, world=world)
        tkv.write_kv_rows(mine, 0, slots, rows[:, rank:rank + 1], rows[:, rank:rank + 1])
        assert torch.equal(mine.k_scale[0], whole.k_scale[0][rank * n:(rank + 1) * n])
        assert torch.equal(mine.k[0][0], whole.k[0][rank])


STEP_LINE = re.compile(r"step=(\d+) loss=(\S+) acc=(\S+) grad_norm=(\S+) ms_per_step=(\S+) "
                       r"tokens_per_s=(\S+)")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_cli_trains_over_two_gloo_ranks(tmp_path):
    """``torchrun``'s environment for 2 processes, ``--model-parallel 2
    --tp-backend gloo``: rank 0 alone logs 2 finite steps and writes a
    checkpoint of whole tensors; rank 1 logs no step."""
    ckpt = tmp_path / "ckpt"
    port = _free_port()
    argv = [sys.executable, "-m", "dots_ocr_tpu_torch.train.cli", "--synthetic", "1", "--size",
            "tiny", "--device", "cpu", "--steps", "2", "--batch-size", "2", "--seq-len", "32",
            "--log-every", "1", "--model-parallel", "2", "--tp-backend", "gloo", "--ckpt",
            str(ckpt)]
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port))
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True, cwd=REPO))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    steps = [m.groups() for m in STEP_LINE.finditer(outs[0][1])]
    assert [int(s[0]) for s in steps] == [1, 2]
    for _, loss, acc, norm, ms, tps in steps:
        assert all(math.isfinite(float(x)) for x in (loss, acc, norm, ms, tps))
    assert not STEP_LINE.search(outs[1][1])
    assert "1 data x 2 model ranks over gloo" in outs[0][1]
    restored, cfg = restore_checkpoint(str(ckpt), CPU)
    assert cfg == CFG and int(restored.step) == 2
    full = init_params(CFG, CPU, torch.Generator().manual_seed(0))
    for (name, got), (_, want) in zip(tree_items(restored.params), tree_items(full)):
        assert got.shape == want.shape, name
