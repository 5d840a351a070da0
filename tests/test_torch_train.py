"""The port's training path (``dots_ocr_tpu_torch.train``) against the JAX
package's, on the CPU, on ``DotsOCRConfig.tiny()`` in float32 with
``init_params(PRNGKey(0))`` weights (scale 0.02).

The JAX side runs once, in a subprocess with ``--xla_allow_excess_precision
=false`` and the highest matmul precision (as ``test_torch_engine_parity.py``
runs it), and hands its arrays back through a pickle: the dummy batches and
their loss, metrics and gradients, two optax updates on fixed gradients,
three ``train_step``s, the state after them and the step taken from it, and
``cli.build_batch`` on a JSONL row with a PNG.

Tolerances (float32; both sides add the same products in other orders):
  * loss and grad_norm: 1e-5 relative;
  * each gradient leaf: 1e-5 of that leaf's largest JAX gradient;
  * the optimizer on the same gradients (params, mu, nu): 1e-6 relative,
    plus 1e-6 of the leaf's largest value for entries that cancel to ~0;
    the count exactly;
  * the parameters after train steps: 1e-5 relative or 1% of the learning
    rate, the key biases excepted (``ROUNDING_NOISE``);
  * batches (make_dummy_batch, build_batch), remat against no remat, and a
    step after a checkpoint round trip: exactly.
"""

import json
import math
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from dots_ocr_tpu.train import cli as jax_cli
from dots_ocr_tpu.train.checkpoint import _config_to_dict as jax_config_to_dict
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu_torch.engine.scheduler import default_tokenizer
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import from_numpy_params
from dots_ocr_tpu_torch.train import cli
from dots_ocr_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from dots_ocr_tpu_torch.train.train_step import (
    AdamState,
    TrainState,
    from_numpy_train_state,
    global_norm,
    init_train_state,
    loss_fn,
    make_dummy_batch,
    make_optimizer,
    train_step,
    tree_from_items,
    tree_items,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
CFG = DotsOCRConfig.tiny()
LR = 1e-3
# Per-element scales of the fixed gradients fed to both optimizers: the
# first update's global norm stays under the clip (1.0), the second's is
# far over it.
GRAD_SCALES = (1e-4, 1e-1)
SEQ = 128  # build_batch's row length
# Leaves whose exact gradient is 0: a key bias shifts every score of a
# query by the same q . b, which the softmax cancels. Their computed
# gradients are rounding noise, which Adam's m / sqrt(v) scales to
# learning-rate-sized steps of either sign, so after a train_step they are
# held to the gradients' and losses' agreement only (the optimizer on the
# same gradients is held everywhere).
ROUNDING_NOISE = ("vision.blocks.attn.bk", "decoder.blocks.attn.bk")
# The other parameters after train steps: 1e-5 relative, or 1% of one
# step's size (the learning rate bounds an Adam step) where an element's
# small gradient differs in its last digits and m / sqrt(v) scales that up.
STEP_ATOL = 1e-2 * LR

JAX_SIDE = """
import json, pickle, sys
import jax
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp
import numpy as np
import optax
from dots_ocr_tpu.engine.engine import InferenceEngine
from dots_ocr_tpu.models.config import DotsOCRConfig
from dots_ocr_tpu.models.init import init_params
from dots_ocr_tpu.train import train_step as ts
from dots_ocr_tpu.train.cli import build_batch

spec = json.loads(sys.argv[1])
cfg = DotsOCRConfig.tiny()
host = lambda tree: jax.tree.map(np.asarray, tree)
arrays = lambda batch: {k: np.asarray(v) for k, v in batch._asdict().items() if v is not None}
params = init_params(jax.random.PRNGKey(0), cfg)
out = {"params": host(params)}
grad_fn = jax.jit(jax.value_and_grad(ts.loss_fn, has_aux=True), static_argnums=1)
for vt in (0, 4):
    batch = ts.make_dummy_batch(cfg, batch_size=2, seq_len=16, vision_tokens=vt, seed=0)
    (_, metrics), grads = grad_fn(params, cfg, batch)
    out[f"dummy{vt}"] = dict(batch=arrays(batch), metrics=host(metrics), grads=host(grads))

opt = ts.make_optimizer(learning_rate=spec["lr"])
rng = np.random.RandomState(1)
p, s, updates = params, opt.init(params), []
for scale in spec["grad_scales"]:
    g = jax.tree.map(lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * scale), p)
    u, s = opt.update(g, s, p)
    p = optax.apply_updates(p, u)
    updates.append(dict(grads=host(g), norm=float(optax.global_norm(g)), params=host(p),
                        opt_state=host(s)))
out["updates"] = updates

state = ts.init_train_state(params, opt)
steps = []
for seed in range(3):
    batch = ts.make_dummy_batch(cfg, batch_size=2, seq_len=16, vision_tokens=4, seed=seed)
    state, m = ts.train_step(state, batch, cfg, opt)
    steps.append(host(m))
out["steps"] = steps
out["mid"] = dict(params=host(state.params), opt_state=host(state.opt_state),
                  step=int(state.step))
batch = ts.make_dummy_batch(cfg, batch_size=2, seq_len=16, vision_tokens=4, seed=3)
state, m = ts.train_step(state, batch, cfg, opt)
out["resumed"] = dict(metrics=host(m), params=host(state.params))

tok = InferenceEngine._default_tokenizer(cfg)
built = build_batch(spec["rows"], tok, cfg, spec["seq"])
(_, metrics), _ = grad_fn(params, cfg, built)
out["built"] = dict(batch=arrays(built), metrics=host(metrics))
with open(spec["out"], "wb") as f:
    pickle.dump(out, f)
"""


def _rows(png):
    return [{"prompt": "Extract the text content from this image.", "response": "hello world",
             "images": [png]},
            {"prompt": "a text-only prompt", "response": "a response that runs on " * 3}]


@pytest.fixture(scope="module")
def png(tmp_path_factory):
    path = tmp_path_factory.mktemp("train") / "page.png"
    Image.fromarray(np.random.RandomState(0).randint(0, 255, (56, 84, 3), np.uint8)).save(path)
    return str(path)


@pytest.fixture(scope="module")
def ref(png, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax") / "ref.pkl"
    spec = dict(lr=LR, grad_scales=GRAD_SCALES, rows=_rows(png), seq=SEQ, out=str(out))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(spec)], env=env,
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _params(ref):
    return from_numpy_params(ref["params"], CFG, CPU)


def _flat(tree):
    return {name: np.asarray(t.detach().numpy() if isinstance(t, torch.Tensor) else t)
            for name, t in tree_items(tree)}


def _close_leaves(got_tree, want_tree, rtol, atol_of_max=0.0, atol=0.0, skip=()):
    got, want = _flat(got_tree), _flat(want_tree)
    assert set(got) == set(want)
    for name, w in want.items():
        if name in skip:
            continue
        np.testing.assert_allclose(got[name], w, rtol=rtol,
                                   atol=atol + atol_of_max * float(np.abs(w).max()),
                                   err_msg=name)


def _grads(params, batch, remat=False):
    items = tree_items(params)
    leaves = [p.detach().clone().requires_grad_(True) for _, p in items]
    loss, metrics = loss_fn(dict_tree(items, leaves), CFG, batch, remat)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return metrics, dict_tree(items, [torch.zeros_like(p) if g is None else g
                                      for p, g in zip(leaves, grads)])


def dict_tree(items, leaves):
    return tree_from_items(zip((name for name, _ in items), leaves))


def _batch_arrays(batch):
    return {k: v.numpy() for k, v in batch._asdict().items() if v is not None}


@pytest.mark.parametrize("vt", [0, 4])
def test_make_dummy_batch_matches_jax(ref, vt):
    got = _batch_arrays(make_dummy_batch(CFG, batch_size=2, seq_len=16, vision_tokens=vt,
                                         seed=0, device=CPU))
    want = ref[f"dummy{vt}"]["batch"]
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("vt", [0, 4])
def test_loss_and_grads_match_jax(ref, vt):
    batch = make_dummy_batch(CFG, batch_size=2, seq_len=16, vision_tokens=vt, seed=0, device=CPU)
    metrics, grads = _grads(_params(ref), batch)
    want = ref[f"dummy{vt}"]
    assert math.isclose(float(metrics["loss"].detach()), float(want["metrics"]["loss"]),
                        rel_tol=1e-5)
    assert float(metrics["accuracy"]) == float(want["metrics"]["accuracy"])
    assert float(metrics["tokens"]) == float(want["metrics"]["tokens"]) == 2 * 15
    _close_leaves(grads, want["grads"], rtol=0.0, atol_of_max=1e-5)
    vision = [np.abs(g).max() for name, g in _flat(grads).items() if name.startswith("vision")]
    assert (min(vision) > 0) == (vt > 0)  # the encoder gets gradients only with images


def test_optimizer_matches_optax(ref):
    """The same fixed gradients through optax's chain and the port's AdamW:
    the first update's norm is under the clip, the second's over it."""
    opt = make_optimizer(learning_rate=LR)
    params = _params(ref)
    state = opt.init(params)
    for i, want in enumerate(ref["updates"]):
        grads = [g.clone() for _, g in tree_items(from_numpy_params(want["grads"], CFG, CPU))]
        state, g_norm = opt.update(params, grads, state)
        assert math.isclose(float(g_norm), want["norm"], rel_tol=1e-6)
        assert (float(g_norm) < 1.0) == (i == 0)
        _close_leaves(params, want["params"], rtol=1e-6, atol_of_max=1e-6)
        adam = from_numpy_train_state(want["opt_state"], CFG, CPU)
        assert int(state.count) == int(adam.count) == i + 1
        assert state.count.dtype == torch.int32
        _close_leaves(state.mu, _flat(adam.mu), rtol=1e-6, atol_of_max=1e-6)
        _close_leaves(state.nu, _flat(adam.nu), rtol=1e-6, atol_of_max=1e-6)


def test_global_norm_and_clip_rule():
    """optax's clip: (t / g) * c when g >= c, untouched below; not
    clip_grad_norm_'s t * c / (g + 1e-6)."""
    opt = make_optimizer(learning_rate=1.0, weight_decay=0.0, grad_clip=1.0)
    for scale, clipped in ((0.5, False), (4.0, True)):
        p = {"w": torch.zeros(4)}
        g = torch.tensor([3.0, 4.0, 0.0, 0.0]) * scale / 5.0  # norm = scale
        state, norm = opt.update(p, [g.clone()], opt.init(p))
        assert math.isclose(float(norm), scale, rel_tol=1e-6)
        assert torch.equal(norm, global_norm([g]))
        mu = state.mu["w"]
        want = (g / norm) * 1.0 if clipped else g
        torch.testing.assert_close(mu, 0.1 * want, rtol=0, atol=0)


def test_three_train_steps_match_jax(ref):
    opt = make_optimizer(learning_rate=LR)
    state = init_train_state(_params(ref), opt)
    for seed, want in enumerate(ref["steps"]):
        batch = make_dummy_batch(CFG, batch_size=2, seq_len=16, vision_tokens=4, seed=seed,
                                 device=CPU)
        state, m = train_step(state, batch, CFG, opt)
        assert math.isclose(float(m["loss"]), float(want["loss"]), rel_tol=1e-5), seed
        assert math.isclose(float(m["grad_norm"]), float(want["grad_norm"]), rel_tol=1e-5), seed
    assert int(state.step) == 3 and state.step.dtype == torch.int32
    _close_leaves(state.params, ref["mid"]["params"], rtol=1e-5, atol=STEP_ATOL,
                  skip=ROUNDING_NOISE)


def test_resume_from_jax_mid_training_state(ref):
    """The JAX state after three steps, carried over with
    from_numpy_params / from_numpy_train_state: the fourth step agrees."""
    mid = ref["mid"]
    state = TrainState(from_numpy_params(mid["params"], CFG, CPU),
                       from_numpy_train_state(mid["opt_state"], CFG, CPU),
                       torch.tensor(mid["step"], dtype=torch.int32))
    assert int(state.opt_state.count) == 3
    batch = make_dummy_batch(CFG, batch_size=2, seq_len=16, vision_tokens=4, seed=3, device=CPU)
    state, m = train_step(state, batch, CFG, make_optimizer(learning_rate=LR))
    want = ref["resumed"]
    assert math.isclose(float(m["loss"]), float(want["metrics"]["loss"]), rel_tol=1e-5)
    assert math.isclose(float(m["grad_norm"]), float(want["metrics"]["grad_norm"]),
                        rel_tol=1e-5)
    _close_leaves(state.params, want["params"], rtol=1e-5, atol=STEP_ATOL,
                  skip=ROUNDING_NOISE)
    with pytest.raises(ValueError, match="ScaleByAdamState"):
        from_numpy_train_state((), CFG, CPU)


def test_remat_equals_no_remat(ref):
    batch = make_dummy_batch(CFG, batch_size=2, seq_len=16, vision_tokens=4, seed=0, device=CPU)
    m0, g0 = _grads(_params(ref), batch, remat=False)
    m1, g1 = _grads(_params(ref), batch, remat=True)
    assert torch.equal(m0["loss"], m1["loss"])
    for (name, a), (_, b) in zip(tree_items(g0), tree_items(g1)):
        assert torch.equal(a, b), name
    opt = make_optimizer(learning_rate=LR)
    s0, _ = train_step(init_train_state(_params(ref), opt), batch, CFG, opt, remat=False)
    s1, _ = train_step(init_train_state(_params(ref), opt), batch, CFG, opt, remat=True)
    for (name, a), (_, b) in zip(tree_items(s0.params), tree_items(s1.params)):
        assert torch.equal(a, b), name


def test_build_batch_matches_jax(ref, png):
    batch = cli.build_batch(_rows(png), default_tokenizer(CFG), CFG, SEQ, device=CPU)
    got, want = _batch_arrays(batch), ref["built"]["batch"]
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["patches"].dtype == np.uint8 and got["loss_mask"].sum() > 0
    _, m = loss_fn(_params(ref), CFG, batch)
    assert math.isclose(float(m["loss"]), float(ref["built"]["metrics"]["loss"]), rel_tol=1e-5)
    assert float(m["tokens"]) == float(ref["built"]["metrics"]["tokens"])


def test_data_batches_cycle_like_jax(tmp_path):
    path = tmp_path / "rows.jsonl"
    path.write_text("\n".join(json.dumps({"prompt": f"p{i}", "response": "r"})
                              for i in range(3)) + "\n\n")
    ours, theirs = cli.data_batches(str(path), 2), jax_cli.data_batches(str(path), 2)
    seen = [[row["prompt"] for row in next(ours)] for _ in range(4)]
    assert seen == [[row["prompt"] for row in next(theirs)] for _ in range(4)]
    assert seen == [["p0", "p1"], ["p2", "p0"], ["p1", "p2"], ["p0", "p1"]]
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="no samples"):
        next(cli.data_batches(str(empty), 2))


def test_checkpoint_round_trip(ref, tmp_path):
    """tests/test_aux.py's round trip on the port: the restored state is
    the saved one, bit for bit, and resumes to the same next step."""
    opt = make_optimizer(learning_rate=LR)
    state = init_train_state(_params(ref), opt)
    batch = make_dummy_batch(CFG, batch_size=2, seq_len=8, device=CPU)
    state, _ = train_step(state, batch, CFG, opt)
    path = str(tmp_path / "ckpt")
    assert latest_step(path) is None
    save_checkpoint(path, state, CFG)
    assert latest_step(path) == 1
    with open(os.path.join(path, "model_config.json")) as f:
        assert json.load(f) == json.loads(json.dumps(jax_config_to_dict(JaxConfig.tiny())))
    assert sorted(os.listdir(path)) == ["latest", "model_config.json", "state_1"]

    restored, cfg2 = restore_checkpoint(path, CPU)
    assert cfg2 == CFG
    assert int(restored.step) == 1 and int(restored.opt_state.count) == 1
    for tree in ("params", "mu", "nu"):
        a = state.params if tree == "params" else getattr(state.opt_state, tree)
        b = restored.params if tree == "params" else getattr(restored.opt_state, tree)
        for (name, x), (name2, y) in zip(tree_items(a), tree_items(b)):
            assert name == name2 and x.dtype == y.dtype and torch.equal(x, y), name

    batch2 = make_dummy_batch(CFG, batch_size=2, seq_len=8, seed=1, device=CPU)
    ahead, m_ahead = train_step(_clone(state), batch2, CFG, opt)
    resumed, m_resumed = train_step(restored, batch2, CFG, opt)
    assert int(resumed.step) == 2
    assert torch.equal(m_ahead["loss"], m_resumed["loss"])
    for (name, x), (_, y) in zip(tree_items(ahead.params), tree_items(resumed.params)):
        assert torch.equal(x, y), name

    state3 = TrainState(state.params, state.opt_state, torch.tensor(5, dtype=torch.int32))
    save_checkpoint(path, state3, CFG)
    assert latest_step(path) == 5 and int(restore_checkpoint(path, CPU)[0].step) == 5
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), CPU)


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _clone(state):
    return TrainState(_copy(state.params), AdamState(state.opt_state.count.clone(),
                                                     _copy(state.opt_state.mu),
                                                     _copy(state.opt_state.nu)),
                      state.step.clone())


STEP_LINE = re.compile(r"step=(\d+) loss=(\S+) acc=(\S+) grad_norm=(\S+) ms_per_step=(\S+) "
                       r"tokens_per_s=(\S+)")


def test_cli_synthetic_on_cpu(tmp_path):
    ckpt = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "dots_ocr_tpu_torch.train.cli", "--synthetic", "2", "--size",
         "tiny", "--device", "cpu", "--steps", "3", "--batch-size", "2", "--seq-len", "32",
         "--log-every", "1", "--remat", "--ckpt", str(ckpt), "--ckpt-every", "2"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    steps = [m.groups() for m in STEP_LINE.finditer(proc.stderr)]
    assert [int(s[0]) for s in steps] == [1, 2, 3]
    for _, loss, acc, norm, ms, tps in steps:
        assert all(math.isfinite(float(x)) for x in (loss, acc, norm, ms, tps))
        assert float(ms) > 0 and float(tps) > 0
    assert latest_step(str(ckpt)) == 3
    assert sorted(os.listdir(ckpt)) == ["latest", "model_config.json", "state_2", "state_3"]


def test_cli_trains_on_jsonl(tmp_path, png, caplog):
    data = tmp_path / "sft.jsonl"
    data.write_text("\n".join(json.dumps(row) for row in _rows(png)))
    with caplog.at_level("INFO", logger="dots_ocr_tpu_torch.train.cli"):
        cli.main(["--data", str(data), "--size", "tiny", "--device", "cpu", "--steps", "2",
                  "--batch-size", "2", "--seq-len", str(SEQ), "--log-every", "1"])
    steps = [m.groups() for m in STEP_LINE.finditer(caplog.text)]
    assert [int(s[0]) for s in steps] == [1, 2]
    assert all(math.isfinite(float(s[1])) for s in steps)


@pytest.mark.parametrize("how", ["model_parallel", "world_size", "backend"])
def test_cli_refuses_tp(how, monkeypatch):
    """What the CLI refuses of TP training, with the reason, before it
    builds anything: ``--model-parallel`` that does not divide WORLD_SIZE
    (2 in one process, as ``auto_mesh`` asserts; 2 of 3 ranks), and
    several ranks without ``--tp-backend``. (tests/test_torch_train_tp.py
    trains over 2 ranks.)"""
    argv = ["--synthetic", "1", "--size", "tiny", "--device", "cpu", "--steps", "1"]
    if how == "model_parallel":
        argv += ["--model-parallel", "2"]
        reason = "--model-parallel 2 does not divide WORLD_SIZE 1"
    elif how == "world_size":
        argv += ["--model-parallel", "2", "--tp-backend", "gloo"]
        monkeypatch.setenv("WORLD_SIZE", "3")
        reason = "--model-parallel 2 does not divide WORLD_SIZE 3"
    else:
        monkeypatch.setenv("WORLD_SIZE", "2")
        reason = "needs --tp-backend"
    with pytest.raises(SystemExit, match="TP training") as e:
        cli.main(argv)
    assert reason in str(e.value)
    if how == "model_parallel":
        proc = subprocess.run([sys.executable, "-m", "dots_ocr_tpu_torch.train.cli", *argv],
                              env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
                              text=True, timeout=120, cwd=REPO)
        assert proc.returncode != 0 and reason in proc.stderr


def test_cli_needs_data_or_synthetic():
    with pytest.raises(SystemExit, match="--data or --synthetic"):
        cli.main(["--size", "tiny", "--device", "cpu", "--steps", "1"])
