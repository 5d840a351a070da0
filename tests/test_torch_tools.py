"""The port's copies of the JAX package's tool modules, on the CPU:
``utils/shipping.py``, ``utils/observability.py``, ``engine/spec_sim.py``
and ``models/init.py``'s ``zeros_params`` / ``count_params``.

The JAX package's own tests of these modules are replayed on the port:
:func:`replay` executes a JAX test file with every ``dots_ocr_tpu`` import
rewritten to ``dots_ocr_tpu_torch`` and returns its tests and fixtures,
which a test file binds under new names. :func:`twin_calls` then routes
every public function of a copied module through a wrapper that also calls
the JAX module's function on a deep copy of the same arguments and requires
the same result (or the same exception), so each replayed test also holds
the copy's outputs equal to the JAX module's.

``tests/test_spec_realism.py``'s pin of the simulator against the device
program runs here on the port's ``ContinuousBatchingEngine`` (a bigram
model through the engine with speculation on): its ``spec_*`` counters and
tokens must equal the simulator's prediction exactly.
"""

import copy
import dataclasses
import json
import logging
import math
import os
import pkgutil
import random
import re
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import dots_ocr_tpu_torch
from dots_ocr_tpu.engine import spec_sim as jax_spec_sim
from dots_ocr_tpu.models import init as jax_init
from dots_ocr_tpu.models.config import DotsOCRConfig as JaxConfig
from dots_ocr_tpu.utils import shipping as jax_shipping
from dots_ocr_tpu_torch.engine import spec_sim
from dots_ocr_tpu_torch.engine.scheduler import ContinuousBatchingEngine, SchedulerConfig
from dots_ocr_tpu_torch.models.config import DotsOCRConfig
from dots_ocr_tpu_torch.models.init import count_params, zeros_params
from dots_ocr_tpu_torch.utils import observability, shipping

TESTS = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# Replaying a JAX test file on the port, and twin calls
# ---------------------------------------------------------------------------


def _is_fixture(obj) -> bool:
    return (getattr(obj, "_fixture_function_marker", None) is not None
            or hasattr(obj, "_pytestfixturefunction"))


def replay(name: str, only=None) -> dict:
    """``tests/<name>.py`` executed with its ``dots_ocr_tpu`` imports
    rewritten to the port, as {binding name: object}: each test function
    ``test_x`` as ``test_<file>__x``, each class ``TestX`` as
    ``Test_<file>__X``, fixtures under their own names. ``only`` limits the
    tests and classes to those names. The module is kept in sys.modules
    as ``torch_replay_<name>``."""
    path = os.path.join(TESTS, name + ".py")
    with open(path, encoding="utf-8") as f:
        src = re.sub(r"\bdots_ocr_tpu\b(?!_torch)", "dots_ocr_tpu_torch", f.read())
    mod = types.ModuleType(f"torch_replay_{name}")
    mod.__file__ = path
    sys.modules[mod.__name__] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    short = name[len("test_"):]
    out = {}
    for key, obj in vars(mod).items():
        if _is_fixture(obj):
            out[key] = obj
        elif only is not None and key not in only:
            continue
        elif key.startswith("test_") and callable(obj):
            out[f"test_{short}__{key[len('test_'):]}"] = obj
        elif key.startswith("Test") and isinstance(obj, type):
            out[f"Test_{short}__{key[len('Test'):]}"] = obj
    return out


def plain(x):
    """A comparable form of a result: containers recursively, objects by
    type name and attributes, images and arrays by bytes."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, Image.Image):
        return ("image", x.mode, x.size, x.tobytes())
    if isinstance(x, np.ndarray):
        return ("array", str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, (set, frozenset)):
        return sorted(map(repr, x))
    if isinstance(x, type) or callable(x):
        return x
    slots = [s for cls in type(x).__mro__ for s in getattr(cls, "__slots__", ())]
    if slots:
        return (type(x).__name__, {s: plain(getattr(x, s, None)) for s in slots})
    if hasattr(x, "__dict__"):
        return (type(x).__name__, plain(vars(x)))
    return x


def twin(port_fn, jax_fn, name: str):
    def call(*args, **kwargs):
        jax_args = copy.deepcopy((args, kwargs))
        try:
            out = port_fn(*args, **kwargs)
        except Exception as e:  # the JAX function must raise the same
            with pytest.raises(Exception) as info:
                jax_fn(*jax_args[0], **jax_args[1])
            assert (type(info.value).__name__, str(info.value)) == (type(e).__name__, str(e)), name
            raise
        ref = jax_fn(*jax_args[0], **jax_args[1])
        assert plain(out) == plain(ref), f"{name}: the port's copy and the JAX module differ"
        return out

    call.twinned = port_fn
    return call


def twin_calls(monkeypatch, pairs, replays=(), skip=()):
    """Route every public module-level function of each port module in
    ``pairs`` ([(port module, JAX module)]) through :func:`twin`, in the
    module and wherever a replayed test module bound it by name."""
    for port_mod, jax_mod in pairs:
        for name, fn in list(vars(port_mod).items()):
            if (name.startswith("_") or name in skip or not isinstance(fn, types.FunctionType)
                    or fn.__module__ != port_mod.__name__ or not hasattr(jax_mod, name)):
                continue
            wrapped = twin(fn, getattr(jax_mod, name), f"{port_mod.__name__}.{name}")
            monkeypatch.setattr(port_mod, name, wrapped)
            for mod in replays:
                for key, value in list(vars(mod).items()):
                    if value is fn:
                        monkeypatch.setattr(mod, key, wrapped)


@pytest.fixture(scope="module")
def module_patch():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


# ---------------------------------------------------------------------------
# shipping
# ---------------------------------------------------------------------------

globals().update(replay("test_shipping", only=(
    "test_env_file_parses_and_matches_fallback",
    "test_shipping_values_are_the_r3_verdict_resolution")))


@pytest.fixture(autouse=True, scope="module")
def _twins(module_patch):
    twin_calls(module_patch, [(shipping, jax_shipping), (spec_sim, jax_spec_sim)],
               replays=[sys.modules["torch_replay_test_shipping"],
                        sys.modules["torch_replay_test_spec_realism"]],
               skip=("bigram_decoder_params",))


def test_shipping_reads_the_same_file():
    assert shipping._DEFAULT_PATH == jax_shipping._DEFAULT_PATH
    assert os.path.exists(shipping._DEFAULT_PATH)
    assert shipping._FALLBACK == jax_shipping._FALLBACK


@pytest.mark.parametrize("mode", ["config", "full", "windowed"])
def test_apply_vision_policy_matches_jax(mode):
    ship = dict(shipping.shipping_config(), VISION_ATTN=mode)
    for make in ("flagship", "tiny"):
        got = shipping.apply_vision_policy(getattr(DotsOCRConfig, make)(), ship)
        want = jax_shipping.apply_vision_policy(getattr(JaxConfig, make)(), ship)
        assert dataclasses.asdict(got.vision) == dataclasses.asdict(want.vision)


def test_shipping_config_from_another_file(tmp_path):
    env = tmp_path / "ship.env"
    env.write_text("# a comment\nQUANTIZE=int4\n\nSPECULATE_K = 3\nnot a setting\n")
    assert shipping.shipping_config(str(env))["QUANTIZE"] == "int4"
    assert shipping.shipping_config(str(tmp_path / "missing.env")) == shipping._FALLBACK


# ---------------------------------------------------------------------------
# observability
# ---------------------------------------------------------------------------


def test_setup_logging_idempotent():
    observability.setup_logging()
    n = len(logging.getLogger().handlers)
    observability.setup_logging()
    assert len(logging.getLogger().handlers) == n
    assert sum(getattr(h, "_dots_ocr", False) for h in logging.getLogger().handlers) == 1


def test_profile_trace(tmp_path):
    with observability.profile_trace(None):
        x = torch.ones(4).sum()
    assert float(x) == 4.0
    log_dir = tmp_path / "trace"
    with observability.profile_trace(str(log_dir)):
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(log_dir / files[0]) as f:
        trace = json.load(f)
    assert trace["traceEvents"], "the Chrome trace holds no event"


# ---------------------------------------------------------------------------
# zeros_params / count_params
# ---------------------------------------------------------------------------


def _jax_tree_items(tree, prefix=""):
    out = []
    for k, v in tree.items():
        out += _jax_tree_items(v, f"{prefix}{k}.") if isinstance(v, dict) else [(prefix + k, v)]
    return out


def test_zeros_params_match_jax():
    want = dict(_jax_tree_items(jax.tree.map(np.asarray, jax_init.zeros_params(JaxConfig.tiny()))))
    got = dict(_jax_tree_items(zeros_params(DotsOCRConfig.tiny(), CPU)))
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
        assert (t.numpy() == (1.0 if "norm" in name.split(".")[-1] else 0.0)).all(), name


@pytest.mark.parametrize("size", ["tiny", "small", "flagship"])
def test_count_params_matches_jax(size):
    specs = jax_init.param_specs(getattr(JaxConfig, size)())
    want = jax_init.count_params(specs)
    got = count_params(zeros_params(getattr(DotsOCRConfig, size)(), torch.device("meta")))
    assert got == want
    if size == "flagship":
        assert 2.7e9 < got < 2.9e9
    bf16 = zeros_params(getattr(DotsOCRConfig, size)(), torch.device("meta"))
    assert bf16["decoder"]["embed"].dtype == getattr(DotsOCRConfig, size)().torch_dtype


# ---------------------------------------------------------------------------
# spec_sim: the simulator's own cases, and its pin against the port's engine
# ---------------------------------------------------------------------------

globals().update(replay("test_spec_realism", only=(
    "TestSimulator", "test_simulator_speedup_fields")))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_simulator_matches_jax_on_streams(k):
    rng = random.Random(k)
    for length in (2, 17, 300):
        stream = [rng.randint(1, 6) for _ in range(length)]
        assert plain(spec_sim.simulate_greedy_spec(stream, k)) == plain(
            jax_spec_sim.simulate_greedy_spec(stream, k))


def _bigram_setup(cycle_len=40, vocab=320, seed=1):
    """tests/test_spec_realism.py's bigram model: the config, the table,
    and both packages' parameters for it."""
    cfgs = []
    for cfg_cls in (DotsOCRConfig, JaxConfig):
        cfg = cfg_cls.tiny(vocab_size=vocab)
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, vocab_size=vocab, hidden_size=vocab, tie_word_embeddings=False))
        cfgs.append(cfg)
    rng = random.Random(seed)
    cycle = rng.sample(list(range(33, 127)), cycle_len)
    table = {c: cycle[0] for c in range(vocab)}
    for i, c in enumerate(cycle):
        table[c] = cycle[(i + 1) % cycle_len]
    return cfgs[0], table, cfgs[1]


@pytest.fixture(scope="module")
def bigram():
    cfg, table, _ = _bigram_setup()
    return cfg, spec_sim.bigram_decoder_params(cfg, table, device=CPU), table


def test_bigram_params_match_jax():
    cfg, table, jax_cfg = _bigram_setup()
    got = dict(_jax_tree_items(spec_sim.bigram_decoder_params(cfg, table, device=CPU)))
    want = dict(_jax_tree_items(jax.tree.map(
        np.asarray, jax_spec_sim.bigram_decoder_params(jax_cfg, table))))
    assert set(got) == set(want)
    for name, t in got.items():
        np.testing.assert_array_equal(t.numpy(), want[name], err_msg=name)
    with pytest.raises(ValueError, match="untied"):
        spec_sim.bigram_decoder_params(DotsOCRConfig.tiny(), table, device=CPU)


def _engine(cfg, params, spec_k, depth):
    return ContinuousBatchingEngine(
        params, cfg, CPU,
        sched=SchedulerConfig(
            num_pages=64, page_size=8, max_slots=4, max_pages_per_seq=32,
            prompt_bucket_step=32, vision_bucket_step=16, steps_per_sync=depth,
            max_steps_per_sync=depth, speculate_k=spec_k,
            spec_min_tokens_per_iter=0.0,  # isolate from the EWMA gate
            repetition_min_repeats=0,
        ),
    )


def test_bigram_model_walks_the_table(bigram):
    cfg, params, table = bigram
    eng = _engine(cfg, params, spec_k=0, depth=2)
    text = eng.generate_one("walk", temperature=0.0, max_new_tokens=30)
    ids = [ord(ch) for ch in text]
    assert len(ids) == 30
    for a, b in zip(ids, ids[1:]):
        assert table[a] == b, f"{a}->{b} not the table successor {table[a]}"


@pytest.mark.parametrize("spec_k,depth,budget", [(3, 4, 64), (2, 2, 48), (5, 3, 96)])
def test_device_metrics_match_simulator(bigram, spec_k, depth, budget):
    """tests/test_spec_realism.py:155-190 on the port's engine."""
    cfg, params, table = bigram
    want = _engine(cfg, params, spec_k=0, depth=depth).generate_one(
        "pin me", temperature=0.0, max_new_tokens=budget)
    eng = _engine(cfg, params, spec_k=spec_k, depth=depth)
    got = eng.generate_one("pin me", temperature=0.0, max_new_tokens=budget)
    assert got == want, "speculative output diverged from sequential greedy"

    start = ord(want[0])
    stream = [start] + spec_sim.bigram_chain(table, start, budget + depth * (spec_k + 1) * 4)
    sim = spec_sim.simulate_greedy_spec(stream, spec_k)
    # The host chunk loop of tests/test_spec_realism.py, with one
    # difference of the port's verify program: a row stops at its budget
    # (the JAX program runs every iteration of the chunk and counts the
    # overshoot), so each iteration emits the simulator's count cut at the
    # tokens the budget has left.
    host_total, dev_total, chunks, idx = 1, 0, 0, 0
    while host_total < budget:
        group = sim.per_iter[idx : idx + depth]
        assert len(group) == depth, "simulated stream too short"
        idx += depth
        for emitted in group:
            emitted = min(emitted, budget - host_total)
            dev_total += emitted
            host_total += emitted
        chunks += 1
    assert eng.metrics["spec_chunks"] == chunks
    assert eng.metrics["spec_slot_iters"] == chunks * depth
    assert eng.metrics["spec_emitted"] == dev_total
    assert math.isclose(sim.emitted_per_iter, sum(sim.per_iter) / sim.num_iters)


# ---------------------------------------------------------------------------
# The import scan covers every module ported here
# ---------------------------------------------------------------------------


def test_new_modules_are_in_the_import_scan():
    """tests/test_torch_imports.py imports every module pkgutil finds in
    the port and scans every source file for jax / dots_ocr_tpu imports:
    these modules are among them."""
    found = {m.name for m in pkgutil.walk_packages(dots_ocr_tpu_torch.__path__,
                                                   "dots_ocr_tpu_torch.")}
    new = {"train.train_step", "train.checkpoint", "train.cli", "batch.jobs",
           "batch.script_engine", "ui.callbacks", "eval.metrics", "eval.end2end", "eval.elo",
           "eval.omnidocbench", "eval.svg", "utils.observability", "utils.shipping",
           "engine.spec_sim"}
    assert {f"dots_ocr_tpu_torch.{m}" for m in new} <= found


def test_twins_are_active():
    assert shipping.shipping_config.twinned is not None
    assert spec_sim.simulate_greedy_spec.twinned is not None
    replayed = sys.modules["torch_replay_test_spec_realism"]
    assert replayed.simulate_greedy_spec is spec_sim.simulate_greedy_spec
