"""The architecture lookup (``arch/<arch>.py``) on the CPU: the dots.ocr
module gives the pinned readings of ``golden.py``, its reference side loads
nothing of the program, and a new architecture comes in as new files only.

    python -m pytest gpubench/tests/test_arch.py -q
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpubench import check, run, work
from gpubench.tests import golden
from gpubench.tests.helpers import DATA, tiny_cell

DOTSOCR = run.load_arch("dotsocr")
TINY = run.load_json(os.path.join(DATA, "configs", "tiny.json"))
FLAGSHIP = run.load_json(os.path.join(run.ROOT, "gpubench", "configs", "dotsocr-w8a16.json"))

CLONE = '''"""An architecture that is dots.ocr under another name."""
from gpubench.arch.dotsocr import (  # noqa: F401
    decoder_linear_shapes, generated_flops, kv_bytes_per_token, make_weights,
    program_config, prompt_flops, prompt_ids, served_gaps, serve_params, vision_flops)
'''

LOADS = """
import json, sys
import numpy as np, torch
from gpubench import run
arch = run.load_arch("dotsocr")
tiny = run.load_json(sys.argv[1])
dims = tiny["model"]
w = arch.make_weights(dims, 7, "cpu", torch.float32, tiny["weights"])
arch.served_gaps(w, dims, "int8", np.zeros((56, 56, 3), np.uint8), "x", [1, 2])
arch.prompt_flops(10, dims), arch.generated_flops(1, 10, dims), arch.vision_flops(16, dims)
arch.kv_bytes_per_token(dims, "bf16"), arch.decoder_linear_shapes(dims)
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] == "dots_ocr_tpu_torch")))
"""


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("seed", sorted(golden.LEAF_SHA256))
def test_weights_are_the_pinned_bits(seed):
    w = DOTSOCR.make_weights(TINY["model"], seed, "cpu", torch.float32, TINY["weights"])
    got = {p: hashlib.sha256(x.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
           for p, x in _leaves(w)}
    assert list(got) == list(golden.LEAF_SHA256[seed])  # vision first, then the decoder
    assert got == golden.LEAF_SHA256[seed]


@pytest.fixture
def one_thread():
    """The pinned gaps were read on one thread: a float32 sum split over
    more threads rounds differently."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_served_gaps_are_the_pinned_gaps(quantize, one_thread):
    dims = TINY["model"]
    w = DOTSOCR.make_weights(dims, 7, "cpu", torch.bfloat16, TINY["weights"])
    rng_seed, shape = golden.PAGE
    pixels = np.random.default_rng(rng_seed).integers(0, 256, shape, dtype=np.uint8)
    gaps = DOTSOCR.served_gaps(w, dims, quantize, pixels, golden.PROMPT, golden.SERVED)
    assert gaps.tolist() == golden.GAPS[quantize]
    assert len(DOTSOCR.prompt_ids(golden.PROMPT, 6, dims)) == golden.PROMPT_LEN


def test_flagship_counts_are_the_pinned_counts():
    dims = FLAGSHIP["model"]
    assert {p: DOTSOCR.vision_flops(p, dims) for p in golden.VISION_FLOPS} == golden.VISION_FLOPS
    assert {t: DOTSOCR.prompt_flops(t, dims) for t in golden.PROMPT_FLOPS} == golden.PROMPT_FLOPS
    assert {k: DOTSOCR.generated_flops(*k, dims)
            for k in golden.GENERATED_FLOPS} == golden.GENERATED_FLOPS
    assert {k: DOTSOCR.kv_bytes_per_token(dims, k)
            for k in golden.KV_BYTES_PER_TOKEN} == golden.KV_BYTES_PER_TOKEN
    assert run.page_bytes(run.Cell("w8a16.snap-ocr")) == golden.PAGE_BYTES
    linears = DOTSOCR.decoder_linear_shapes(dims)
    assert {r: work.w8a16_prefill_bound(r, dims, linears)
            for r in golden.W8A16_PREFILL_BOUND} == golden.W8A16_PREFILL_BOUND
    assert {r: work.w8a16_decode_bound(r, dims, linears)
            for r in golden.W8A16_DECODE_BOUND} == golden.W8A16_DECODE_BOUND


def test_the_reference_side_loads_nothing_of_the_program():
    proc = subprocess.run([sys.executable, "-c", LOADS, os.path.join(DATA, "configs", "tiny.json")],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def _root_with(tmp_path, arch: str, module: str = None):
    """A copy of the tiny cells' root with one more configuration (``arch``)
    and a cell on it, made of new files and entries only; ``module`` is the
    text of a new ``gpubench/arch/<arch>.py``."""
    root = tmp_path / "root"
    shutil.copytree(DATA, root)
    if module is not None:
        (root / "gpubench" / "arch").mkdir(parents=True)
        (root / "gpubench" / "arch" / f"{arch}.py").write_text(module)
    cfg = dict(TINY, name=arch, arch=arch)
    (root / "configs" / f"{arch}.json").write_text(json.dumps(cfg))
    shutil.copy(root / "cells" / "tiny.snap-ocr.json", root / "cells" / f"{arch}.snap-ocr.json")
    bench = run.load_json(root / "BENCHMARK.json")
    bench["configs"].append(dict(bench["configs"][0], name=arch, file=f"configs/{arch}.json"))
    bench["workloads"].append({"name": f"{arch}.snap-ocr", "config": arch,
                               "traffic": "tiny-snap", "chips": 1, "why": "CPU tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


def test_an_architecture_comes_in_as_new_files(tmp_path):
    root = _root_with(tmp_path, "clone", CLONE)
    cell = run.Cell("clone.snap-ocr", root=root, here=root, arch_root=root)
    assert cell.arch.__file__ == os.path.join(root, "gpubench", "arch", "clone.py")
    torch.set_num_threads(2)
    out = run.run_cell(cell, 2**31 + 17, 2.0, False, "cpu")
    assert out["correct"], out["checked"]
    # the same run held to the reference through dots.ocr's own module reads the same
    record, totals = out["record"], out["info"]["counters"]
    via_clone, _ = check.check(cell, record, totals, 2**31 + 17, torch.device("cpu"),
                               torch.float32)
    via_dotsocr, _ = check.check(tiny_cell("tiny.snap-ocr"), record, totals, 2**31 + 17,
                                 torch.device("cpu"), torch.float32)
    assert via_clone == via_dotsocr
    assert {k: v for k, v in out["checked"].items() if k != "window_graph_captures"} == via_clone
    assert out["info"]["gap_tokens"] >= 4


def test_an_unknown_architecture_names_the_missing_file(tmp_path):
    root = _root_with(tmp_path, "nosuch")
    with pytest.raises(SystemExit) as err:
        run.Cell("nosuch.snap-ocr", root=root, here=root, arch_root=root)
    assert os.path.join(root, "gpubench", "arch", "nosuch.py") in str(err.value)


def test_a_module_without_the_contract_is_refused(tmp_path):
    root = _root_with(tmp_path, "partial", "from gpubench.arch.dotsocr import make_weights\n")
    with pytest.raises(SystemExit) as err:
        run.Cell("partial.snap-ocr", root=root, here=root, arch_root=root)
    assert "served_gaps" in str(err.value) and "program_config" in str(err.value)
