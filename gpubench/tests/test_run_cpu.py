"""The harness end to end on the CPU, on DotsOCRConfig.tiny's sizes through
the program's EngineWorker: a sound run comes out correct, the control and
each planted fault do not, and nothing of JAX is loaded. The measuring command
itself refuses to run without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gpubench import run
from gpubench.tests.helpers import DATA, tiny_cell, tiny_run

NO_JAX = """
import sys, json
from gpubench import run
from gpubench.tests.helpers import tiny_run
out = tiny_run("tiny.snap-ocr", seconds=1.0)
bad = run.forbidden_modules()
print(json.dumps({"correct": out["correct"], "bad": bad}))
"""


@pytest.mark.parametrize("workload", ["tiny.pdf-batch", "tiny.snap-ocr"])
def test_a_sound_run_is_correct(workload):
    out = tiny_run(workload)
    assert out["correct"], out["checked"]
    assert out["checked"]["served_gap"]["value"] == 0.0
    assert out["checked"]["served_gap_mean"]["value"] == 0.0
    assert out["checked"]["prompt_len_gap"]["value"] == 0
    assert out["checked"]["token_count_gap"]["value"] == 0
    assert out["info"]["gap_tokens"] >= 4
    # the sampled requests: the draw at temperature 0.1 keeps close to the top token
    assert out["info"]["sampled_gap_tokens"] >= 4
    assert out["checked"]["sampled_gap_mean"]["value"] <= out["checked"]["sampled_gap_mean"]["limit"]
    assert out["checked"]["sampled_gap"]["value"] <= out["checked"]["sampled_gap"]["limit"]
    assert "setup_s" in out["metrics"]
    assert list(out)[-1] == "checked"


def test_traced_runs_read_the_counters_and_stamps():
    out = tiny_run("tiny.pdf-batch", traced=True)
    assert out["correct"]
    assert out["metrics"]["preemptions.batch"]["value"] == 0
    assert out["metrics"]["mfu.batch"]["value"] > 0
    out = tiny_run("tiny.snap-ocr", traced=True)
    assert out["correct"]
    assert out["metrics"]["queue_ms.snap"]["value"] > 0
    assert out["metrics"]["mfu.snap"]["value"] > 0


def test_the_control_is_not_correct():
    # the configuration's control: the program's int8 weights and W8A8 vision,
    # held to the float32 reference
    control = tiny_cell("tiny.snap-ocr").config["control"]
    assert control == {"QUANTIZE": "int8", "VISION_QUANTIZE": "int8"}
    out = tiny_run("tiny.snap-ocr", control=control)
    assert not out["correct"]
    assert out["checked"]["served_gap"]["value"] > out["checked"]["served_gap"]["limit"]


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    from dots_ocr_tpu_torch.engine import scheduler

    draw = scheduler.sample_logits

    def altered(*args, **kwargs):
        return (draw(*args, **kwargs) + 1) % 512

    monkeypatch.setattr(scheduler, "sample_logits", altered)
    out = tiny_run("tiny.pdf-batch")
    assert not out["correct"]
    assert out["checked"]["served_gap"]["value"] > out["checked"]["served_gap"]["limit"]


@pytest.mark.parametrize("workload", ["tiny.pdf-batch", "tiny.snap-ocr"])
def test_a_draw_altered_for_sampled_rows_only_is_caught(monkeypatch, workload):
    # the Gumbel-max draw serves only rows with a temperature above 0 (greedy
    # rows take the argmax), so this fault leaves the greedy requests sound
    from dots_ocr_tpu_torch.engine import sampling

    draw = sampling.gumbel_argmax

    def altered(logits, *args, **kwargs):
        return (draw(logits, *args, **kwargs) + 1) % logits.shape[-1]

    monkeypatch.setattr(sampling, "gumbel_argmax", altered)
    out = tiny_run(workload)
    assert not out["correct"]
    assert out["checked"]["served_gap"]["value"] == 0.0
    assert out["checked"]["sampled_gap_mean"]["value"] > out["checked"]["sampled_gap_mean"]["limit"]


def test_no_jax_is_loaded():
    proc = subprocess.run([sys.executable, "-c", NO_JAX], cwd=run.ROOT, capture_output=True,
                          text=True, timeout=600)
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "bad": []}


def test_the_command_fails_without_a_card():
    proc = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "w8a16.snap-ocr",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=run.ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_the_command_fails_beside_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(run.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(run.ROOT, "gpubench"), tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "w8a16.snap-ocr",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert proc.returncode != 0
    assert not proc.stdout.strip()


def test_the_data_folder_is_complete():
    assert sorted(os.listdir(os.path.join(DATA, "cells"))) == ["tiny.pdf-batch.json",
                                                              "tiny.snap-ocr.json"]
