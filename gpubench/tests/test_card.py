"""On the card: one short run of a cell, its result line as the contract
shapes it. Skips without an NVIDIA GPU.

    python -m pytest gpubench/tests/test_card.py -q     # on the card
"""

import json
import subprocess
import sys

import pytest

from gpubench import run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")


@pytest.mark.cuda
def test_a_short_snapshot_run_prints_the_contract_line(card):
    proc = subprocess.run([sys.executable, "-m", "gpubench.run", "--workload", "w8a16.snap-ocr",
                           "--seed", str(2**31 + 99), "--seconds", "5", "--trace", "0"],
                          cwd=run.ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(out)[-1] == "checked"
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert set(out["metrics"]) == {"tok_s", "setup_s"}
