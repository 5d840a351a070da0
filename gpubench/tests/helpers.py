"""Shared set-up of the benchmark's CPU tests: the tiny configuration and
mixes in ``data/`` (DotsOCRConfig.tiny's sizes, a few callers, small pages)."""

import os

import torch

from gpubench import run

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def tiny_cell(workload: str) -> run.Cell:
    return run.Cell(workload, root=DATA, here=DATA)


def tiny_run(workload: str, seed: int = 2**31 + 17, seconds: float = 2.0, traced: bool = False,
             control=None) -> dict:
    torch.set_num_threads(2)
    out = run.run_cell(tiny_cell(workload), seed, seconds, traced, "cpu", control=control)
    out.pop("record")
    return out
