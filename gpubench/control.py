"""The correctness check's control, run apart from the benchmark: a cell
served with the program's own weight path one step below the
configuration's (int8 weights -> the int4 path, bf16 -> the int8 path),
its served tokens held to the same reference at the configuration's own
precision. The configuration's ``control`` names the serving keys it
replaces: each part one step below the configuration's precision, on the
program's own path for it (bf16 decoder weights -> W8A16, int8 -> int4
(W4A16), the bf16 vision tower -> W8A8; the decoder's step alone does not
move the bf16 configuration's served tokens past what the bf16 encoder's
own rounding moves them: PERF.md). Each seed runs in its own process.

    python3 -m gpubench.control --workload w8a16.pdf-batch --seeds 11,12,13 --seconds 20

Prints one JSON line a seed: the numbers the check compares (the greedy and
the sampled requests' gaps), and what was compared. The control must read at least three times what sound
runs of the program read (PERF.md gives both and the limit between them).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from gpubench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=20.0)
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    if len(seeds) > 1:
        for seed in seeds:
            subprocess.run([sys.executable, "-m", "gpubench.control", "--workload", args.workload,
                            "--seeds", str(seed), "--seconds", str(args.seconds)], check=False)
        return 0
    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("gpubench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = run.Cell(args.workload)
    lower = cell.config["control"]
    out = run.run_cell(cell, seeds[0], args.seconds, False, "cuda", control=lower)
    out.pop("record")
    print(json.dumps({"workload": cell.name, "seed": seeds[0], "control": lower,
                      "correct": out["correct"], "checked": out["checked"],
                      "gap_stats": {k: v for k, v in out["info"].items() if "gap_" in k},
                      "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
