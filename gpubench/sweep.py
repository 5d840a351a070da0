"""Find the rate an open-loop cell sustains: run it at each offered rate in
turn (one process, a fresh engine a rate) and print, per rate, the tails
and whether the backlog grew.

    python3 -m gpubench.sweep --workload w8a16.snap-ocr --rates 6,9,12,15 --seconds 20 --seed 5

A rate is sustained when the requests due in the window's last third wait
in the queue about as long as those of its first third, and few due
requests are still without a first token when the window closes. The cell's
mix then takes about four fifths of the highest such rate.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

from gpubench import run
from gpubench.record import median, percentile


def summary(record) -> dict:
    due = record.due_in_window()
    third = (record.t1 - record.t0) / 3.0

    def queue(lo, hi):
        return median([(r.admitted_at - r.due) * 1e3 for r in due
                       if lo <= r.due - record.t0 < hi and r.admitted_at is not None])

    ttft = [(r.first_token_at - r.due) * 1e3 for r in due if r.first_token_at is not None]
    e2e = [(r.finished_at - r.due) * 1e3 for r in due
           if r.finished_at is not None and r.error is None]
    return {"requests": len(due),
            "ttft_p50_ms": median(ttft), "ttft_p95_ms": percentile(ttft, 95), "e2e_p95_ms": percentile(e2e, 95),
            "queue_first_third_ms": queue(0, third), "queue_last_third_ms": queue(2 * third, 3 * third),
            "backlog_at_close": sum(1 for r in due if r.first_token_at is None
                                    or r.first_token_at > record.t1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests per second")
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    rates = [float(r) for r in args.rates.split(",")]
    if len(rates) > 1:  # one process a rate: each starts with the whole card
        for rate in rates:
            subprocess.run([sys.executable, "-m", "gpubench.sweep", "--workload", args.workload,
                            "--rates", str(rate), "--seconds", str(args.seconds),
                            "--seed", str(args.seed)], check=False)
        return 0
    run.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("gpubench.sweep: no CUDA device", file=sys.stderr)
        return 2
    cell = run.Cell(args.workload)
    cell.mix = dict(cell.mix, rate_per_s=rates[0])
    out = run.run_cell(cell, args.seed, args.seconds, False, "cuda", check=False)
    row = {"rate_per_s": rates[0], **summary(out.pop("record")),
           "counters": out["info"]["counters"]}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
