"""``ttft_p95_ms.snap``'s reader on hand-made records (CPU): the first-token
tail of the requests due in the window, and in a traced run of those due
before the trace starts, since reading the trace holds the host."""

import pytest

from gpubench import run
from gpubench.record import Request, RunRecord

read = run.reader("ttft_p95_ms.snap")


def record(edges):
    # 100 requests due 0.1 s apart: the first 70 wait 10-200 ms, the last 30 wait 1 s
    requests = []
    for k in range(100):
        due = k * 0.1
        wait = 1.0 if k >= 70 else 0.01 * (k % 20 + 1)
        requests.append(Request(spec=None, due=due, first_token_at=due + wait))
    return RunRecord(dims={}, serving={}, mix={}, t0=0.0, t1=10.0, counters0={}, counters1={},
                     requests=requests, arch=None, trace_edges=edges)


def test_an_untraced_run_reads_every_request_due_in_the_window():
    assert read(record(None)) == pytest.approx(1000.0)


def test_a_traced_run_reads_the_requests_due_before_the_trace():
    # 70 requests: the nearest-rank 95th is the 67th, 190 ms (three read 200 ms)
    assert read(record((6.95, 8.95))) == pytest.approx(190.0)
