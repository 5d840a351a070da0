"""``admit_overlap_share.snap``'s reader on hand-made spans (CPU).

    python -m pytest gpubench/tests/test_admit_overlap.py -q
"""

import pytest

from gpubench import run
from gpubench.record import RunRecord
from gpubench.tests.test_program_spans import (  # noqa: F401
    ARCH,
    DIMS,
    SERVING,
    _span,
    _trace,
    recorder,
)

read = run.reader("admit_overlap_share.snap")


def _record(counters, spans_ok=True):
    trace = _trace([("k", 0, 10)], 1.0)
    return RunRecord(dims=DIMS, serving=SERVING, mix={}, t0=0.0, t1=10.0, counters0={},
                     counters1=counters, requests=[], arch=ARCH, trace=trace,
                     trace_edges=(0.0, 1.0) if spans_ok else None)


def test_share_of_admissions_beside_a_chunk(recorder):  # noqa: F811
    ms = 1_000_000
    d = _span(recorder, "dispatch", 0, ms)
    _span(recorder, "admit", 2 * ms, 3 * ms, chunked=False, beside=d.id)
    _span(recorder, "admit", 4 * ms, 5 * ms, chunked=False, beside=None)  # before the trace
    _span(recorder, "admit", 6 * ms, 7 * ms, chunked=False)
    _span(recorder, "admit", 8 * ms, 9 * ms, chunked=True)
    _span(recorder, "admit", 2 * 10**9, 3 * 10**9, chunked=False, beside=d.id)  # after it
    assert read(_record({"admits_beside_chunk": 2})) == pytest.approx(50.0)


def test_silent_on_a_program_without_it(recorder):  # noqa: F811
    _span(recorder, "admit", 0, 10, chunked=False)
    assert read(_record({"prefills": 1})) is None  # an older program: no counter
    assert read(_record({"admits_beside_chunk": 0}, spans_ok=False)) is None
