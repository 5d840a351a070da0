"""The traffic generator: deterministic by seed, the same work for every
seed (stratified draws), the closed loop's fixed first block."""

import json
import os
from collections import Counter

from gpubench.loadgen import Traffic, max_requests
from gpubench.run import ROOT, load_json

MIXES = os.path.join(ROOT, "gpubench", "traffic")
DIMS = load_json(os.path.join(ROOT, "gpubench", "configs", "dotsocr-w8a16.json"))["model"]


def mix(name):
    return load_json(os.path.join(MIXES, name + ".json"))


def specs(m, seed, n, first=0):
    t = Traffic(m, seed, DIMS)
    return [t.request(i, first_of_caller=i < first) for i in range(n)]


def test_same_seed_same_requests_and_pixels():
    m = mix("snap-ocr")
    a, b = Traffic(m, 2**31 + 5, DIMS), Traffic(m, 2**31 + 5, DIMS)
    for i in range(20):
        ra, rb = a.request(i), b.request(i)
        assert ra == rb
        assert (a.pixels(ra) == b.pixels(rb)).all()
    assert a.gaps(50) == b.gaps(50)


def test_other_seeds_reorder_the_same_sizes():
    m = mix("pdf-batch")
    n = 3 * m["strata"]
    budgets = [Counter(r.max_new_tokens for r in specs(m, s, n)) for s in (1, 2)]
    areas = [sorted(Traffic(m, s, DIMS)._log_uniform("megapixels", i) for i in range(n))
             for s in (1, 2)]
    order = [[r.patches for r in specs(m, s, n)] for s in (1, 2)]
    assert budgets[0] == budgets[1] and areas[0] == areas[1]
    assert order[0] != order[1]


def test_open_loop_gaps_are_exponential_quantiles():
    m = mix("snap-ocr")
    g1, g2 = Traffic(m, 1, DIMS).gaps(m["strata"]), Traffic(m, 2, DIMS).gaps(m["strata"])
    assert sorted(g1) == sorted(g2) and g1 != g2
    mean = sum(g1) / len(g1)
    assert abs(mean * m["rate_per_s"] - 1.0) < 0.02  # the mean gap is 1 / rate


def test_an_open_run_sends_one_block_whatever_the_seed():
    # the window's requests: the same gaps, sizes and budgets for every
    # seed, all due inside the window, in an order the seed draws
    m = mix("snap-ocr")
    seconds = load_json(os.path.join(ROOT, "BENCHMARK.json"))["run_seconds"]
    n = max_requests(m, seconds)
    assert n == m["requests"] == m["strata"]
    gaps = [Traffic(m, s, DIMS).gaps(n) for s in (5, 2**31 + 7)]
    assert sorted(gaps[0]) == sorted(gaps[1]) and gaps[0] != gaps[1]
    assert sum(gaps[0]) < seconds
    # "rotate": one fixed order, started where the seed says
    start = gaps[1].index(gaps[0][0])
    assert gaps[1][start:] + gaps[1][:start] == gaps[0]
    reqs = [[Traffic(m, s, DIMS).request(i) for i in range(n)] for s in (5, 2**31 + 7)]
    rolled = reqs[1][start:] + reqs[1][:start]
    assert [(r.patches, r.max_new_tokens, r.greedy) for r in rolled] == \
        [(r.patches, r.max_new_tokens, r.greedy) for r in reqs[0]]
    for what in ("megapixels", "aspect", "max_new_tokens"):
        drawn = [sorted(Traffic(m, s, DIMS)._log_uniform(what, i) for i in range(n))
                 for s in (5, 2**31 + 7)]
        assert drawn[0] == drawn[1]


def test_closed_loop_first_block_is_the_same_for_every_seed():
    m = mix("pdf-batch")
    callers = m["callers"]
    a, b = specs(m, 10, callers, first=callers), specs(m, 11, callers, first=callers)
    assert [(r.patches, r.max_new_tokens) for r in a] == [(r.patches, r.max_new_tokens) for r in b]
    # each first request stands somewhere uniformly inside its budget: on
    # average at half of it
    whole = sum(r.max_new_tokens for r in specs(m, 10, callers)) / callers
    first = sum(r.max_new_tokens for r in a) / callers
    assert 0.3 * whole < first < 0.7 * whole


def test_pages_are_on_the_grid_and_in_range():
    for name in ("pdf-batch", "snap-ocr"):
        m = mix(name)
        for r in specs(m, 3, 64):
            assert r.height % 28 == 0 and r.width % 28 == 0
            mp = r.height * r.width / 1e6
            assert m["megapixels"]["low"] * 0.8 <= mp <= m["megapixels"]["high"] * 1.2
            assert r.vision_tokens * 4 == r.patches
        greedy = [r for r in specs(m, 3, 64) if r.greedy]
        assert len(greedy) == 64 // m["greedy_every"]


def test_mix_files_parse():
    for f in os.listdir(MIXES):
        assert json.load(open(os.path.join(MIXES, f)))["loop"] in ("open", "closed")
