"""BENCHMARK.json against the contract's shape, and the harness finding
every configuration, mix, limit and metric reader by name alone."""

import os
import re

import pytest

from gpubench import run

BENCH = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(open(os.path.join(run.ROOT, "BENCHMARK.json"), "rb").read()) <= 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(workload):
    cell = run.Cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.mix["loop"] in ("open", "closed")
    assert cell.limits["served_gap_mean"] > 0
    assert cell.limits["sampled_gap_mean"] > 0  # the draw's requests are held too
    assert set(cell.limits) >= {"check_tokens", "check_requests", "min_compared_tokens"}
    assert cell.workload["chips"] == 1
    assert len(cell.workload["why"]) <= 200
    reported = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.metrics("per_layer")


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader_and_a_valid_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric["name"] != "setup_s":
        assert callable(run.reader(metric["name"]))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "moves" in metric:
        e2e = {m["name"]: m for m in BENCH["end_to_end"]}
        moved = e2e[metric["moves"]]
        assert set(metric["workloads"]) <= set(moved.get("workloads", cells))
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    else:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_keep_the_published_widths(config):
    cfg = run.load_json(os.path.join(run.ROOT, config["file"]))
    v, d = cfg["model"]["vision"], cfg["model"]["decoder"]
    assert (v["hidden_size"], v["num_layers"], v["num_heads"], v["head_dim"],
            v["intermediate_size"]) == (1536, 42, 12, 128, 4224)
    assert (d["hidden_size"], d["num_layers"], d["num_heads"], d["num_kv_heads"], d["head_dim"],
            d["intermediate_size"], d["vocab_size"]) == (1536, 28, 12, 2, 128, 8960, 151936)
    assert config["reduced"] == []
    assert run.program_config(cfg["model"]).decoder.vocab_size == 151936


def test_names_and_limits_of_the_file():
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[sec]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)
