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
    assert all(callable(getattr(cell.arch, f)) for f in run.CONTRACT)
    assert set(cell.config["control"]) <= set(cell.config["serving"])


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


CONFIGS = sorted(os.listdir(os.path.join(run.ROOT, "gpubench", "configs")))


def _differences(model: dict, published: dict, path=()):
    """Dotted paths of ``published``'s numbers that ``model`` does not hold."""
    for key, want in published.items():
        got = model.get(key) if isinstance(model, dict) else None
        if isinstance(want, dict):
            yield from _differences(got, want, path + (key,))
        elif got != want:
            yield ".".join(path + (key,))


def _exempt(path: str, reduced) -> bool:
    """``reduced`` names the key, its dotted path or a group it lies in."""
    parts = path.split(".")
    return bool(set(reduced) & ({parts[-1]} | {".".join(parts[:i])
                                               for i in range(1, len(parts) + 1)}))


@pytest.mark.parametrize("name", [f[:-len(".json")] for f in CONFIGS])
def test_configs_keep_the_published_widths(name):
    """Each configuration file's ``model`` holds every width its source
    publishes (its ``published``), except where BENCHMARK.json's ``reduced``
    for it names the key; and its architecture builds the program's config."""
    path = f"gpubench/configs/{name}.json"
    cfg = run.load_json(os.path.join(run.ROOT, path))
    entry = [c for c in BENCH["configs"] if c["file"] == path]
    reduced = entry[0]["reduced"] if entry else []
    assert cfg["name"] == name and cfg["published"]
    assert [p for p in _differences(cfg["model"], cfg["published"])
            if not _exempt(p, reduced)] == []
    assert run.load_arch(cfg["arch"]).program_config(cfg["model"]) is not None


def test_reduced_names_a_key_its_path_or_its_group():
    published = {"decoder": {"num_layers": 61, "hidden_size": 64}, "vision": {"num_layers": 42}}
    model = {"decoder": {"num_layers": 7, "hidden_size": 64}, "vision": {"num_layers": 42}}
    assert list(_differences(model, published)) == ["decoder.num_layers"]
    assert list(_differences({"decoder": {}}, published)) == [
        "decoder.num_layers", "decoder.hidden_size", "vision.num_layers"]
    assert all(_exempt("decoder.num_layers", r) for r in (
        ["num_layers"], ["decoder.num_layers"], ["decoder"]))
    assert not any(_exempt("decoder.num_layers", r) for r in ([], ["vision"], ["hidden_size"]))


def test_names_and_limits_of_the_file():
    names = [x["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[sec]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(len(x) <= 200 and "\n" not in x for x in layers)
