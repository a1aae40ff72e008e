"""BENCHMARK.json keeps to its contract, and every cell and metric in it
resolves to its files by name."""
import json
import os
import re

import pytest

from perfbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = core.benchmark()


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
        assert word == "python3" or word.startswith("perfbench/")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_resolves(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"])
    assert entry["file"].startswith("perfbench/configs/")
    config = core.load_json(os.path.join(core.ROOT, entry["file"]))
    assert config["name"] == entry["name"]
    core.runner(config)
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    for text in (entry["why"], entry["source"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(cell[key])
    assert cell["chips"] in (1, 4)
    assert 1 <= len(cell["why"]) <= 200
    files = core.cell_files(BENCH, cell["name"])
    core.generator(files["traffic"])
    for check in files["checks"].values():
        assert check["op"] in ("<=", ">=")
    reported = core.metrics_of(BENCH, cell["name"], trace=False)
    names = {m["name"] for m in reported}
    assert "setup_s" in names and len(names) >= 2
    assert core.metrics_of(BENCH, cell["name"], trace=True)


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_and_units(metric):
    assert NAME.match(metric["name"])
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", [])) <= cells


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_bounds(metric):
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    read = core.metric_reader(metric["name"])
    assert read({}) is None
    for cell in metric["workloads"]:
        moved = {m["name"] for m in core.metrics_of(BENCH, cell, trace=False)}
        assert metric["moves"] in moved


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_layer_is_one_short_line(metric):
    assert 1 <= len(metric["layer"]) <= 200
    assert "\n" not in metric["layer"] and "\t" not in metric["layer"]
