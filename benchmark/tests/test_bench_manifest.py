"""BENCHMARK.json against the benchmark's contract: names, units, keys,
cells, the metrics each cell reports and the files found by name."""

import json
import os
import re

import pytest

from benchmark import harness
from benchmark.tests.tinyroot import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest(REPO)


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert manifest["command"][:2] == ["python3", "benchmark/run.py"] and len(manifest["command"]) <= 32
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) < 64 * 1024


def test_names_units_and_keys(manifest):
    names = []
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert 1 <= len(c["source"]) <= 200 and all(NAME.match(k) for k in c["reduced"])
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        names.append(w["name"])
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in manifest["end_to_end"]}


def test_every_metric_moves_a_metric_its_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [m for m in manifest["end_to_end"] if cell in m.get("workloads", cells)]
        assert len(reported) >= 2 and any(m["name"] == "setup_s" for m in reported)
        assert any(cell in m.get("workloads", cells) for m in manifest["per_layer"])


def test_files_found_by_name(manifest):
    used = set()
    for w in manifest["workloads"]:
        _cell, config, mix, _e2e, per_layer = harness.find_cell(REPO, manifest, w["name"])
        assert config["width"] == 1920 and config["height"] == 1080 and config["samples"] == 1
        used.add(w["config"])
        for m in per_layer:
            reader = harness.load_metric(REPO, m["name"])
            assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
                m["layer"], m["unit"], m["source"], m["moves"])
    assert used == {c["name"] for c in manifest["configs"]}
    files = [c["file"] for c in manifest["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("benchmark/") for f in files)
    for c in manifest["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]


def test_run_seconds_fit_a_full_check(manifest):
    # 2 + 14 runs a cell for 24 cells, each run_seconds + 60, 180 s a cell to
    # compile and 1200 s spare, within 43200 s.
    assert (2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
