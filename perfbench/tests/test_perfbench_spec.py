"""BENCHMARK.json against the benchmark's contract, and a cell, a
configuration, a traffic mix and a metric added as files alone."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

from perfbench import harness, spec

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
LINE = 200


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= LINE and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(BENCH) == TOP_KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert _one_line(word) and not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    spec.check_name(entry["name"], "config")
    assert _one_line(entry["source"]) and _one_line(entry["why"])
    assert entry["file"].startswith("perfbench/") and (ROOT / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        spec.check_name(key, "reduced key")
    assert json.loads((ROOT / entry["file"]).read_text())["name"] == entry["name"]


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda e: e["name"])
def test_workload_entry(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        spec.check_name(entry[key], key)
    assert entry["chips"] in (1, 4) and _one_line(entry["why"])
    cell = spec.find_cell(ROOT, entry["name"])
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    kind = harness.driver(cell.traffic["kind"])
    assert callable(kind.measure) and callable(kind.check) and callable(kind.control)


def test_cells_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    assert len({w["name"] for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("metric", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    spec.check_name(metric["name"], "metric")
    spec.check_unit(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("host_clock", "device_trace")
    assert 0.01 <= metric["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    spec.check_name(metric["name"], "metric")
    spec.check_unit(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert _one_line(metric["layer"])
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    for cell in metric["workloads"]:
        assert "workloads" not in moves or cell in moves["workloads"]
    assert callable(spec.metric_reader(metric["name"]))


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "µs", "x" * 65, ".x"])
def test_bad_names_are_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_name(bad, "name")


@pytest.mark.parametrize("bad", ["", "tokens per second", "x" * 17, "µs"])
def test_bad_units_are_refused(bad):
    with pytest.raises(spec.SpecError):
        spec.check_unit(bad)


def test_a_cell_added_as_files_is_found(tmp_path: Path):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric added as files and entries alone, with no file edited."""
    base = tmp_path / "perfbench"
    for sub in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(spec.HERE / sub, base / sub)
    bench = json.loads(json.dumps(BENCH))
    (base / "configs" / "f1-2024-new.json").write_text(json.dumps({"name": "f1-2024-new",
                                                                    "quali_model": "elo"}))
    (base / "traffic" / "weekend-10k.json").write_text(json.dumps({"kind": "weekend",
                                                                   "n_simulations": 10000}))
    (base / "cells" / "weekend.new.10k.json").write_text(json.dumps({"result": 0.001}))
    (base / "metrics" / "assemble_ms.weekend.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "f1-2024-new", "source": "x", "why": "y", "reduced": [],
                             "file": "perfbench/configs/f1-2024-new.json"})
    bench["workloads"].append({"name": "weekend.new.10k", "config": "f1-2024-new",
                               "traffic": "weekend-10k", "chips": 1, "why": "z"})
    bench["per_layer"].append({"name": "assemble_ms.weekend", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "host prepare",
                               "moves": "weekend_s", "workloads": ["weekend.new.10k"]})
    for m in bench["end_to_end"]:
        if m["name"] == "weekend_s":
            m["workloads"].append("weekend.new.10k")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell(tmp_path, "weekend.new.10k", base=base)
    assert cell.config["name"] == "f1-2024-new"
    assert cell.traffic == {"kind": "weekend", "n_simulations": 10000}
    assert cell.limits == {"result": 0.001}
    assert [m["name"] for m in cell.end_to_end] == ["weekend_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["assemble_ms.weekend"]
    assert spec.metric_reader("assemble_ms.weekend", base=base)(None) == 42.0
    with pytest.raises(spec.SpecError):
        spec.find_cell(tmp_path, "weekend.absent", base=base)
