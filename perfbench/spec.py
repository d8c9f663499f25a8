"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix; each
lives in a file of its own: `configs/<config>.json`, `traffic/<traffic>.json`,
and the cell's correctness limits in `cells/<cell>.json`. A per-layer metric
is read by `metrics/<metric>.py`. A later change adds a cell, configuration,
traffic mix or metric by adding such files and entries; nothing here names
one.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")


class SpecError(ValueError):
    """`BENCHMARK.json` or a file it names is missing or malformed."""


def check_name(value: str, what: str) -> str:
    if not isinstance(value, str) or not NAME.fullmatch(value):
        raise SpecError(f"{what} {value!r} is not a name (letters, digits, _ . -; at most 64)")
    return value


def check_unit(value: str) -> str:
    if not isinstance(value, str) or not UNIT.fullmatch(value):
        raise SpecError(f"unit {value!r} is not 1-16 of letters, digits, _ / % . -")
    return value


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


def _listed(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except (OSError, ValueError) as e:
        raise SpecError(f"cannot read {path}: {e}") from e


def load_benchmark(root: Path) -> dict:
    bench = load_json(root / "BENCHMARK.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench.get(key, []):
            check_name(entry["name"], key[:-1])
    for entry in bench["end_to_end"] + bench["per_layer"]:
        check_unit(entry["unit"])
    return bench


def find_cell(root: Path, name: str, base: Path = HERE) -> Cell:
    """The cell `name` of `root`'s BENCHMARK.json, with its files (under
    `base`, the benchmark's folder) read."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    check_name(w["config"], "config")
    check_name(w["traffic"], "traffic")
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(base / "traffic" / f"{w['traffic']}.json")
    limits = load_json(base / "cells" / f"{name}.json")
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config=config,
        traffic=traffic,
        limits=limits,
        end_to_end=[m for m in bench["end_to_end"] if _listed(m, name)],
        per_layer=[m for m in bench["per_layer"] if _listed(m, name)],
    )


def metric_reader(name: str, base: Path = HERE):
    """The `read(run)` function of `metrics/<name>.py`."""
    import importlib.util

    path = base / "metrics" / f"{check_name(name, 'metric')}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    if spec is None or not path.exists():
        raise SpecError(f"no reader {path} for metric {name!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
