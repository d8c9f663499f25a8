"""`packed_races.sweep`, the races of the kernels' packed instance per sweep
(`perfbench/metrics/packed_races.sweep.py`): read from the program's
`race.packed` counter in a traced window, None where the program never
counted it or keeps no recorder, and listed for the sweep cell alone."""

from __future__ import annotations

import time

from torch.profiler import ProfilerActivity, profile

from monte_carlo_gp_torch.utils import profiling
from perfbench import harness, spec

CELL, METRIC = "sweep.elo.1m", "packed_races.sweep"


def _run(units: int) -> harness.Run:
    return harness.Run(cell=spec.find_cell(harness.ROOT, CELL), seed=1, seconds=0.1,
                       trace=True, t0=time.perf_counter(), units=[{}] * units)


def test_it_reads_the_counter_per_sweep():
    run = _run(3)
    read = spec.metric_reader(METRIC)
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("tune.configs")
        assert read(run) is None  # events, but no packed launch
        for _ in range(30):
            profiling.count("race.packed", 20)
    assert read(run) == 200


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    run = _run(1)
    monkeypatch.delattr(profiling, "RECORDER")
    assert spec.metric_reader(METRIC)(run) is None


def test_it_is_listed_for_the_sweep_cell_alone():
    for cell in spec.load_benchmark(harness.ROOT)["workloads"]:
        listed = {m["name"] for m in spec.find_cell(harness.ROOT, cell["name"]).per_layer}
        assert (METRIC in listed) == (cell["name"] == CELL), cell["name"]
    (entry,) = [m for m in spec.load_benchmark(harness.ROOT)["per_layer"] if m["name"] == METRIC]
    assert entry["layer"] == "kernels" and entry["moves"] == "season_s"
