"""The per-layer metrics read from the program's own spans and counters
(`perfbench/program_spans.py`): a traced run of the weekend cell and of both
season cells on the CPU at a small size, as `test_perfbench_faults.py` runs
them, reads each of its new metrics; the untraced line carries none; a
program without the recorder gives nothing, and nothing raises."""

from __future__ import annotations

import dataclasses
import functools
import math

import pytest
import torch

from monte_carlo_gp_torch.models import bayesian
from monte_carlo_gp_torch.utils import profiling
from perfbench import harness, program_spans, spec, world

SMALL = {"n_simulations": 1024, "check_units": 1}
# a short fit, for the program and the reference alike: on the CPU the
# profile records every operation of the eager chains, ~10^6 of them per
# fit at the configuration's budget
SHORT_FIT = {"warmup": 4, "samples": 4, "leapfrog": 2}
# a season of a few races: on the CPU the profile records every operation of
# the race kernel's plain version, ~10^5 a race
SEASON_RACES = 4
WEEKEND = ("elo_s.weekend", "archive_s.weekend", "quali_s.weekend", "practice_s.weekend")
SEASON = ("elo_s.season", "archive_s.season", "quali_s.season", "parquet_reads.season")


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def short_season(monkeypatch):
    """Worlds whose seasons have `SEASON_RACES` races."""
    monkeypatch.setattr(world.synthetic, "SyntheticBackend", functools.partial(
        world.synthetic.SyntheticBackend, n_events=SEASON_RACES))


def _listed(workload: str) -> set[str]:
    return {m["name"] for m in spec.find_cell(harness.ROOT, workload).per_layer}


def _run(workload: str, seed: int, trace: bool = True, **small):
    line, _, run = harness.run_cell(workload, seed, 0.1, trace, device="cpu",
                                    overrides={**SMALL, **small})
    return line, run


def _finite(line: dict, names) -> dict[str, float]:
    values = {n: line["metrics"][n]["value"] for n in names}
    assert all(math.isfinite(v) and v >= 0 for v in values.values()), values
    return values


def test_the_weekend_cell_reads_the_prepare_phases():
    line, run = _run("weekend.elo.1m", 31)
    assert set(WEEKEND) <= _listed("weekend.elo.1m")
    values = _finite(line, WEEKEND)
    assert values["elo_s.weekend"] > 0 and values["archive_s.weekend"] > 0
    # the phases lie inside the harness span around predictor and prepare
    phases = sum(values.values())
    prepare = line["metrics"]["prepare_s.weekend"]["value"]
    assert 0.5 * prepare < phases <= prepare
    assert line["metrics"]["device_idle_pct.weekend"]["value"] >= 0
    untraced, _ = _run("weekend.elo.1m", 31, trace=False)
    assert set(untraced["metrics"]) == {"weekend_s", "setup_s"}


def test_the_elo_season_cell_reads_its_phases_and_no_fit(short_season):
    line, run = _run("season.elo", 32, n_simulations=128)
    assert set(SEASON) <= _listed("season.elo") and "fit_ms.season" not in _listed("season.elo")
    values = _finite(line, SEASON)
    assert values["elo_s.season"] > 0 and values["parquet_reads.season"] > 0
    assert spec.metric_reader("fit_ms.season")(run) is None
    assert sum(values[n] for n in SEASON if n.endswith("_s.season")) <= (
        line["metrics"]["prepare_s.season"]["value"])


def test_the_bayesian_season_cell_reads_its_fits(monkeypatch, short_season):
    monkeypatch.setattr(bayesian, "BayesianQualiModel", functools.partial(
        bayesian.BayesianQualiModel, num_warmup=SHORT_FIT["warmup"],
        num_samples=SHORT_FIT["samples"]))
    monkeypatch.setattr(bayesian, "sample_posterior", functools.partial(
        bayesian.sample_posterior, num_leapfrog=SHORT_FIT["leapfrog"]))
    find_cell = spec.find_cell

    def short_fit(root, name, *args):
        cell = find_cell(root, name, *args)
        return dataclasses.replace(cell, config={**cell.config,
                                                 "fit": {**cell.config["fit"], **SHORT_FIT}})

    monkeypatch.setattr(spec, "find_cell", short_fit)
    line, run = _run("season.bayes", 33, n_simulations=128)
    assert set(SEASON) | {"fit_ms.season"} <= _listed("season.bayes")
    values = _finite(line, (*SEASON, "fit_ms.season"))
    assert values["fit_ms.season"] > 0
    fits = program_spans.span_seconds(run, ("fit",))
    assert len(fits) == SEASON_RACES * len(run.units)  # one fit per race
    # the fits run inside the qualifying phase
    assert values["quali_s.season"] >= 1e-3 * values["fit_ms.season"] * SEASON_RACES


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    """The parent of this benchmark's metrics has no recorder: every new
    reader returns None there, and none raises."""
    run = harness.Run(cell=spec.find_cell(harness.ROOT, "season.bayes"), seed=1, seconds=0.1,
                      trace=True, t0=0.0, units=[{}])
    monkeypatch.delattr(profiling, "RECORDER")
    for name in (*WEEKEND, *SEASON, "fit_ms.season"):
        assert spec.metric_reader(name)(run) is None, name
