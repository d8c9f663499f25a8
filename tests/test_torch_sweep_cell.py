"""The event-model sweep as the benchmark's cell `sweep.elo.1m` holds it: the
port's `sweep_backtest` on the CPU against the plain reference
(`perfbench/reference/tune.py`) on the synthetic world's 2024 season with
the documented 3x3 grid, the sweep's spans and counter, the cell's three
per-layer metrics read from a run, and the cell's files found by name.

The world here is the benchmark's own (`perfbench/world.py`) cut to two
races a season: on the CPU each race of each configuration costs about a
second of the plain race simulation, whatever the simulations.
"""

import functools
import math
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.utils.profiling import RECORDER
from monte_carlo_gp_torch.validate.tune import sweep_backtest
from perfbench import harness, roofline, spec, trace
from perfbench import world as bench_world
from perfbench.reference import tune as ref_tune

torch.set_num_threads(2)

SEASON, N_EVENTS, SIMS, SEED = 2024, 2, 2_000, 3
GRID = {"sc_prob": [0.005, 0.01, 0.02], "variance_scale": [0.8, 1.0, 1.25]}
# The program's plain race simulation and the reference's frozen copy of it
# run the same float32 operations in the same order on the CPU, and the
# Briers sum the same probabilities in the same order: the records agree to
# the last bit. The tolerance leaves room for a summation order only; the
# bfloat16 reference moves the win Brier by ~1e-2.
WIN_BRIER_ATOL = 1e-12
# a count of podium places over the races: the same probabilities give the
# same top three
PODIUM_ATOL = 0.0
CELL = "sweep.elo.1m"
METRICS = ("config_ms.sweep", "config_host_ms.sweep", "season_kernel_roofline.sweep")


@pytest.fixture(scope="module")
def world(monkeypatch_module):
    monkeypatch_module.setattr(bench_world.synthetic, "SyntheticBackend", functools.partial(
        bench_world.synthetic.SyntheticBackend, n_events=N_EVENTS))
    made = bench_world.World(11, [SEASON - 1, SEASON])
    yield made
    made.close()


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def _factory(world):
    return lambda: F1Predictor(cache_dir=world.cache_dir, offline=True, device="cpu")


@pytest.fixture(scope="module")
def program(world):
    return sweep_backtest(_factory(world), [SEASON], GRID, seed=SEED, n_simulations=SIMS,
                          verbose=False)


@pytest.fixture(scope="module")
def seasons(world):
    return ref_tune.prepare(world.cache_dir, [SEASON], "elo", "cpu")


@pytest.fixture(scope="module")
def reference(seasons):
    return ref_tune.sweep(seasons, GRID, SEED, SIMS, "cpu")


def test_the_program_sweeps_the_documented_grid(program):
    assert program["n_configs"] == 9 and program["metric"] == "win_brier"
    assert program["default"]["overrides"] == {} and program["default"]["n_races"] == N_EVENTS
    briers = [r["win_brier"] for r in program["results"]]
    assert briers == sorted(briers) and program["best"] is program["results"][0]
    identity = next(r for r in program["results"]
                    if r["overrides"] == {"sc_prob": 0.01, "variance_scale": 1.0})
    assert identity == {**program["default"], "overrides": identity["overrides"]}


def test_the_sweep_equals_its_plain_reference(program, reference):
    assert [r["overrides"] for r in program["results"]] == [
        r["overrides"] for r in reference["results"]]
    assert program["best"]["overrides"] == reference["best"]["overrides"]
    for got, want in zip([program["default"], *program["results"]],
                         [reference["default"], *reference["results"]]):
        assert got["overrides"] == want["overrides"] and got["n_races"] == want["n_races"]
        assert got["pole_brier"] == want["pole_brier"]
        assert abs(got["win_brier"] - want["win_brier"]) <= WIN_BRIER_ATOL, got["overrides"]
        assert abs(got["podium_accuracy"] - want["podium_accuracy"]) <= PODIUM_ATOL


def test_the_bfloat16_reference_fails_the_tolerance(seasons, reference):
    low, _ = ref_tune.evaluate(seasons, {}, SEED, SIMS, "cpu", lowp=True)
    assert low["pole_brier"] == reference["default"]["pole_brier"]
    assert abs(low["win_brier"] - reference["default"]["win_brier"]) > 1e3 * WIN_BRIER_ATOL


def test_the_reference_restores_the_tf32_settings():
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with ref_tune.exact_float32():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def test_the_sweep_records_its_spans_and_counter(world):
    """One `tune.sweep`, one `tune.prepare` a season, one `tune.config`,
    `tune.overrides`, `tune.score` and `backtest.simulate` per configuration
    (the default among them), one `tune.rank`; `tune.configs` counts them.
    Under a profile each span is an event, and the cell's readers take their
    numbers from a run that holds them."""
    grid = {"sc_prob": [0.005, 0.02]}
    before = RECORDER.copy()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]):
        sweep_backtest(_factory(world), [SEASON], grid, seed=SEED, n_simulations=64,
                       verbose=False)
    added = RECORDER.since(before)
    n = len(grid["sc_prob"]) + 1
    counts = added.counts
    assert counts["tune.sweep"] == counts["tune.prepare"] == counts["tune.rank"] == 1
    for name in ("tune.config", "tune.overrides", "tune.score", "backtest.simulate"):
        assert counts[name] == n, name
    assert added.counters["tune.configs"] == n
    assert ("tune.sweep", "tune.prepare", "backtest.prepare") in added.paths
    assert ("tune.sweep", "tune.config", "backtest.simulate", "simulate.readback") in added.paths
    assert ("tune.sweep", "tune.config", "tune.score", "backtest.score") in added.paths

    events = [e for e in RECORDER.events if e.start_ns >= t0 * 1e9]
    configs = [e for e in events if e.name == "tune.config"]
    waits = [e for e in events if e.name == "simulate.readback"]
    assert len(configs) == len(waits) == n
    assert all(w.parent == "backtest.simulate" for w in waits)
    kernel_s = 0.25
    run = harness.Run(cell=spec.find_cell(harness.ROOT, CELL), seed=1, seconds=0.1, trace=True,
                      t0=t0, units=[{}])
    run.device_trace = trace.DeviceTrace(busy_s=kernel_s, window_s=1.0, kernel_s={
        "void season_kernel<1>(float const*, float const*)": kernel_s, "other": 9.0})
    run.work = {"launches": [[(20, 57), (20, 44)]] * n, "n_simulations": 64}
    read = {m: spec.metric_reader(m)(run) for m in METRICS}
    span_ms = [(c.end_ns - c.start_ns) * 1e-6 for c in configs]
    assert read["config_ms.sweep"] == pytest.approx(sum(span_ms) / n)
    own = [ms - sum((w.end_ns - w.start_ns) * 1e-6 for w in waits
                    if c.start_ns <= w.start_ns and w.end_ns <= c.end_ns)
           for c, ms in zip(configs, span_ms)]
    assert read["config_host_ms.sweep"] == pytest.approx(sum(own) / n)
    assert 0 < read["config_host_ms.sweep"] < read["config_ms.sweep"]
    bound = n * sum(roofline.bound_s(roofline.race_flops(20, laps, 64), roofline.race_bytes(20))
                    for laps in (57, 44))
    assert read["season_kernel_roofline.sweep"] == pytest.approx(100 * bound / kernel_s)
    assert all(math.isfinite(v) and v > 0 for v in read.values())


def test_the_readers_read_nothing_without_the_sweep():
    """A run whose program recorded no sweep span (the parent of these
    metrics) and traced no season kernel reads None, and nothing raises."""
    run = harness.Run(cell=spec.find_cell(harness.ROOT, CELL), seed=1, seconds=0.1, trace=True,
                      t0=time.perf_counter() + 1e6, units=[{}])
    run.device_trace = trace.DeviceTrace(busy_s=0.0, window_s=1.0, kernel_s={"x": 1.0})
    run.work = {"launches": [[(20, 57)]], "n_simulations": 64}
    assert all(spec.metric_reader(m)(run) is None for m in METRICS)


def test_the_cell_is_found_by_name():
    cell = spec.find_cell(harness.ROOT, CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "f1-2024-elo-tune"
    assert cell.config["sweep"] == {"grid": GRID, "include_default": True,
                                    "metric": "win_brier", "seasons": [SEASON]}
    assert cell.traffic["kind"] == "sweep" and cell.traffic["n_simulations"] == 1 << 20
    assert cell.traffic["check_units"] == 1
    assert set(cell.limits) == {"pole", "identity", "configs", "order", "result", "scores",
                                "podium"}
    assert {m["name"] for m in cell.end_to_end} == {"season_s", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {*METRICS, "packed_races.sweep"}
    for m in cell.per_layer:
        assert m["moves"] == "season_s" and callable(spec.metric_reader(m["name"]))
    kind = harness.driver(cell.traffic["kind"])
    assert callable(kind.measure) and callable(kind.check) and callable(kind.control)
