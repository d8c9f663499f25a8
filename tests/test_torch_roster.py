"""The 2026 grid of 11 teams and 22 cars as the benchmark's cell
`serve.elo.2026.1m` holds it: the port's season-keyed synthetic world
against the frozen generator (seasons 2024 and 2025, frame for frame) and
the entry-list reference (`perfbench/reference/roster.py`, 2026), the
Abu Dhabi 2026 fp2 plan against the reference's at no gap, the port's
counts against the reference's plain race, the race kernels' slot
arithmetic, the cell's readers, and its files found by name.
"""

import dataclasses
import math
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.data import synthetic
from monte_carlo_gp_torch.data.loader import F1DataLoader
from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.ops import race_kernel as rk
from perfbench import compare, harness, roofline, spec, trace
from perfbench.drivers import serve_field
from perfbench.reference import race as ref_race
from perfbench.reference import roster
from perfbench.reference import run as ref_run
from perfbench.reference import synthetic as ref_synthetic

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CELL = "serve.elo.2026.1m"
SEASON, RACE, POINT = 2026, "Abu Dhabi", "fp2"
WORLD_SEED, SIMS, SIM_SEED = 2_147_483_911, 2_000, 7
SESSIONS = ("FP1", "FP2", "FP3", "Q", "SQ", "S", "R")
METRICS = ("race_kernel_roofline.serve2026", "slot_fill_pct.serve2026")
# The port's plain race and the reference's frozen copy of it run the same
# float32 operations in the same order on the CPU: the counts agree exactly.
# None may differ; the bfloat16 reference moves hundreds of the 2,000.
COUNT_ATOL = 0


def _frames(backend, season: int):
    """Every laps and results frame of the season, by (event, session)."""
    for event in synthetic.CALENDAR:
        for session in SESSIONS:
            yield (event, session, "laps"), backend.load_laps(season, event, session)
            yield (event, session, "results"), backend.load_results(season, event, session)


def _assert_same_frames(port, ref, season: int) -> int:
    n = 0
    for (key, got), (_, want) in zip(_frames(port, season), _frames(ref, season)):
        if want is None:
            assert got is None, key
            continue
        pd.testing.assert_frame_equal(got, want, check_exact=True, obj=str(key))
        n += 1
    return n


@pytest.mark.parametrize("season", [2024, 2025])
def test_seasons_without_an_entry_list_are_the_frozen_world(season):
    """Bitwise every frame of the frozen generator, which the plan fixture,
    the frozen reference world and the JAX comparisons are made from."""
    assert season not in synthetic.ENTRY_LISTS
    port = synthetic.SyntheticBackend(seed=WORLD_SEED)
    assert _assert_same_frames(port, ref_synthetic.SyntheticBackend(seed=WORLD_SEED), season) > 200


def test_2026_fields_the_entry_list_of_the_reference():
    entry_list = synthetic.ENTRY_LISTS[SEASON]
    assert len(entry_list) == 22 and len(set(entry_list.values())) == 11
    assert all(list(entry_list.values()).count(t) == 2 for t in entry_list.values())
    assert set(entry_list) - set(cfg.DRIVER_TEAMS) == {"LIN", "COL", "PER", "BOT"}
    assert set(cfg.DRIVER_TEAMS) - set(entry_list) == {"TSU", "DOO"}
    assert set(entry_list.values()) - set(cfg.DRIVER_TEAMS.values()) == {"Audi", "Cadillac"}
    assert spec.find_cell(ROOT, CELL).config["entry_list"] == entry_list
    port = synthetic.SyntheticBackend(seed=WORLD_SEED)
    ref = roster.RosterBackend(WORLD_SEED, {SEASON: entry_list})
    assert _assert_same_frames(port, ref, SEASON) > 200
    fp2 = port.load_laps(SEASON, RACE, "FP2")
    assert fp2.groupby("Driver", sort=False)["Team"].first().to_dict() == entry_list
    assert port.load_results(SEASON, RACE, "R")["Abbreviation"].nunique() == 22


def test_an_entry_list_leaves_the_earlier_draws_alone(monkeypatch):
    """A newcomer's skill and a new team's pace come from generators of
    their own: another list for 2026 moves no frame of 2025."""
    base = synthetic.SyntheticBackend(seed=5, n_events=2)
    want = base.load_laps(2025, "Bahrain", "FP2")
    monkeypatch.setitem(synthetic.ENTRY_LISTS, 2026, {"XXX": "Nowhere", "VER": "Red Bull"})
    other = synthetic.SyntheticBackend(seed=5, n_events=2)
    pd.testing.assert_frame_equal(other.load_laps(2025, "Bahrain", "FP2"), want,
                                  check_exact=True)
    assert other.load_laps(2026, "Bahrain", "FP2")["Driver"].unique().tolist() == ["XXX", "VER"]


def test_the_bahrain_2024_plan_fixture_is_unchanged(tmp_path):
    want = np.load(ROOT / "tests" / "data" / "torch_plan_bahrain2024.npz")
    pred = F1Predictor(cache_dir=tmp_path, backend=synthetic.SyntheticBackend(seed=2718),
                       device="cpu")
    plan = pred.prepare_weekend(2024, "Bahrain")
    got = {f.name: getattr(plan.params, f.name).cpu().numpy()
           for f in dataclasses.fields(plan.params)}
    got["total_laps"], got["drivers"] = np.int64(plan.total_laps), np.array(plan.drivers)
    assert sorted(got) == sorted(want.files)
    for name in want.files:
        if name == "grid_probs":  # float32 Elo sums, as tests/test_torch_predictor.py holds it
            np.testing.assert_allclose(got[name], want[name], rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.fixture(scope="module")
def world():
    made = serve_field.RosterWorld(WORLD_SEED, [SEASON - 1, SEASON],
                                   {SEASON: synthetic.ENTRY_LISTS[SEASON]})
    yield made
    made.close()


@pytest.fixture(scope="module")
def plans(world):
    pred = F1Predictor(cache_dir=world.cache_dir, offline=True, device="cpu")
    plan = pred.prepare_weekend(SEASON, RACE, prediction_point=POINT)
    return pred, plan, ref_run.weekend_plan(world.cache_dir, SEASON, RACE, POINT, "elo", "cpu")


def test_the_2026_plan_equals_the_reference(world, plans):
    _, plan, (_, ref_plan) = plans
    assert plan.drivers == ref_plan.drivers == list(synthetic.ENTRY_LISTS[SEASON])
    assert plan.total_laps == ref_plan.total_laps == 58
    assert compare.plan_gap(plan, ref_plan) == 0.0
    assert compare.grid_gap(plan, ref_plan) == 0.0
    frame = F1DataLoader(cache_dir=world.cache_dir, offline=True).load_session(
        SEASON, RACE, "FP2")
    teams = frame.groupby("Driver")["Team"].first()
    assert len(teams) == 22 and teams.nunique() == 11
    # the team DNF rates come from the static 2025 map, as upstream's do
    rate = dict(zip(plan.drivers, plan.params.team_dnf_rate.tolist()))
    assert rate["HAD"] == pytest.approx(cfg.DEFAULT_DNF_RATES["Racing Bulls"])
    assert rate["LAW"] == pytest.approx(cfg.DEFAULT_DNF_RATES["Red Bull"])
    assert all(rate[d] == pytest.approx(0.002) for d in ("LIN", "COL", "PER", "BOT"))


def test_the_counts_equal_the_reference_plain_race(plans):
    pred, plan, (_, ref_plan) = plans
    got = np.rint(pred.simulate_plan(plan, SIMS, seed=SIM_SEED) * SIMS).astype(np.int64)
    want = np.rint(ref_race.finish_probs(ref_plan.params, ref_plan.total_laps, SIMS, SIM_SEED,
                                         "cpu") * SIMS).astype(np.int64)
    assert got.shape == (22, 22) and (got.sum(1) == SIMS).all()
    assert np.abs(got - want).max() <= COUNT_ATOL
    low_plan = ref_run.lowp_plan(ref_plan)
    low = np.rint(ref_race.finish_probs(low_plan.params, low_plan.total_laps, SIMS, SIM_SEED,
                                        "cpu", lowp=True) * SIMS).astype(np.int64)
    assert np.abs(low - want).max() > COUNT_ATOL + 100


def test_slot_counts_at_22_drivers_on_one_simulation_a_warp():
    assert rk.kernel_tier(22) == (1, 1)
    cars, slots = rk.slot_counts(rk.kernel_tier(22), [22], 1 << 20)
    assert (cars, slots) == (22 << 20, 32 << 20)
    assert 100 * cars / slots == 68.75


def test_slot_counts_at_20_drivers_on_the_packed_instance():
    assert rk.kernel_tier(20) == (2, 3)
    cars, slots = rk.slot_counts(rk.kernel_tier(20), [20], 3 * 1000)
    assert (cars, slots) == (60_000, 1000 * 64)
    assert 100 * cars / slots == 93.75
    # a last warp that holds one simulation of three still issues all 64 slots
    assert rk.slot_counts((2, 3), [20], 3001) == (60_020, 1001 * 64)


@pytest.mark.parametrize("fields, tier, fill", [
    ((32, 26, 24, 21), (1, 1), 103 / 128),  # padded to 32: season_kernel<1>
    ((20, 18, 6), (2, 3), 44 / (3 * 64 / 3)),  # padded to 20: the packed instance
    ((80, 64, 40, 20), (3, 1), 204 / (4 * 96)),  # padded to 80: three cars a lane
])
def test_slot_counts_of_a_padded_season(fields, tier, fill):
    assert rk.kernel_tier(max(fields)) == tier
    cars, slots = rk.slot_counts(tier, list(fields), 3 * 4096)
    assert cars == 3 * 4096 * sum(fields)
    assert cars / slots == pytest.approx(fill, rel=1e-12)


def _run(**work) -> harness.Run:
    run = harness.Run(cell=spec.find_cell(ROOT, CELL), seed=1, seconds=1.0, trace=True, t0=0.0)
    run.work = {"requests": 4, "drivers": 22, "n_simulations": 1 << 20, "laps": 58, **work}
    return run


def test_the_cell_metrics_read_the_window():
    run = _run(kernels={"cars": 4 * (22 << 20), "slots": 4 * (32 << 20), "packed": 0})
    kernel_s = 4 * 0.066
    run.device_trace = trace.DeviceTrace(busy_s=kernel_s, window_s=1.0, kernel_s={
        "void race_kernel<1>(float const*, float const*)": kernel_s, "other": 9.0})
    read = {m: spec.metric_reader(m)(run) for m in METRICS}
    bound = roofline.bound_s(roofline.race_flops(22, 58, 1 << 20), roofline.race_bytes(22))
    assert bound == pytest.approx(1.343e-3, rel=1e-3)
    assert read["race_kernel_roofline.serve2026"] == pytest.approx(100 * 4 * bound / kernel_s)
    assert read["slot_fill_pct.serve2026"] == 68.75
    assert all(math.isfinite(v) for v in read.values())


def test_the_cell_metrics_read_nothing_without_their_sources():
    """A program without the counters (the parent of these metrics), or a
    window with no kernel, reads None, and nothing raises."""
    run = _run(kernels=None)
    run.device_trace = trace.DeviceTrace(busy_s=0.0, window_s=1.0, kernel_s={"x": 1.0})
    assert all(spec.metric_reader(m)(run) is None for m in METRICS)
    assert serve_field.kernel_counts({"ok": 1}, {"ok": 2}) is None
    assert serve_field.kernel_counts({"kernels": {"cars": 1, "slots": 2, "packed": 0}},
                                     {"kernels": {"cars": 5, "slots": 9, "packed": 0}}) == {
        "cars": 4, "slots": 7, "packed": 0}


def test_the_cell_is_found_by_name():
    cell = spec.find_cell(ROOT, CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "f1-2026-elo" and cell.config["drivers"] == 22
    assert cell.config["calendar_laps"] == {
        c: int(cfg.circuit_info(c)["laps"]) for c in synthetic.CALENDAR}
    assert cell.traffic["kind"] == "serve_field" and cell.traffic["season"] == SEASON
    assert (cell.traffic["race"], cell.traffic["prediction_point"]) == (RACE, POINT)
    assert cell.traffic["n_simulations"] == 1 << 20 and cell.traffic["check_units"] == 3
    assert set(cell.limits) == {"body"}
    assert {m["name"] for m in cell.end_to_end} == {"request_p95_ms", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(METRICS)
    for m in cell.per_layer:
        assert m["moves"] == "request_p95_ms" and m["layer"] == "kernels"
        assert callable(spec.metric_reader(m["name"]))
    kind = harness.driver(cell.traffic["kind"])
    assert kind is serve_field
    assert callable(kind.measure) and callable(kind.check) and callable(kind.control)


def test_the_check_runs_the_reference_in_exact_float32(monkeypatch):
    """`serve_field`'s check and control are `serve`'s, with TF32 off around
    them and the process's settings restored after."""
    seen = []

    def record(run):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return []

    monkeypatch.setattr(serve_field.serve, "check", record)
    monkeypatch.setattr(serve_field.serve, "control", record)
    before = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        serve_field.check(None)
        serve_field.control(None)
        assert seen == [(False, False)] * 2
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
