"""The port's data layer (`monte_carlo_gp_torch.data`), the twin of
tests/test_data.py: synthetic backend determinism, the offline disk cache
round trip, season extraction and the three-level Elo cache priority. Where
the JAX package has the same function, the same inputs go through both and
the outputs are equal (frames exactly, ratings to the JAX test's 1e-4).
"""

import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp_torch.data import loader as port_loader
from monte_carlo_gp_torch.data.elo_cache import load_elo, load_with_priority, save_elo
from monte_carlo_gp_torch.data.loader import (
    F1DataLoader,
    extract_quali_results,
    extract_race_results,
)
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.elo import F1EloSystem
from monte_carlo_gp_torch.utils.profiling import RECORDER
from monte_carlo_gp_torch.validate import backtest as port_backtest
from monte_carlo_gp_tpu.data import elo_cache as jax_elo_cache
from monte_carlo_gp_tpu.data import loader as jax_loader
from monte_carlo_gp_tpu.validate import backtest as jax_backtest
from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend as JaxSynthetic

ROOT = Path(__file__).resolve().parents[1]


def test_synthetic_deterministic():
    a = SyntheticBackend(seed=1).load_laps(2024, "Bahrain Grand Prix", "Q")
    b = SyntheticBackend(seed=1).load_laps(2024, "Bahrain Grand Prix", "Q")
    pd.testing.assert_frame_equal(a, b)
    c = SyntheticBackend(seed=2).load_laps(2024, "Bahrain Grand Prix", "Q")
    assert not a["LapTime"].equals(c["LapTime"])
    pd.testing.assert_frame_equal(a, JaxSynthetic(seed=1).load_laps(2024, "Bahrain Grand Prix", "Q"))


def test_synthetic_schedule_and_sessions():
    backend, jax_backend = SyntheticBackend(seed=1), JaxSynthetic(seed=1)
    sched = backend.get_schedule(2024)
    assert len(sched) == 20
    assert any("sprint" in e["EventFormat"] for e in sched)
    assert sched == jax_backend.get_schedule(2024)
    laps = backend.load_laps(2024, "Monaco Grand Prix", "FP2")
    assert {"Driver", "LapTime", "Compound", "LapNumber"} <= set(laps.columns)
    assert laps["Driver"].nunique() == 20
    pd.testing.assert_frame_equal(laps, jax_backend.load_laps(2024, "Monaco Grand Prix", "FP2"))
    res = backend.load_results(2024, "Monaco Grand Prix", "R")
    assert set(res["Position"]) == set(range(1, 21))
    assert (res["Status"] != "Finished").sum() >= 0
    pd.testing.assert_frame_equal(res, jax_backend.load_results(2024, "Monaco Grand Prix", "R"))
    w = backend.load_weather(2024, "Belgium Grand Prix", "R")
    assert w["rainfall"] is True  # Belgium is a wet round in the fixture
    assert w == jax_backend.load_weather(2024, "Belgium Grand Prix", "R")


def test_extract_quali_results_filters_and_sorts():
    laps = pd.DataFrame(
        {
            "Driver": ["A", "A", "B", "B", "C"],
            "LapTime": [90.0, 85.0, 88.0, 86.0, np.nan],
            "IsAccurate": [True, False, True, True, True],
        }
    )
    out = extract_quali_results(laps)
    assert out == [("B", 86.0), ("A", 90.0)]
    assert out == jax_loader.extract_quali_results(laps)


def test_extract_race_results_last_lap():
    laps = pd.DataFrame({"Driver": ["A", "A", "B"], "LapNumber": [1, 2, 1],
                         "Position": [2.0, 1.0, 2.0]})
    assert sorted(extract_race_results(laps)) == [("A", 1), ("B", 2)]
    assert extract_race_results(laps) == jax_loader.extract_race_results(laps)


# -- the Elo build's event lists against the JAX package's pandas forms ---------

WORLD_SEASONS = (2023, 2024)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A two-season synthetic world in the offline parquet cache, read back
    offline as the benchmark's cells and `--offline` users read it."""
    cache_dir = tmp_path_factory.mktemp("world")
    F1DataLoader(cache_dir=cache_dir, backend=SyntheticBackend(seed=11)).build_cache(
        list(WORLD_SEASONS), sessions=("FP2", "Q", "SQ", "S", "R"))
    return cache_dir


def _world_frames(cache_dir):
    """Every Q / SQ / R / S laps frame and Q / R results frame of the world."""
    loader = F1DataLoader(cache_dir=cache_dir, offline=True)
    laps, results = [], []
    for season in WORLD_SEASONS:
        for ev in loader.past_events(season):
            for session in ("Q", "SQ", "R", "S"):
                frame = loader.load_session(season, ev["EventName"], session)
                if not frame.empty:
                    laps.append(frame)
            results += [loader.load_results(season, ev["EventName"], s) for s in ("Q", "R")]
    assert len(laps) == 104 and len(results) == 80
    return laps, results


def _laps(drivers, lap_time, **cols):
    return pd.DataFrame({"Driver": drivers, "LapTime": lap_time, **cols})


def _edge_frames(case):
    """(laps frames, results frames) of one edge case."""
    field = [f"D{i:02d}" for i in range(20)]
    nan = np.nan
    if case == "tied_best_laps":
        rng = np.random.default_rng(3)
        drivers = [d for d in field for _ in range(3)]
        times = rng.choice([88.5, 88.75, 89.0], size=60)
        tied = _laps(drivers, times, IsAccurate=True, LapNumber=np.tile([1, 2, 3], 20),
                     Position=rng.choice([1.0, 2.0, 3.0], size=60))
        all_tied = _laps(field[::-1], np.full(20, 90.0), IsAccurate=True,
                         LapNumber=np.ones(20, np.int64), Position=np.ones(20))
        results = pd.DataFrame({"Abbreviation": field[::-1], "Position": rng.choice(
            [1.0, 1.0, 2.0, 3.0, 3.0, 5.0], size=20)})
        return [tied, all_tied], [results]
    if case == "nan_positions":
        laps = _laps(["A", "A", "A", "B", "B", "C", "C"], [90.0] * 7,
                     LapNumber=[1, 2, 3, 1, 2, 1, 2],
                     Position=[3.0, 2.0, nan, 1.0, 1.0, nan, nan])
        results = pd.DataFrame({"Abbreviation": ["A", "B", "C", "D"],
                                "Position": [2.0, nan, 1.0, nan]})
        none_classified = pd.DataFrame({"Abbreviation": ["A", "B"], "Position": [nan, nan]})
        return [laps], [results, none_classified]
    if case == "lap_numbers":
        rng = np.random.default_rng(5)
        drivers = rng.choice(field, size=400)
        laps_n = rng.integers(1, 12, size=400)  # unsorted, duplicate per driver too
        positions = rng.integers(1, 21, size=400).astype(float)
        unsorted = _laps(drivers, rng.uniform(88, 92, 400), LapNumber=laps_n,
                         Position=positions)
        float_laps = unsorted.assign(LapNumber=np.where(laps_n == 4, nan, laps_n))
        no_lap_number = unsorted.drop(columns="LapNumber")
        return [unsorted, float_laps, no_lap_number], []
    if case == "is_accurate":
        drivers = ["A", "A", "B", "B", "C"]
        times = [90.0, 85.0, 88.0, 86.0, 87.0]
        no_column = _laps(drivers, times, PitInTime=[nan, 1.0, nan, nan, nan])
        all_nan = no_column.assign(IsAccurate=[None] * 5)
        float_nan = no_column.assign(IsAccurate=[nan, 1.0, nan, 0.0, nan])
        return [no_column, all_nan, float_nan], []
    if case == "deleted_and_pits":
        laps = _laps(["A", "A", "A", "B", "B", "B", "C"],
                     [85.0, 86.0, 90.0, 84.0, 88.0, 89.0, 87.0],
                     PitInTime=[nan, nan, nan, nan, 1.0, nan, nan],
                     PitOutTime=[1.0, nan, nan, nan, nan, nan, nan],
                     Deleted=[False, None, True, True, False, nan, False])
        return [laps, laps.drop(columns=["PitInTime"])], []
    if case == "no_valid_lap":
        none_left = _laps(["A", "B", "B", "C"], [86.0, 85.0, 84.0, 87.0],
                          Deleted=[True, True, True, True])
        untimed = _laps(["A", "A", "B", "C", "C"], [nan, nan, 85.0, 87.0, nan],
                        IsAccurate=[True, True, True, True, True])
        nan_driver = untimed.assign(Driver=["A", None, "B", nan, "C"])
        return [none_left, untimed, nan_driver], []
    if case == "fastf1_nullable":
        laps = pd.DataFrame({
            "Driver": pd.array(["VER", "HAM", "VER", "LEC", "HAM", None, "LEC"], "string"),
            "LapTime": pd.array([91.0, 90.5, 90.2, None, 90.5, 89.0, 90.9], "Float64"),
            "LapNumber": pd.array([2, 1, 1, 2, 2, 1, None], "Int64"),
            "IsAccurate": pd.array([True, True, None, True, False, True, True], "boolean"),
            "PitInTime": [nan, nan, 1.0, nan, nan, nan, nan],
            "PitOutTime": np.array([None, 1.0, None, None, None, None, None], object),
            "Deleted": np.array([False, None, False, False, True, False, False], object),
            "Position": pd.array([1.0, 3.0, 2.0, 2.0, None, 4.0, 2.0], "Float64"),
        })
        no_accuracy = laps.assign(IsAccurate=pd.array([None] * 7, "boolean"))
        results = pd.DataFrame({
            "Abbreviation": pd.array(["VER", "HAM", "LEC", "SAI"], "string"),
            "Position": pd.array([2.0, 1.0, None, 3.0], "Float64"),
        })
        return [laps, no_accuracy], [results]
    raise AssertionError(case)


@pytest.mark.parametrize("case", [
    "world", "tied_best_laps", "nan_positions", "lap_numbers", "is_accurate",
    "deleted_and_pits", "no_valid_lap", "fastf1_nullable",
])
def test_event_lists_equal_the_jax_packages(case, request):
    """Every event list the Elo build reads (`extract_quali_results`,
    `extract_race_results`, `get_actual_results`) equals the JAX package's
    pandas form, order, types and ties included."""
    if case == "world":
        laps_frames, result_frames = _world_frames(request.getfixturevalue("world"))
    else:
        laps_frames, result_frames = _edge_frames(case)
    for laps in laps_frames:
        for port, jax in ((extract_quali_results, jax_loader.extract_quali_results),
                          (extract_race_results, jax_loader.extract_race_results)):
            got, want = port(laps), jax(laps)
            assert got == want
            assert [tuple(map(type, e)) for e in got] == [tuple(map(type, e)) for e in want]
    for results in result_frames:
        stub = SimpleNamespace(load_results=lambda season, race, session: results)
        got = port_backtest.get_actual_results(stub, 2024, "race")
        assert got == jax_backtest.get_actual_results(stub, 2024, "race")
    if case == "world":
        assert sum(bool(extract_race_results(f)) for f in laps_frames) == 52


def test_elo_events_counter_and_bitwise_ratings(world, monkeypatch):
    """A fresh predictor's 2024 weekend counts `elo.events` once per event
    list of its two seasons' `load_season_data` (104 on this world), and its
    ratings are bitwise those built from the JAX package's pandas
    extraction. A walk-forward season adds its actuals' non-empty lists."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    def fresh():
        return F1Predictor(cache_dir=world, offline=True, device="cpu")

    loader = F1DataLoader(cache_dir=world, offline=True)
    events = sum(len(lists) for s in WORLD_SEASONS
                 for lists in loader.load_season_data(s).values())
    before = RECORDER.copy()
    numpy_built = fresh()
    numpy_built.prepare_weekend(2024, "Bahrain Grand Prix")
    assert RECORDER.since(before).counters.get("elo.events") == events == 104

    with monkeypatch.context() as m:
        m.setattr(port_loader, "extract_quali_results", jax_loader.extract_quali_results)
        m.setattr(port_loader, "extract_race_results", jax_loader.extract_race_results)
        pandas_built = fresh()
        pandas_built._build_elo(2024)
    for built in (numpy_built, pandas_built):
        built.elo_system.flush()
    assert numpy_built.elo_system.names == pandas_built.elo_system.names
    assert numpy_built.elo_system._ratings.tobytes() == pandas_built.elo_system._ratings.tobytes()

    walk = fresh()
    before = RECORDER.copy()
    _, acts = port_backtest.prepare_season_plans(walk, 2024, verbose=False)
    counted = RECORDER.since(before).counters.get("elo.events")
    first = F1DataLoader(cache_dir=world, offline=True)
    port_backtest._pin(first, port_backtest._race_cutoffs(first, 2024), 0, True)
    expected = sum(len(lists) for s in WORLD_SEASONS
                   for lists in first.load_season_data(s).values())
    expected += sum(bool(a["quali_results"]) + bool(a["race_results"]) for a in acts)
    assert len(acts) == 20
    assert counted == expected == 52 + 2 * 20


def test_loader_offline_cache_roundtrip(tmp_path):
    """The port's loader builds the cache; an offline loader (no backend)
    serves everything from disk, and so does the JAX package's offline
    loader over the same directory: the on-disk format is shared."""
    online = F1DataLoader(cache_dir=tmp_path, backend=SyntheticBackend(seed=3, n_events=3))
    n = online.build_cache([2024], sessions=("FP2", "Q", "R"))
    assert n > 0
    offline = F1DataLoader(cache_dir=tmp_path, offline=True)
    assert offline.backend is None
    laps = offline.load_session(2024, "Bahrain Grand Prix", "Q")
    assert not laps.empty
    sched = offline.get_schedule(2024)
    assert len(sched) == 3
    season = offline.load_season_data(2024)
    assert len(season["qualifying"]) == 3
    assert len(season["races"]) == 3
    w = offline.get_weather(2024, "Bahrain Grand Prix", "R")
    assert "track_temp" in w
    assert offline.load_session(2024, "Bahrain Grand Prix", "FP1").empty
    jax_offline = jax_loader.F1DataLoader(cache_dir=tmp_path, offline=True)
    pd.testing.assert_frame_equal(laps, jax_offline.load_session(2024, "Bahrain Grand Prix", "Q"))
    assert w == jax_offline.get_weather(2024, "Bahrain Grand Prix", "R")


def test_loader_memoizes(tmp_path):
    loader = F1DataLoader(cache_dir=tmp_path, backend=SyntheticBackend(seed=3, n_events=2))
    a = loader.load_session(2024, "Bahrain Grand Prix", "Q")
    b = loader.load_session(2024, "Bahrain Grand Prix", "Q")
    assert a is b


def test_future_events_filtered(tmp_path):
    now = pd.Timestamp("2024-03-20", tz="UTC")
    loader = F1DataLoader(cache_dir=tmp_path, backend=SyntheticBackend(seed=3, n_events=5), now=now)
    past = loader.past_events(2024)
    assert len(past) == 2
    jax = jax_loader.F1DataLoader(cache_dir=tmp_path / "jax",
                                  backend=JaxSynthetic(seed=3, n_events=5), now=now)
    assert past == jax.past_events(2024)


def test_elo_cache_roundtrip_and_priority(tmp_path):
    system = F1EloSystem()
    system.update_race_ratings([("VER", 1), ("NOR", 2), ("LEC", 3)])
    local = tmp_path / "elo_local.json"
    external = tmp_path / "elo_external.json"
    save_elo(system, local, processed_seasons=[2023, 2024])

    loaded, seasons = load_elo(local)
    assert seasons == [2023, 2024]
    assert abs(loaded.get_rating("VER", "race") - system.get_rating("VER", "race")) < 1e-4
    # the JAX package reads the port's file (one format)
    jax_loaded, jax_seasons = jax_elo_cache.load_elo(local)
    assert jax_seasons == seasons
    assert abs(jax_loaded.get_rating("VER", "race") - system.get_rating("VER", "race")) < 1e-4

    other = F1EloSystem()
    other.update_race_ratings([("HAM", 1), ("RUS", 2)])
    save_elo(other, external, processed_seasons=[2022])
    got = load_with_priority(external, local)
    assert got is not None and got[2] == "external"
    assert "HAM" in got[0].names
    got = load_with_priority(tmp_path / "nope.json", local)
    assert got is not None and got[2] == "local"
    assert load_with_priority(None, tmp_path / "nope.json") is None


def test_elo_cache_rejects_corrupt(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text("{not json")
    assert load_elo(p) is None
    p.write_text('{"version": 99, "ratings": {}}')
    assert load_elo(p) is None
    assert jax_elo_cache.load_elo(p) is None


def test_predictor_elo_cache_roundtrip(tmp_path):
    """use_elo_cache=True persists ratings after a build and a fresh
    predictor resumes from them without reprocessing seasons."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    backend = SyntheticBackend(seed=5, n_events=2)
    p1 = F1Predictor(cache_dir=tmp_path, backend=backend, use_elo_cache=True, device="cpu")
    p1._build_elo(2024)
    assert (tmp_path / "elo_ratings.json").exists()
    r_before = p1.elo_system.get_rating("VER", "race")

    p2 = F1Predictor(cache_dir=tmp_path, backend=backend, use_elo_cache=True, device="cpu")
    assert p2._processed_seasons == p1._processed_seasons
    assert abs(p2.elo_system.get_rating("VER", "race") - r_before) < 1e-4
    p2._build_elo(2024)
    assert abs(p2.elo_system.get_rating("VER", "race") - r_before) < 1e-4


def test_synthetic_world_is_hash_seed_invariant():
    """The synthetic world is the same in every process whatever
    PYTHONHASHSEED, and the same as the JAX package's."""
    probe = (
        "from monte_carlo_gp_torch.data.synthetic import SyntheticBackend;"
        "b = SyntheticBackend(seed=5, n_events=3);"
        "print(b._skill(2024).tobytes().hex());"
        "print(sorted(b._team_pace.items())[:2])"
    )
    outs = [
        subprocess.run(
            [sys.executable, "-c", probe],
            env={"PYTHONHASHSEED": hs, "PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT),
                 "OMP_NUM_THREADS": "2"},
            capture_output=True, text=True, cwd=str(ROOT), timeout=120,
        )
        for hs in ("0", "1", "31337")
    ]
    for o in outs:
        assert o.returncode == 0, o.stderr[-500:]
    assert outs[0].stdout == outs[1].stdout == outs[2].stdout, [o.stdout for o in outs]
    jax_backend = JaxSynthetic(seed=5, n_events=3)
    assert outs[0].stdout.splitlines()[0] == jax_backend._skill(2024).tobytes().hex()


def test_offline_allows_offline_safe_synthetic_backend(tmp_path):
    """offline=True forbids network backends, not the synthetic generator
    (offline_safe=True)."""
    loader = F1DataLoader(cache_dir=tmp_path, offline=True,
                          backend=SyntheticBackend(seed=3, n_events=2))
    assert len(loader.get_schedule(2024)) == 2
    assert not loader.load_session(2024, "Bahrain Grand Prix", "Q").empty

    class _NetStub:
        name = "netstub"

        def get_schedule(self, season):  # pragma: no cover - must not run
            raise AssertionError("offline loader touched a network backend")

    blocked = F1DataLoader(cache_dir=tmp_path / "empty", offline=True, backend=_NetStub())
    assert blocked.get_schedule(2024) == []
