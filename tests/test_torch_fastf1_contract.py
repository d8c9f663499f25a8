"""Contract tests of the port's FastF1 network backend with a stubbed
`fastf1` (the twin of tests/test_fastf1_contract.py, whose stub sessions,
frames and schedules it reuses). `monte_carlo_gp_torch.data.loader
.FastF1Backend` imports `fastf1` when it is constructed, so the stub in
`sys.modules` serves it as it serves the JAX package's backend. Each load
goes through both backends on the same stub, and the port's output is held
to the JAX test's expectations and equal to the JAX backend's.
"""

from __future__ import annotations

import sys

import numpy as np
import pandas as pd
import pytest

import test_fastf1_contract as jt
from monte_carlo_gp_torch.data.loader import _LAP_COLUMNS, F1DataLoader
from monte_carlo_gp_tpu.data.loader import _LAP_COLUMNS as JAX_LAP_COLUMNS

FakeSession, laps_frame, td = jt.FakeSession, jt.laps_frame, jt.td


@pytest.fixture()
def backend_for(monkeypatch, tmp_path):
    """Factory: install a fastf1 stub; construct the port's FastF1Backend
    and the JAX package's on it. Returns (port backend, stub, JAX backend)."""

    def build(sessions, schedule=None):
        fake = jt.make_fake_fastf1(sessions, schedule)
        monkeypatch.setitem(sys.modules, "fastf1", fake)
        from monte_carlo_gp_torch.data.loader import FastF1Backend
        from monte_carlo_gp_tpu.data.loader import FastF1Backend as JaxFastF1Backend

        backend = FastF1Backend(str(tmp_path / "ff1"))
        assert fake.cache_dirs == [str(tmp_path / "ff1")]
        jax_backend = JaxFastF1Backend(str(tmp_path / "ff1-jax"))
        return backend, fake, jax_backend

    return build


def same_frame(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        pd.testing.assert_frame_equal(a, b)


# -- laps ---------------------------------------------------------------------


def test_load_laps_normalizes_schema(backend_for):
    backend, _, jax_backend = backend_for(
        {(2024, "Bahrain", "FP2"): FakeSession(laps=laps_frame())})
    out = backend.load_laps(2024, "Bahrain", "FP2")
    same_frame(out, jax_backend.load_laps(2024, "Bahrain", "FP2"))
    assert _LAP_COLUMNS == JAX_LAP_COLUMNS
    assert list(out.columns) == _LAP_COLUMNS
    assert out["LapTime"].tolist()[:2] == [92.357, 91.001]
    assert np.isnan(out["LapTime"].iloc[2])
    assert np.issubdtype(out["Sector1Time"].dtype, np.floating)
    assert out["Sector3Time"].iloc[1] == 28.201
    assert np.isnan(out["Sector2Time"].iloc[2])
    assert np.isnan(out["PitInTime"].iloc[0]) and out["PitInTime"].iloc[1] == 1.0
    assert out["PitOutTime"].iloc[0] == 1.0 and np.isnan(out["PitOutTime"].iloc[1])
    assert out["Position"].isna().all()
    assert out["Driver"].tolist() == ["VER", "VER", "HAM"]
    assert out["Compound"].tolist() == ["SOFT", "SOFT", "MEDIUM"]
    assert out["IsAccurate"].tolist() == [True, True, False]
    assert out["Deleted"].tolist() == [False, False, True]
    assert out["TrackTemp"].tolist() == [41.2, 41.5, 40.9]


def test_load_laps_feeds_quali_extraction(backend_for):
    from monte_carlo_gp_torch.data.loader import extract_quali_results

    backend, _, _ = backend_for({(2024, "Bahrain", "Q"): FakeSession(laps=laps_frame())})
    assert extract_quali_results(backend.load_laps(2024, "Bahrain", "Q")) == [("VER", 91.001)]


def test_load_laps_failure_returns_none(backend_for, capsys):
    backend, _, _ = backend_for(
        {(2024, "Bahrain", "FP1"): FakeSession(laps=laps_frame(), fail=True)})
    assert backend.load_laps(2024, "Bahrain", "FP1") is None
    assert "could not load" in capsys.readouterr().out
    assert backend.load_laps(2024, "Nowhere", "FP1") is None


def test_load_laps_empty_returns_none(backend_for):
    backend, _, _ = backend_for({(2024, "Bahrain", "FP3"): FakeSession(laps=pd.DataFrame())})
    assert backend.load_laps(2024, "Bahrain", "FP3") is None


# -- results ------------------------------------------------------------------


def test_load_results_selects_reference_columns(backend_for):
    res = pd.DataFrame({
        "Abbreviation": ["VER", "HAM", "SAI"],
        "GridPosition": [1.0, 3.0, 2.0],
        "Position": [1.0, 2.0, np.nan],
        "Status": ["Finished", "Finished", "Engine"],
        "Points": [25.0, 18.0, 0.0],
    })
    backend, _, jax_backend = backend_for({(2024, "Bahrain", "R"): FakeSession(results=res)})
    out = backend.load_results(2024, "Bahrain", "R")
    same_frame(out, jax_backend.load_results(2024, "Bahrain", "R"))
    assert list(out.columns) == ["Abbreviation", "GridPosition", "Position", "Status"]
    assert out["Abbreviation"].tolist() == ["VER", "HAM", "SAI"]
    assert out["Status"].tolist() == ["Finished", "Finished", "Engine"]
    assert np.isnan(out["Position"].iloc[2])


def test_load_results_failure_and_empty(backend_for):
    backend, _, _ = backend_for({
        (2024, "A", "R"): FakeSession(results=pd.DataFrame(), fail=False),
        (2024, "B", "R"): FakeSession(results=None, fail=True),
    })
    assert backend.load_results(2024, "A", "R") is None
    assert backend.load_results(2024, "B", "R") is None


# -- weather ------------------------------------------------------------------


def test_load_weather_aggregates_with_nan_defaults(backend_for):
    w = pd.DataFrame({
        "AirTemp": [24.0, 26.0, np.nan],
        "TrackTemp": [np.nan, np.nan, np.nan],
        "Humidity": [40.0, 44.0, 48.0],
        "Rainfall": [False, True, False],
    })
    backend, fake, jax_backend = backend_for({(2024, "Bahrain", "R"): FakeSession(weather=w)})
    out = backend.load_weather(2024, "Bahrain", "R")
    assert out == {"air_temp": 25.0, "track_temp": 35, "humidity": 44.0, "rainfall": True,
                   "wind_speed": 5}
    assert out == jax_backend.load_weather(2024, "Bahrain", "R")
    sess = fake.get_session(2024, "Bahrain", "R")
    assert sess.load_calls[0] == {"weather": True, "laps": False, "telemetry": False,
                                  "messages": False}


def test_load_weather_no_rainfall_column(backend_for):
    backend, _, _ = backend_for({(2024, "X", "Q"): FakeSession(weather=pd.DataFrame({"AirTemp": [20.0]}))})
    out = backend.load_weather(2024, "X", "Q")
    assert out["rainfall"] is False
    assert out["air_temp"] == 20.0


def test_load_weather_failure_and_empty(backend_for):
    backend, _, _ = backend_for({
        (2024, "A", "R"): FakeSession(weather=pd.DataFrame()),
        (2024, "B", "R"): FakeSession(weather=None, fail=True),
    })
    assert backend.load_weather(2024, "A", "R") is None
    assert backend.load_weather(2024, "B", "R") is None


# -- schedule -----------------------------------------------------------------


def test_get_schedule_normalizes_events(backend_for):
    schedule = pd.DataFrame({
        "EventName": ["Bahrain Grand Prix", "Chinese Grand Prix"],
        "Location": ["Sakhir", "Shanghai"],
        "EventFormat": ["conventional", "sprint_qualifying"],
        "EventDate": [pd.Timestamp("2024-03-02"), pd.Timestamp("2024-04-21")],
        "RoundNumber": [1, 2],
    })
    backend, _, jax_backend = backend_for({}, schedule=schedule)
    events = backend.get_schedule(2024)
    assert events == jax_backend.get_schedule(2024)
    assert [e["EventName"] for e in events] == ["Bahrain Grand Prix", "Chinese Grand Prix"]
    assert events[0]["Location"] == "Sakhir"
    assert events[1]["EventFormat"] == "sprint_qualifying"
    assert events[0]["EventDate"] == pd.Timestamp("2024-03-02")
    assert [e["RoundNumber"] for e in events] == [1, 2]


# -- loader integration: caching + offline ------------------------------------


def one_event_schedule(name="Bahrain Grand Prix", location="Sakhir", date="2024-03-02",
                       round_number=1, fmt="conventional"):
    return pd.DataFrame({"EventName": [name], "Location": [location], "EventFormat": [fmt],
                         "EventDate": [pd.Timestamp(date)], "RoundNumber": [round_number]})


def test_loader_caches_backend_loads_to_disk(backend_for, tmp_path):
    """The first load goes through the stubbed network backend and is
    persisted; an offline loader with no backend serves it from the parquet
    cache byte-identically, and so does the JAX package's offline loader."""
    from monte_carlo_gp_tpu.data.loader import F1DataLoader as JaxLoader

    backend, fake, _ = backend_for(
        {(2024, "Bahrain Grand Prix", "FP2"): FakeSession(laps=laps_frame())},
        schedule=one_event_schedule(),
    )
    cache_dir = tmp_path / "cache"
    first = F1DataLoader(cache_dir=cache_dir, backend=backend).load_session(2024, "Bahrain", "FP2")
    assert not first.empty
    n_network = len(fake.session_requests)
    offline = F1DataLoader(cache_dir=cache_dir, offline=True)
    assert offline.backend is None
    cached = offline.load_session(2024, "Bahrain", "FP2")
    pd.testing.assert_frame_equal(first.reset_index(drop=True), cached)
    pd.testing.assert_frame_equal(
        cached, JaxLoader(cache_dir=cache_dir, offline=True).load_session(2024, "Bahrain", "FP2"))
    assert len(fake.session_requests) == n_network


def test_offline_loader_never_touches_backend(backend_for, tmp_path):
    backend, fake, _ = backend_for({(2024, "Bahrain", "FP2"): FakeSession(laps=laps_frame())})
    loader = F1DataLoader(cache_dir=tmp_path / "empty", offline=True, backend=backend)
    assert loader.load_session(2024, "Bahrain", "FP2").empty
    assert loader.get_schedule(2024) == []
    assert loader.get_weather(2024, "Bahrain", "R")["track_temp"] == 35
    assert fake.session_requests == []


# -- schedule-format edge cases -------------------------------------------------


def test_schedule_event_date_falls_back_to_session5date(backend_for):
    backend, _, jax_backend = backend_for({}, schedule=jt._schedule_2023_style())
    events = backend.get_schedule(2023)
    imola = next(e for e in events if e["EventName"].startswith("Emilia"))
    assert imola["EventDate"] == pd.Timestamp("2023-05-21 15:00")
    assert [e["EventDate"] for e in events] == [e["EventDate"] for e in jax_backend.get_schedule(2023)]


def test_past_events_excludes_testing_and_orders_by_clock(backend_for, tmp_path):
    backend, _, _ = backend_for({}, schedule=jt._schedule_2023_style())
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend,
                          now=pd.Timestamp("2023-05-01", tz="UTC"))
    names = [e["EventName"] for e in loader.past_events(2023)]
    assert "Pre-Season Testing" not in names
    assert names == ["Bahrain Grand Prix", "Azerbaijan Grand Prix", "Qatar Grand Prix"]
    loader.set_now(pd.Timestamp("2023-12-01", tz="UTC"))
    names = [e["EventName"] for e in loader.past_events(2023)]
    assert "Qatar Grand Prix" not in names
    assert "Emilia Romagna Grand Prix" in names


@pytest.mark.parametrize("fmt", ["sprint", "sprint_qualifying", "sprint_shootout"])
def test_load_season_data_requests_sprint_sessions_for_all_formats(backend_for, tmp_path, fmt):
    backend, fake, _ = backend_for(
        jt._sprint_session_set(2023, "Azerbaijan Grand Prix"),
        schedule=one_event_schedule("Azerbaijan Grand Prix", "Baku", "2023-04-30", 4, fmt),
    )
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend,
                          now=pd.Timestamp("2023-12-01", tz="UTC"))
    data = loader.load_season_data(2023)
    assert {"Q", "R", "SQ", "S"} <= {s for (_, _, s) in fake.session_requests}
    assert len(data["sprint_qualifying"]) == 1
    assert len(data["sprints"]) == 1


def test_conventional_event_never_requests_sprint_sessions(backend_for, tmp_path):
    backend, fake, _ = backend_for(
        {(2023, "Bahrain Grand Prix", "Q"): FakeSession(laps=laps_frame()),
         (2023, "Bahrain Grand Prix", "R"): FakeSession(laps=laps_frame())},
        schedule=one_event_schedule(date="2023-03-05"),
    )
    F1DataLoader(cache_dir=tmp_path, backend=backend,
                 now=pd.Timestamp("2023-12-01", tz="UTC")).load_season_data(2023)
    requested = {s for (_, _, s) in fake.session_requests}
    assert "SQ" not in requested and "S" not in requested


def test_build_cache_skips_testing_events(backend_for, tmp_path):
    backend, fake, _ = backend_for(
        {(2023, "Bahrain Grand Prix", s): FakeSession(laps=laps_frame())
         for s in ("FP1", "FP2", "FP3", "Q", "R")},
        schedule=jt._schedule_2023_style(),
    )
    F1DataLoader(cache_dir=tmp_path, backend=backend).build_cache([2023], sessions=("FP2", "Q", "R"))
    events_requested = {e for (_, e, _) in fake.session_requests}
    assert "Pre-Season Testing" not in events_requested
    assert "Bahrain Grand Prix" in events_requested


# -- NaN Grid/Position rows (red-flagged races) --------------------------------


def test_load_results_passes_nan_rows_through(backend_for):
    backend, _, jax_backend = backend_for(
        {(2021, "Belgian Grand Prix", "R"): FakeSession(results=jt.results_frame_red_flagged())})
    out = backend.load_results(2021, "Belgian Grand Prix", "R")
    same_frame(out, jax_backend.load_results(2021, "Belgian Grand Prix", "R"))
    assert len(out) == 4
    assert np.isnan(out["GridPosition"].iloc[1])
    assert np.isnan(out["Position"].iloc[2])


def test_actual_results_drop_nan_positions(backend_for, tmp_path):
    from monte_carlo_gp_torch.validate.backtest import get_actual_results

    backend, _, _ = backend_for(
        {(2021, "Belgian Grand Prix", s): FakeSession(results=jt.results_frame_red_flagged())
         for s in ("R", "Q")},
        schedule=one_event_schedule("Belgian Grand Prix", "Spa", "2021-08-29", 12),
    )
    act = get_actual_results(F1DataLoader(cache_dir=tmp_path, backend=backend), 2021,
                             "Belgian Grand Prix")
    assert act["race_results"] == ["VER", "HAM"]
    assert act["winner"] == "VER"
    assert "LEC" not in act["race_results"]


def test_feature_archive_tolerates_nan_result_rows(backend_for, tmp_path):
    from monte_carlo_gp_torch.data.loader import DEFAULT_WEATHER
    from monte_carlo_gp_torch.models.features import F1FeatureEngine

    backend, _, _ = backend_for(
        {(2021, "Belgian Grand Prix", "Q"): FakeSession(laps=laps_frame()),
         (2021, "Belgian Grand Prix", "R"): FakeSession(
             laps=laps_frame(), results=jt.results_frame_red_flagged())},
        schedule=one_event_schedule("Belgian Grand Prix", "Spa", "2021-08-29", 12),
    )
    loader = F1DataLoader(cache_dir=tmp_path, backend=backend,
                          now=pd.Timestamp("2021-12-01", tz="UTC"))
    eng = F1FeatureEngine(loader)
    eng.load_historical_data([2021])
    assert not eng.race_results.empty
    for driver in ("VER", "LEC"):
        feats = eng.calculate_race_features(driver, circuit="Belgian Grand Prix",
                                            weather=dict(DEFAULT_WEATHER))
        assert np.isfinite(feats["overtake_rate"])


# -- recorded-fixture round trip: build_cache -> offline predict_weekend ------


@pytest.mark.slow
def test_build_cache_offline_predict_roundtrip(monkeypatch, tmp_path):
    """Record a world through the stubbed FastF1 backend with build_cache,
    then run the whole offline prediction (Elo, features, practice
    extraction, the Monte Carlo on the CPU) against the recorded cache with
    no backend at all."""
    sessions, schedules, drivers = jt._fixture_world()
    fake = jt.make_fake_fastf1(sessions)
    fake.get_event_schedule = lambda season: schedules[season]
    monkeypatch.setitem(sys.modules, "fastf1", fake)
    from monte_carlo_gp_torch.data.loader import FastF1Backend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    cache_dir = tmp_path / "cache"
    loader = F1DataLoader(cache_dir=cache_dir, backend=FastF1Backend(str(tmp_path / "ff1")))
    assert loader.build_cache([2023, 2024]) > 0

    predictor = F1Predictor(cache_dir=cache_dir, offline=True, engine="xla", device="cpu")
    assert predictor.data_loader.backend is None
    n_before = len(fake.session_requests)
    result = predictor.predict_weekend(2024, "Bahrain", n_simulations=256, seed=3)
    assert len(fake.session_requests) == n_before

    assert set(result["win_probabilities"]) == set(drivers)
    assert abs(sum(result["win_probabilities"].values()) - 1.0) < 1e-3
    assert set(result["pole_probabilities"]) == set(drivers)
    assert all(0.0 <= v <= 1.0 for v in result["pole_probabilities"].values())
    fav = max(result["win_probabilities"], key=result["win_probabilities"].get)
    assert fav in ("VER", "PER", "HAM", "RUS"), result["win_probabilities"]
    again = F1Predictor(cache_dir=cache_dir, offline=True, engine="xla", device="cpu"
                        ).predict_weekend(2024, "Bahrain", n_simulations=256, seed=3)
    assert again["win_probabilities"] == result["win_probabilities"]
