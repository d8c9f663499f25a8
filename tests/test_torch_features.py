"""The port's feature engine (`monte_carlo_gp_torch.models.features`), the
twin of tests/test_features.py: the same hand-crafted archives and
synthetic worlds go through the JAX package's `F1FeatureEngine` and the
port's, every feature is held to the JAX test's expectation, and the two
engines' outputs are equal field by field (exactly: both are the same
float64 pandas/numpy arithmetic on the host).
"""

import numpy as np
import pandas as pd
import pytest

from monte_carlo_gp_torch.data.loader import F1DataLoader
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.features import F1FeatureEngine
from monte_carlo_gp_tpu.data.loader import F1DataLoader as JaxLoader
from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend as JaxSynthetic
from monte_carlo_gp_tpu.models.features import F1FeatureEngine as JaxEngine

DRY = {"rainfall": False, "track_temp": 35}


def make_engine(laps=None, results=None, cls=F1FeatureEngine):
    eng = cls(data_loader=None)
    eng.laps = laps.copy() if laps is not None else pd.DataFrame()
    eng.race_results = results.copy() if results is not None else pd.DataFrame()
    return eng


def quali(laps=None, results=None, driver="A", circuit="Bahrain"):
    """The port's quali features of `driver`, after checking them equal to
    the JAX engine's on the same archive."""
    port = make_engine(laps, results).calculate_quali_features(driver, circuit)
    assert port == make_engine(laps, results, JaxEngine).calculate_quali_features(driver, circuit)
    return port


def race(laps=None, results=None, driver="A", circuit="x", weather=DRY):
    port = make_engine(laps, results).calculate_race_features(driver, circuit, dict(weather))
    jax = make_engine(laps, results, JaxEngine).calculate_race_features(
        driver, circuit, dict(weather))
    assert port == jax
    return port


def lap_rows(driver, team, season, circuit, session, times, sectors=None, **kw):
    rows = []
    for i, t in enumerate(times):
        s = sectors[i] if sectors else (t * 0.3, t * 0.38, t * 0.32)
        rows.append(
            dict(
                Driver=driver, Team=team, season=season, circuit=circuit,
                session_type=session, LapTime=t, LapNumber=i + 1,
                Sector1Time=s[0], Sector2Time=s[1], Sector3Time=s[2],
                Compound="SOFT", IsAccurate=True, TrackTemp=kw.get("temp", 35.0),
                Rainfall=kw.get("rain", False), Position=np.nan,
            )
        )
    return rows


def results_rows(driver, entries, season=2024):
    return [
        dict(driver=driver, grid=g, finish=f, status=s, season=season, circuit=f"C{i}")
        for i, (g, f, s) in enumerate(entries)
    ]


# -- defaults on empty archives ------------------------------------------------


def test_empty_archive_defaults():
    q = quali(driver="VER")
    assert q["avg_gap_to_pole_pct"] == 1.5
    assert q["teammate_delta"] == 0.0
    assert q["q3_conversion"] == 0.5
    assert q["form_score"] == 0.0
    r = race(driver="VER", circuit="Bahrain", weather={"rainfall": False, "track_temp": 40})
    assert r["deg_rate"] == 0.05
    assert r["position_hold_rate"] == 0.7
    assert r["dnf_probability"] == 0.05
    assert r["wet_performance"] == 0
    assert r["high_temp_deg"] == pytest.approx(0.001 * 40)


# -- qualifying features ---------------------------------------------------------


def test_teammate_delta_direction():
    laps = pd.DataFrame(
        lap_rows("FAST", "T1", 2024, "Bahrain GP", "Q", [89.0, 88.5])
        + lap_rows("SLOW", "T1", 2024, "Bahrain GP", "Q", [90.0, 89.5])
    )
    fast = quali(laps, driver="FAST")["teammate_delta"]
    slow = quali(laps, driver="SLOW")["teammate_delta"]
    assert fast == pytest.approx((89.5 - 88.5) / 89.5 * 100, rel=1e-5)
    assert slow < 0 < fast


def test_q3_rate_lap_count_heuristic():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [90, 91, 92])  # 3 laps -> Q3
        + lap_rows("A", "T", 2024, "R2", "Q", [90, 91])  # 2 laps -> no
    )
    assert quali(laps)["q3_conversion"] == 0.5


def test_form_score_decay_weighting():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [91.8])
        + lap_rows("B", "T", 2024, "R1", "Q", [90.0])
        + lap_rows("A", "T", 2024, "R2", "Q", [90.0])
        + lap_rows("B", "T", 2024, "R2", "Q", [90.5])
    )
    w_old, w_new = 0.85, 1.0
    expected = (-1.0 * w_old + 1.0 * w_new) / (w_old + w_new)
    assert quali(laps)["form_score"] == pytest.approx(expected, rel=1e-4)


def test_sector_strength_clamped():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [87.0], sectors=[(26.0, 33.0, 28.0)])
        + lap_rows("B", "T", 2024, "R1", "Q", [90.0], sectors=[(27.0, 34.0, 29.0)])
    )
    assert quali(laps, driver="A")["high_speed_strength"] == 0.0
    assert quali(laps, driver="B")["high_speed_strength"] == -1.0


def test_circuit_affinity_sign():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "Monaco Grand Prix", "Q", [70.0, 70.0])
        + lap_rows("A", "T", 2024, "Italy Grand Prix", "Q", [95.0, 95.0])
    )
    aff = quali(laps, circuit="Monaco Grand Prix")["circuit_affinity"]
    assert aff == pytest.approx((82.5 - 70) / 82.5)
    aff2 = quali(laps, circuit="Italy Grand Prix")["circuit_affinity"]
    assert aff2 == pytest.approx((82.5 - 95) / 82.5)


# -- race features ---------------------------------------------------------------


def test_race_pace_delta():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "R", [90.0] * 6)
        + lap_rows("B", "T", 2024, "R1", "R", [91.8] * 6)
    )
    assert race(laps, driver="A")["race_pace_delta"] == 0.0
    assert race(laps, driver="B")["race_pace_delta"] == pytest.approx(2.0)


def test_deg_rate_slope_and_clamp():
    times = [90.0 + 0.08 * i for i in range(20)]
    laps = pd.DataFrame(lap_rows("A", "T", 2024, "R1", "R", times))
    assert race(laps)["deg_rate"] == pytest.approx(0.08, abs=5e-3)
    times = [90.0 + 0.4 * i for i in range(20)]
    assert race(pd.DataFrame(lap_rows("A", "T", 2024, "R1", "R", times)))["deg_rate"] == 0.15


def test_result_based_features():
    entries = [(5, 3, "Finished")] * 6 + [(5, 3, "Accident")] * 2 + [(4, 3, "+1 Lap")] * 4
    f = race(results=pd.DataFrame(results_rows("A", entries)))
    gains = [g - fi for g, fi, _ in entries]
    assert f["overtake_rate"] == pytest.approx(np.mean(gains))
    assert f["dnf_probability"] == pytest.approx(2 / 12)
    assert f["start_delta"] == pytest.approx(np.clip(np.mean([g * 0.4 for g in gains]), -3, 3))
    assert f["clutch_factor"] == pytest.approx(np.clip(np.mean([g / 5 for g in gains]), -0.5, 0.5))
    assert f["position_hold_rate"] == 0.95


def test_team_trend_improvement():
    entries = [(10, 10, "Finished")] * 7 + [(10, 5, "Finished")] * 5
    assert race(results=pd.DataFrame(results_rows("A", entries)))["team_trend"] == pytest.approx(0.5)


def test_wet_performance_only_when_wet():
    laps = pd.DataFrame(
        lap_rows("A", "T", 2024, "R1", "Q", [90.0], rain=False)
        + lap_rows("B", "T", 2024, "R1", "Q", [89.0], rain=False)
        + lap_rows("A", "T", 2024, "R2", "Q", [95.0], rain=True)
        + lap_rows("B", "T", 2024, "R2", "Q", [96.0], rain=True)
    )
    assert race(laps, weather={"rainfall": False, "track_temp": 30})["wet_performance"] == 0
    assert race(laps, weather={"rainfall": True, "track_temp": 30})["wet_performance"] == 1.0


# -- synthetic end-to-end ---------------------------------------------------------


def test_full_pipeline_on_synthetic(tmp_path):
    engines = []
    for loader_cls, backend_cls, engine_cls, name in (
        (F1DataLoader, SyntheticBackend, F1FeatureEngine, "port"),
        (JaxLoader, JaxSynthetic, JaxEngine, "jax"),
    ):
        loader = loader_cls(cache_dir=tmp_path / name, backend=backend_cls(seed=11, n_events=4))
        eng = engine_cls(loader)
        eng.load_historical_data([2024])
        engines.append(eng)
    eng, jax_eng = engines
    assert not eng.laps.empty and not eng.race_results.empty
    pd.testing.assert_frame_equal(eng.laps, jax_eng.laps)
    drivers = eng.laps["Driver"].unique().tolist()
    weather = {"rainfall": False, "track_temp": 40}
    qa = eng.quali_feature_arrays(drivers, "Bahrain Grand Prix")
    ra = eng.race_feature_arrays(drivers, "Bahrain Grand Prix", weather)
    jqa = jax_eng.quali_feature_arrays(drivers, "Bahrain Grand Prix")
    jra = jax_eng.race_feature_arrays(drivers, "Bahrain Grand Prix", weather)
    assert set(qa) == set(jqa) and set(ra) == set(jra)
    for k, v in {**qa, **ra}.items():
        assert v.shape == (len(drivers),), k
        assert np.isfinite(v).all(), k
        np.testing.assert_array_equal(v, {**jqa, **jra}[k], err_msg=k)
    assert (ra["deg_rate"] >= 0.01).all() and (ra["deg_rate"] <= 0.15).all()
    assert (ra["dnf_probability"] >= 0.01).all() and (ra["dnf_probability"] <= 0.20).all()
    assert (np.abs(qa["form_score"]) <= 1.0).all()


def _assert_equal_value(a, b, ctx):
    if isinstance(a, dict):
        assert set(a) == set(b), ctx
        for d in a:
            _assert_equal_value(a[d], b[d], f"{ctx}[{d}]")
    elif isinstance(a, tuple):
        assert len(a) == len(b), ctx
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_equal_value(x, y, f"{ctx}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=ctx)
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_names=False)
    elif isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b, check_names=False)
    elif a is None or b is None:
        assert a is None and b is None, ctx
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), ctx
    else:
        assert a == b, ctx


def _assert_tables_equal(ta: dict, tb: dict):
    assert set(ta) == set(tb)
    for k in ta:
        _assert_equal_value(ta[k], tb[k], k)


def test_event_partial_memo_matches_fresh(tmp_path):
    """The per-event partial memo is invisible: an engine that rebuilt its
    archive once per race under the walk-forward pinned clock gives the
    same tables and features as a fresh engine built at the final clock, and
    both equal the JAX engine's at that clock."""
    from monte_carlo_gp_torch.validate.backtest import _pin, _race_cutoffs, get_races
    from monte_carlo_gp_tpu.validate.backtest import _pin as jax_pin

    loader = F1DataLoader(cache_dir=tmp_path / "a", backend=SyntheticBackend(seed=3, n_events=6))
    eng = F1FeatureEngine(loader)
    season = 2024
    cutoffs = _race_cutoffs(loader, season)
    races = get_races(loader, season)
    for i in range(len(races)):
        _pin(loader, cutoffs, i, True)
        eng.load_historical_data([season])
        eng._t()
    assert len(eng._event_parts) > 1

    loader2 = F1DataLoader(cache_dir=tmp_path / "b", backend=SyntheticBackend(seed=3, n_events=6))
    _pin(loader2, cutoffs, len(races) - 1, True)
    fresh = F1FeatureEngine(loader2)
    fresh.load_historical_data([season])
    _assert_tables_equal(eng._t(), fresh._t())

    jax_loader = JaxLoader(cache_dir=tmp_path / "c", backend=JaxSynthetic(seed=3, n_events=6))
    jax_pin(jax_loader, cutoffs, len(races) - 1, True)
    jax_eng = JaxEngine(jax_loader)
    jax_eng.load_historical_data([season])
    _assert_tables_equal(fresh._t(), jax_eng._t())

    drivers = sorted(eng.laps["Driver"].unique().tolist())
    circuit = races[0]
    weather = {"rainfall": True, "track_temp": 30.0}
    for d in drivers:
        q = eng.calculate_quali_features(d, circuit)
        assert q == pytest.approx(fresh.calculate_quali_features(d, circuit))
        assert fresh.calculate_quali_features(d, circuit) == jax_eng.calculate_quali_features(
            d, circuit)
        r = eng.calculate_race_features(d, circuit, weather)
        assert r == pytest.approx(fresh.calculate_race_features(d, circuit, weather))
        assert fresh.calculate_race_features(d, circuit, weather) == \
            jax_eng.calculate_race_features(d, circuit, weather)


def test_direct_assignment_matches_loader_build(tmp_path):
    """Assigning `laps`/`race_results` directly gives the same tables as
    the loader-built archive they came from."""
    loader = F1DataLoader(cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=4))
    eng = F1FeatureEngine(loader)
    eng.load_historical_data([2024])
    manual = make_engine(eng.laps, eng.race_results)
    _assert_tables_equal(eng._t(), manual._t())
    _assert_tables_equal(manual._t(), make_engine(eng.laps, eng.race_results, JaxEngine)._t())


def test_teammate_delta_respects_team_changes():
    """A driver who switches teams between seasons is compared against
    each season's actual teammate, not a static roster."""
    laps = pd.DataFrame(
        lap_rows("X", "TeamA", 2023, "R1", "Q", [90.0])
        + lap_rows("M1", "TeamA", 2023, "R1", "Q", [91.0])
        + lap_rows("M2", "TeamB", 2023, "R1", "Q", [88.0])
        + lap_rows("X", "TeamB", 2024, "R1", "Q", [90.0])
        + lap_rows("M2", "TeamB", 2024, "R1", "Q", [89.0])
        + lap_rows("M1", "TeamA", 2024, "R1", "Q", [85.0])
    )
    expected = np.mean([(91 - 90) / 91 * 100, (89 - 90) / 89 * 100])
    assert quali(laps, driver="X", circuit="R1")["teammate_delta"] == pytest.approx(expected, rel=1e-4)
