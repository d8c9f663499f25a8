"""The port's data layer (`monte_carlo_gp_torch.data`), the twin of
tests/test_data.py: synthetic backend determinism, the offline disk cache
round trip, season extraction and the three-level Elo cache priority. Where
the JAX package has the same function, the same inputs go through both and
the outputs are equal (frames exactly, ratings to the JAX test's 1e-4).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd

from monte_carlo_gp_torch.data.elo_cache import load_elo, load_with_priority, save_elo
from monte_carlo_gp_torch.data.loader import (
    F1DataLoader,
    extract_quali_results,
    extract_race_results,
)
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.elo import F1EloSystem
from monte_carlo_gp_tpu.data import elo_cache as jax_elo_cache
from monte_carlo_gp_tpu.data import loader as jax_loader
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
