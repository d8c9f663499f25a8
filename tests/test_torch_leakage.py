"""Walk-forward leakage control for the port (`monte_carlo_gp_torch`), the
twin of tests/test_leakage.py: the prediction for race k uses only races
strictly before k (plus race k's own practice sessions).

The backtest pins the data loader's clock to just before each race's date
(`validate.backtest._pin`). At every race k a spy predictor records the Elo
state and the feature archive at prediction time; they must equal a strict
walk-forward control, and the JAX package's spy on the same world. All
runs are on the CPU, where the race kernels run their plain versions.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from monte_carlo_gp_torch.data.loader import F1DataLoader
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.validate.backtest import (
    _race_cutoffs,
    backtest_model,
    get_actual_results,
    get_races,
)

N_EVENTS, SEASON, SYNTHETIC_SEED = 3, 2024, 5

torch.set_num_threads(2)


def _archive(predictor) -> set[tuple[int, str]]:
    """(season, circuit) pairs in the predictor's feature archive."""
    laps = predictor.feature_engine.laps
    if laps.empty:
        return set()
    return set(map(tuple, laps[["season", "circuit"]].drop_duplicates().to_numpy()))


def _spy_run(base, backend_cls, run_backtest, cache_dir, pin_clock=True, **kwargs):
    """Backtest the 2024 season through `run_backtest` with a spy subclass
    of the predictor `base`; returns the Elo state_dict and the feature
    archive at each race's prediction."""
    elo_snaps, archive_snaps = [], []

    class SpyPredictor(base):
        def prepare_weekend(self, *args, **kw):
            plan = super().prepare_weekend(*args, **kw)
            elo_snaps.append(self.elo_system.state_dict())
            archive_snaps.append(_archive(self))
            return plan

    def factory():
        return SpyPredictor(
            cache_dir=cache_dir, backend=backend_cls(seed=SYNTHETIC_SEED, n_events=N_EVENTS),
            **kwargs,
        )

    run_backtest(factory, [SEASON], seed=11, n_simulations=64, pin_clock=pin_clock,
                 verbose=False)
    return elo_snaps, archive_snaps


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    return _spy_run(F1Predictor, SyntheticBackend, backtest_model,
                    tmp_path_factory.mktemp("port"), device="cpu")


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend as JaxBackend
    from monte_carlo_gp_tpu.models.predictor import F1Predictor as JaxPredictor
    from monte_carlo_gp_tpu.validate.backtest import backtest_model as jax_backtest_model

    return _spy_run(JaxPredictor, JaxBackend, jax_backtest_model,
                    tmp_path_factory.mktemp("jax"), engine="xla")


def _control(cache_dir) -> F1Predictor:
    return F1Predictor(
        cache_dir=cache_dir, backend=SyntheticBackend(seed=SYNTHETIC_SEED, n_events=N_EVENTS),
        device="cpu",
    )


def _ratings_map(state):
    return {n: tuple(np.round(r, 4)) for n, r in zip(state["names"], state["ratings"])}


def test_backtest_elo_walk_forward_no_leak_no_double_count(port_run, tmp_path):
    """At race k the Elo equals the previous season built in full, then the
    actuals of races < k at the current-season recency weight."""
    elo_snaps, _ = port_run
    assert len(elo_snaps) == N_EVENTS

    control = _control(tmp_path)
    loader = control.data_loader
    races = get_races(loader, SEASON)
    cutoffs = _race_cutoffs(loader, SEASON)
    actuals = [get_actual_results(loader, SEASON, r) for r in races]
    loader.set_now(cutoffs[0])  # by hand, so that the rule does not rest on _pin
    control._build_elo(SEASON)

    for k in range(N_EVENTS):
        expected = _ratings_map(control.elo_system.state_dict())
        assert _ratings_map(elo_snaps[k]) == expected, (
            f"race {k}: Elo at prediction time diverges from strict "
            f"walk-forward (leak or double-counted events)"
        )
        control.elo_system.set_recency_weight(0, k, N_EVENTS)
        control.elo_system.update_quali_ratings(actuals[k]["quali_results"])
        control.elo_system.update_race_ratings(actuals[k]["race_results"])


def test_backtest_walk_forward_snapshots_equal_jax(port_run, jax_run):
    """At every race k the port's Elo (to the rtol of tests/test_torch_elo.py)
    and feature archive (exactly) equal the JAX package's."""
    (t_elo, t_arch), (j_elo, j_arch) = port_run, jax_run
    assert len(t_elo) == len(j_elo) == N_EVENTS
    for k in range(N_EVENTS):
        assert t_elo[k]["names"] == j_elo[k]["names"], k
        np.testing.assert_allclose(t_elo[k]["ratings"], j_elo[k]["ratings"], rtol=1e-5,
                                   err_msg=f"race {k}")
        assert t_arch[k] == j_arch[k], k


def test_backtest_feature_archive_no_leak(port_run, tmp_path):
    """At race k the archive holds exactly races[:k] of the current season
    and all of the previous one."""
    _, archive_snaps = port_run
    assert len(archive_snaps) == N_EVENTS
    races = get_races(_control(tmp_path).data_loader, SEASON)
    for k in range(N_EVENTS):
        current = {c for (s, c) in archive_snaps[k] if s == SEASON}
        assert current == set(races[:k]), (
            f"race {k}: feature archive sees current-season races {current}, "
            f"expected exactly {set(races[:k])}"
        )
        assert {c for (s, c) in archive_snaps[k] if s == SEASON - 1} == set(races)


def test_dateless_events_cannot_leak_under_pinned_clock(tmp_path):
    """A NaT EventDate must not unpin the clock or slip past it: cutoffs
    back-fill from the nearest earlier cutoff (a dateless opener gets the
    season's Jan 1), and once the clock is pinned `past_events` excludes
    dateless events."""

    class Sched:
        def __init__(self, events):
            self._events = events

        def get_schedule(self, season):
            return self._events

        def load_laps(self, *a):
            return None

        def load_results(self, *a):
            return None

        def load_weather(self, *a):
            return None

    d1 = pd.Timestamp("2024-03-01", tz="UTC")
    events = [
        {"EventName": "A", "EventFormat": "conventional", "EventDate": pd.NaT},
        {"EventName": "B", "EventFormat": "conventional", "EventDate": d1},
        {"EventName": "C", "EventFormat": "conventional", "EventDate": pd.NaT},
    ]
    loader = F1DataLoader(cache_dir=tmp_path, backend=Sched(events))
    cutoffs = _race_cutoffs(loader, 2024)
    assert cutoffs[0] == pd.Timestamp("2024-01-01", tz="UTC")
    assert cutoffs[1] == d1 - pd.Timedelta(seconds=1)
    assert cutoffs[2] == cutoffs[1]  # back-fill, never forward

    # the wall clock keeps dateless events, as the reference does
    assert [e["EventName"] for e in loader.past_events(2024)] == ["A", "B", "C"]
    # a pinned clock excludes them from everything built on past_events
    loader.set_now(cutoffs[1])
    assert [e["EventName"] for e in loader.past_events(2024)] == []
    loader.set_now(d1 + pd.Timedelta(days=1))
    assert [e["EventName"] for e in loader.past_events(2024)] == ["B"]


def test_pin_clock_false_reproduces_leaky_reference_behavior(tmp_path):
    """pin_clock=False loads the whole season into the archive before race 1."""
    _, archive_snaps = _spy_run(F1Predictor, SyntheticBackend, backtest_model, tmp_path,
                                pin_clock=False, device="cpu")
    current = {c for (s, c) in archive_snaps[0] if s == SEASON}
    assert len(current) == N_EVENTS
