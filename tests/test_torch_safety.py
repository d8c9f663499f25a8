"""The port's prediction-failure safety net (`monte_carlo_gp_torch.models.
safety`) and rookie teammate prior (`F1EloSystem.initialize_rookie(s)`),
the twin of tests/test_safety.py; the fallback result equals the JAX
package's exactly. The serving layer's fallback contract rests on these."""

import numpy as np
import pandas as pd
import pytest
import torch

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.elo import F1EloSystem
from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.models.safety import (
    InsufficientDataError,
    PredictionError,
    generate_fallback_predictions,
    safe_predict,
)

torch.set_num_threads(2)


def _predictor(tmp_path, **kw):
    return F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=5, n_events=3),
                       device="cpu", **kw)


# ---------------------------------------------------------------- fallback


def test_fallback_shape_default_roster():
    r = generate_fallback_predictions(2025, "Monaco")
    drivers = list(cfg.DRIVER_TEAMS.keys())
    n = len(drivers)
    assert sorted(r["pole_probabilities"]) == sorted(drivers)
    assert abs(sum(r["win_probabilities"].values()) - 1.0) < 1e-9
    for d in drivers:
        assert r["pole_probabilities"][d] == pytest.approx(1.0 / n)
        assert r["podium_probabilities"][d] == pytest.approx(min(3.0 / n, 1.0))
        dist = r["full_distributions"][d]
        assert sorted(dist) == list(range(1, n + 1))
        assert abs(sum(dist.values()) - 1.0) < 1e-9
    assert r["fallback"] is True
    assert r["confidence"] == "none"
    assert r["grid_is_actual"] is False
    assert r["prediction_point"] == "fp2"
    assert r["weather"]["rainfall"] is False
    from monte_carlo_gp_tpu.models.safety import generate_fallback_predictions as jax_fallback

    assert r == jax_fallback(2025, "Monaco")


def test_fallback_explicit_and_empty_fields():
    r = generate_fallback_predictions(2025, "Monaco", "fp3", drivers=["A", "B"])
    assert r["prediction_point"] == "fp3"
    assert r["win_probabilities"] == {"A": 0.5, "B": 0.5}
    assert r["podium_probabilities"] == {"A": 1.0, "B": 1.0}  # min(3/2, 1)
    empty = generate_fallback_predictions(2025, "Monaco", drivers=[])
    assert empty["pole_probabilities"] == {}
    assert empty["full_distributions"] == {}
    assert empty["fallback"] is True and empty["confidence"] == "none"


def test_exception_hierarchy():
    # also a ValueError: callers catching the "No practice data" ValueError
    assert issubclass(InsufficientDataError, PredictionError)
    assert issubclass(InsufficientDataError, ValueError)


class _StubPredictor:
    def __init__(self, exc=None, result=None):
        self.exc = exc
        self.result = result
        self.calls = []

    def predict_weekend(self, season, race, **kw):
        self.calls.append((season, race, kw))
        if self.exc is not None:
            raise self.exc
        return self.result


def test_safe_predict_passthrough_and_kwargs():
    stub = _StubPredictor(result={"ok": True})
    out = safe_predict(stub, 2025, "Monaco", prediction_point="quali",
                       actual_grid={"VER": 1}, n_simulations=123, seed=7)
    assert out == {"ok": True}
    (_, _, kw), = stub.calls
    assert kw["n_simulations"] == 123 and kw["seed"] == 7
    assert kw["actual_grid"] == {"VER": 1}


def test_safe_predict_insufficient_data_degrades_to_fallback():
    stub = _StubPredictor(exc=InsufficientDataError("no FP data"))
    out = safe_predict(stub, 2025, "Monaco", prediction_point="fp1")
    assert out is not None and out["fallback"] is True
    assert out["prediction_point"] == "fp1"


def test_safe_predict_other_errors_return_none():
    assert safe_predict(_StubPredictor(exc=RuntimeError("boom")), 2025, "Monaco") is None


def test_predictor_raises_insufficient_data(tmp_path, monkeypatch):
    predictor = _predictor(tmp_path)
    monkeypatch.setattr(predictor.data_loader, "load_session", lambda *a, **k: pd.DataFrame())
    with pytest.raises(InsufficientDataError):
        predictor.prepare_weekend(2024, "Bahrain")
    # safe_predict turns exactly that into the fallback dict
    assert safe_predict(predictor, 2024, "Bahrain")["fallback"] is True


# ------------------------------------------------------------- rookie prior


def test_rookie_prior_is_teammate_mean_minus_50():
    elo = F1EloSystem()
    elo.update_quali_ratings([("AAA", 88.0), ("BBB", 89.0), ("CCC", 90.0)])
    teams = {"AAA": "T1", "BBB": "T1", "CCC": "T2", "NEW": "T1"}
    expected = (elo.get_rating("AAA") + elo.get_rating("BBB")) / 2.0 - 50.0
    rating = elo.initialize_rookie("NEW", "T1", driver_teams=teams)
    assert rating == pytest.approx(expected)
    assert elo.get_rating("NEW", "quali") == pytest.approx(expected)
    assert elo.get_rating("NEW", "race") == pytest.approx(expected)
    assert elo.has_rating("NEW")


def test_rookie_prior_unknown_teammates_count_at_initial():
    elo = F1EloSystem()
    elo.update_quali_ratings([("AAA", 88.0), ("XXX", 91.0)])
    teams = {"AAA": "T1", "GHOST": "T1", "NEW": "T1", "XXX": "T2"}
    expected = (elo.get_rating("AAA") + 1500.0) / 2.0 - 50.0
    assert elo.initialize_rookie("NEW", "T1", teams) == pytest.approx(expected)


def test_rookie_prior_new_team_defaults_1350():
    elo = F1EloSystem()
    assert elo.initialize_rookie("NEW", "Brand New Team", {"NEW": "Brand New Team"}) == 1350.0
    assert elo.has_rating("NEW")


def test_rookie_prior_unknown_team_stays_at_initial():
    # no team: left at the initial rating and not interned
    elo = F1EloSystem()
    assert elo.initialize_rookie("SOLO", None, {}) == 1500.0
    assert not elo.has_rating("SOLO")


def test_rookie_prior_batch_is_order_independent():
    for order in (("NEW1", "NEW2"), ("NEW2", "NEW1")):
        elo = F1EloSystem()
        seeded = elo.initialize_rookies({d: "T1" for d in order}, {"NEW1": "T1", "NEW2": "T1"})
        assert seeded["NEW1"] == seeded["NEW2"] == 1450.0


def test_rookie_prior_sees_pending_events():
    elo = F1EloSystem()
    elo.update_quali_ratings([("AAA", 88.0), ("BBB", 92.0)])
    teams = {"AAA": "T1", "NEW": "T1", "BBB": "T2"}
    assert elo._pending  # the event is still buffered here
    rating = elo.initialize_rookie("NEW", "T1", teams)
    assert rating != 1500.0 - 50.0
    assert rating == pytest.approx(elo.get_rating("AAA") - 50.0)


def test_predictor_rookie_hook(tmp_path):
    """prepare_weekend with rookie_prior=True seeds an unrated driver of the
    weekend's field from the teammate prior."""
    predictor = _predictor(tmp_path, rookie_prior=True)
    plan = predictor.prepare_weekend(2024, "Bahrain")
    victim = plan.drivers[0]
    team = cfg.DRIVER_TEAMS.get(victim)
    # drop only the interning entry: re-interning appends a fresh row
    predictor.elo_system._ids.pop(victim)
    assert not predictor.elo_system.has_rating(victim)
    predictor.prepare_weekend(2024, "Bahrain")
    assert predictor.elo_system.has_rating(victim)
    teammates = [d for d, t in cfg.DRIVER_TEAMS.items() if t == team and d != victim]
    expected = (np.mean([predictor.elo_system.get_rating(t) for t in teammates]) - 50.0
                if teammates else 1350.0)
    assert predictor.elo_system.get_rating(victim) == pytest.approx(expected)
