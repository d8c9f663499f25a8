"""The port's gradient-boosted qualifying model
(`monte_carlo_gp_torch.models.ml`) against the JAX package's
(`monte_carlo_gp_tpu.models.ml`): host code on numpy, pandas and
scikit-learn, so the training frames, the fitted ensembles' gaps and the
grid probabilities are exactly equal (tolerance: none) for the same
scikit-learn and numpy seed; and twins of tests/test_ml.py on the port.
The predictor's gbm path is in tests/test_torch_ml_predictor.py.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from monte_carlo_gp_torch.models import ml as M
from monte_carlo_gp_tpu.models import ml as JM
from torch_quali_world import DRIVERS, TEAM_OF
from torch_quali_world import world as _world

torch.set_num_threads(2)


def _two_event_archive():
    # event 1 (c1): A 80.0 (pole), B 80.8, gap 1.0%; event 2 (c2): A 91.8
    # (gap 2.0%), B 90.0 (pole)
    return pd.DataFrame(dict(
        Driver=["A", "B", "A", "B"], Team=["X", "Y", "X", "Y"],
        circuit=["c1", "c1", "c2", "c2"], LapTime=[80.0, 80.8, 91.8, 90.0],
        season=[1, 1, 1, 1], session_type=["Q"] * 4,
    ))


@pytest.fixture(scope="module")
def fitted():
    """(laps, the port's model, the JAX package's model), fitted on the
    world."""
    laps, _ = _world()
    return laps, M.GBMQualiModel().fit(laps), JM.GBMQualiModel().fit(laps)


# ------------------------------------------------------------ against the JAX package


@pytest.mark.parametrize("archive", ["world", "two_events"])
def test_training_frame_equals_jax(archive):
    laps = _world()[0] if archive == "world" else _two_event_archive()
    got, want = M.build_training_frame(laps), JM.build_training_frame(laps)
    pd.testing.assert_frame_equal(got.X, want.X)
    pd.testing.assert_frame_equal(got.meta, want.meta)
    np.testing.assert_array_equal(got.y, want.y)
    assert got.y.dtype == want.y.dtype
    assert got.agg == want.agg


def test_current_features_equal_jax():
    laps = _world()[0]
    field = DRIVERS + ["ROOKIE"]
    teams = dict(TEAM_OF, ROOKIE=None)
    for circuit in ("C0", "NEW_CIRCUIT"):
        pd.testing.assert_frame_equal(M._current_features(laps, field, teams, circuit),
                                      JM._current_features(laps, field, teams, circuit))


def test_probabilities_equal_jax_exactly(fitted):
    laps, model, ref = fitted
    assert model._resid_sigma == ref._resid_sigma
    np.testing.assert_array_equal(model.predict_gaps(laps, DRIVERS, TEAM_OF, "C0"),
                                  ref.predict_gaps(laps, DRIVERS, TEAM_OF, "C0"))
    field, teams = DRIVERS + ["ROOKIE"], dict(TEAM_OF, ROOKIE=None)
    for circuit, seed in (("C0", 3), ("C4", 11), ("NEW_CIRCUIT", 3)):
        assert model.predict(laps, field, teams, circuit, seed=seed) == ref.predict(
            laps, field, teams, circuit, seed=seed)


# ------------------------------------------------------------ twins of tests/test_ml.py


def test_training_frame_targets_and_chronology():
    data = M.build_training_frame(_two_event_archive())
    assert list(data.meta["circuit"]) == ["c1", "c1", "c2", "c2"]
    np.testing.assert_allclose(data.y, [0.0, 1.0, 2.0, 0.0], atol=1e-6)
    first = data.X.iloc[0]
    assert np.isnan(first["career_gap"]) and first["n_events"] == 0.0
    row_a2 = data.X.iloc[2]
    assert row_a2["last_gap"] == pytest.approx(0.0)
    assert row_a2["career_gap"] == pytest.approx(0.0)
    assert row_a2["team_gap"] == pytest.approx(0.0)
    assert row_a2["n_events"] == 1.0
    assert data.X.iloc[3]["career_gap"] == pytest.approx(1.0)
    assert np.isnan(row_a2["circuit_gap"])


def test_training_frame_is_append_only():
    """Rows of early events are bitwise unchanged when later events are
    appended (the leakage pin)."""
    laps, _ = _world()
    events = list(laps.groupby("circuit", sort=False).groups)
    full = M.build_training_frame(laps)
    part = M.build_training_frame(laps[laps["circuit"].isin(events[:3])])
    n = len(part.y)
    pd.testing.assert_frame_equal(full.X.iloc[:n], part.X)
    np.testing.assert_array_equal(full.y[:n], part.y)


def test_training_frame_raises_on_empty():
    with pytest.raises(ValueError, match="No valid lap times"):
        M.build_training_frame(pd.DataFrame())


def test_fit_requires_enough_rows():
    with pytest.raises(ValueError, match="not enough training rows"):
        M.GBMQualiModel().fit(_two_event_archive())


def test_predict_reuses_fit_aggregates(monkeypatch):
    laps = _world()[0].copy()
    laps.attrs["_mcgp_loader_token"] = object()
    model = M.GBMQualiModel().fit(laps)
    before = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=1)

    def boom(*a, **k):
        raise AssertionError("archive re-folded at predict time")

    monkeypatch.setattr(M, "_event_best_gaps", boom)
    assert model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=1) == before


def test_predict_distributions(fitted):
    laps, model, _ = fitted
    probs = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=3)
    arr = np.array([probs[d] for d in DRIVERS])
    assert arr.shape == (len(DRIVERS), len(DRIVERS))
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    np.testing.assert_allclose(arr.sum(axis=0), 1.0, atol=1e-9)
    assert (arr >= 0).all()


def test_predicted_gaps_track_observed_pace(fitted):
    laps, model, _ = fitted
    mu = model.predict_gaps(laps, DRIVERS, TEAM_OF, "C0")
    fastest = laps.groupby("circuit")["LapTime"].transform("min")
    gap = (laps["LapTime"] - fastest) / fastest * 100.0
    observed = gap.groupby(laps["Driver"]).mean().reindex(DRIVERS).to_numpy()
    assert np.corrcoef(mu, observed)[0, 1] > 0.9


def test_predict_handles_rookie_and_unseen_circuit(fitted):
    laps, model, _ = fitted
    field = DRIVERS + ["ROOKIE"]
    probs = model.predict(laps, field, dict(TEAM_OF, ROOKIE=None), "NEW_CIRCUIT", seed=3)
    arr = np.array([probs[d] for d in field])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-9)
    assert np.isfinite(arr).all()


def test_predict_is_seed_deterministic(fitted):
    laps, model, _ = fitted
    a = model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=3)
    assert a == model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=3)
    assert a != model.predict(laps, DRIVERS, TEAM_OF, "C0", seed=4)


def test_fit_cached_per_archive_token():
    laps = _world()[0].copy()
    laps.attrs["_mcgp_loader_token"] = object()
    model = M.GBMQualiModel().fit(laps)
    first = model._models
    model._ensure_fit(laps)
    assert model._models is first  # cached
    rebuilt = laps.copy()
    rebuilt.attrs["_mcgp_loader_token"] = object()
    model._ensure_fit(rebuilt)
    assert model._models is not first  # walk-forward rebuild: refit
