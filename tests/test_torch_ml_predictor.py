"""The port's gradient-boosted qualifying model as the predictor uses it,
on the CPU: the weekend's gbm grid equal to the JAX predictor's, the
predictor's gbm path, the short race name resolved before the circuit
lookup, and the error naming scikit-learn where it cannot be imported
(twins of tests/test_ml.py). The model against the JAX package's is in
tests/test_torch_ml.py.
"""

import sys

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import ml as M

torch.set_num_threads(2)


def test_predictor_gbm_grid_equals_jax_predictor(tmp_path):
    """The weekend's gbm grid through both predictors (Bahrain 2024, the
    synthetic world, seed 2718): the same archive, the same crc32 noise
    seed, the same grid."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend as JSyntheticBackend
    from monte_carlo_gp_tpu.models.predictor import F1Predictor as JF1Predictor

    port = F1Predictor(cache_dir=tmp_path / "port", backend=SyntheticBackend(seed=2718),
                       device="cpu", quali_model="gbm")
    ref = JF1Predictor(cache_dir=tmp_path / "jax", backend=JSyntheticBackend(seed=2718),
                       engine="xla", quali_model="gbm")
    got, want = port.prepare_weekend(2024, "Bahrain"), ref.prepare_weekend(2024, "Bahrain")
    assert got.drivers == want.drivers
    assert got.quali_probs == want.quali_probs
    np.testing.assert_array_equal(got.params.grid_probs.numpy(), np.asarray(want.params.grid_probs))


def _predictor(tmp_path, n_events=None, **kw):
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    backend = SyntheticBackend(seed=2718) if n_events is None else SyntheticBackend(
        seed=2718, n_events=n_events)
    return F1Predictor(cache_dir=tmp_path, backend=backend, device="cpu", quali_model="gbm", **kw)


def test_predictor_gbm_path_end_to_end(tmp_path):
    p = _predictor(tmp_path)
    plan = p.prepare_weekend(2024, "Bahrain")
    assert isinstance(p._bayes_model, M.GBMQualiModel)
    assert p._bayes_model._models is not None  # the gbm path ran
    arr = np.array([plan.quali_probs[d] for d in plan.drivers])
    np.testing.assert_allclose(arr.sum(axis=1), 1.0, atol=1e-6)
    assert p.prepare_weekend(2024, "Bahrain").quali_probs == plan.quali_probs


def test_short_race_name_resolves_to_archive_circuit(tmp_path):
    """'Bahrain' and the schedule's 'Bahrain Grand Prix' give the same
    grid: the predictor resolves the name before the model's exact-match
    circuit lookup."""
    p = _predictor(tmp_path, n_events=4)
    plan_full = p.prepare_weekend(2024, "Bahrain Grand Prix")
    plan_short = p.prepare_weekend(2024, "Bahrain")
    assert plan_short.quali_probs == plan_full.quali_probs


def test_missing_sklearn_fails_construction_naming_it(monkeypatch, tmp_path):
    """Without scikit-learn the model, and a predictor asked for it, fail
    at construction with an ImportError naming scikit-learn: never a
    mid-weekend import error, never a silent Elo grid."""
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "sklearn", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        M.GBMQualiModel()
    with pytest.raises(ImportError, match="scikit-learn"):
        _predictor(tmp_path)
