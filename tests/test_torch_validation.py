"""End-to-end accuracy gate for the port, the twin of
tests/test_validation.py::test_synthetic_ground_truth_accuracy_gate: a
synthetic season whose right answer (the latent driver skill) is known is
backtested walk-forward on the CPU, and the port must recover it at the
JAX test's thresholds. `-s` prints rho and the two Brier scores.

Why the Brier bounds sit above the 0.0475 random baseline: the quali model
shapes position probabilities with a sigma = n/4 gaussian, which caps the
favourite's pole probability near 0.11, and the synthetic world's race
outcomes are about half luck, while the engine's world is far more
deterministic (see the JAX test's docstring).
"""

import numpy as np
import torch
from scipy import stats

from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.validate.backtest import (
    _pin,
    _race_cutoffs,
    get_actual_results,
    get_races,
)
from monte_carlo_gp_torch.validate.metrics import brier_score

torch.set_num_threads(2)


def test_synthetic_ground_truth_accuracy_gate(tmp_path):
    n_events = 12
    backend = SyntheticBackend(seed=5, n_events=n_events)
    predictor = F1Predictor(cache_dir=tmp_path, backend=backend, device="cpu")
    loader = predictor.data_loader

    races = get_races(loader, 2024)
    cutoffs = _race_cutoffs(loader, 2024)
    preds, acts = [], []
    for idx, race in enumerate(races):
        _pin(loader, cutoffs, idx, True)
        preds.append(predictor.predict_weekend(2024, race, n_simulations=1024, seed=idx))
        act = get_actual_results(loader, 2024, race)
        acts.append(act)
        predictor.elo_system.update_quali_ratings(act["quali_results"])
        predictor.elo_system.update_race_ratings(act["race_results"])
    assert len(preds) == n_events

    drivers = backend.drivers
    skill = backend._skill(2024)  # lower = faster

    # (1) mean predicted win probability recovers the latent skill ranking
    mean_win = np.array(
        [np.mean([p["win_probabilities"].get(d, 0.0) for p in preds]) for d in drivers]
    )
    rho = stats.spearmanr(mean_win, -skill).statistic

    # (2) favourites hit far above the ~15% chance rate
    pole_hits = win_top3 = 0
    for p, a in zip(preds, acts):
        pole_fav = max(p["pole_probabilities"], key=p["pole_probabilities"].get)
        win_fav = max(p["win_probabilities"], key=p["win_probabilities"].get)
        pole_hits += pole_fav in a["quali_results"][:3]
        win_top3 += win_fav in a["race_results"][:3]

    # (3) Brier regression bounds
    pole_brier = brier_score([p["pole_probabilities"] for p in preds], [a["pole"] for a in acts])
    win_brier = brier_score([p["win_probabilities"] for p in preds], [a["winner"] for a in acts])
    print(f"\naccuracy gate: rho {rho} pole_hits {pole_hits}/{n_events} "
          f"win_top3 {win_top3}/{n_events} pole_brier {pole_brier} win_brier {win_brier}")

    assert rho > 0.7, (rho, dict(zip(drivers, mean_win)))
    assert pole_hits / n_events >= 1 / 3, (pole_hits, n_events)
    assert win_top3 / n_events >= 1 / 3, (win_top3, n_events)
    assert pole_brier < 0.06, pole_brier
    assert win_brier < 0.095, win_brier
