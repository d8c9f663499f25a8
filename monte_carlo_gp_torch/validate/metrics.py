"""Quality metrics — a copy of `monte_carlo_gp_tpu.validate.metrics`, with
the reference implementation's definitions (its src/validation.py:82-158);
these are the acceptance tests for the whole framework (SURVEY.md §5)."""

from __future__ import annotations

import numpy as np

from monte_carlo_gp_torch.utils.logging import log_event

RANDOM_BRIER_BASELINE = 0.0475  # 20-driver random guess (backtest.py:56-59)


def brier_score(predictions: list[dict], actuals: list[str | None]) -> float:
    """Mean per-race Brier score (validation.py:82-106): per race, the mean
    over drivers of (p - outcome)^2; races with no actual or empty/invalid
    predictions are skipped; 1.0 when nothing scores."""
    race_scores = []
    for pred, actual in zip(predictions, actuals):
        if actual is None or not pred:
            continue
        probs = list(pred.values())
        if not all(0 <= p <= 1 for p in probs):
            log_event(
                "invalid_probabilities",
                detail="brier input not in [0,1], race skipped",
            )
            continue
        score = sum(
            (p - (1.0 if d == actual else 0.0)) ** 2 for d, p in pred.items()
        )
        race_scores.append(score / len(pred))
    return float(np.mean(race_scores)) if race_scores else 1.0


def podium_accuracy(predictions: list[dict], actuals: list[dict]) -> float:
    """Set intersection of predicted top-3 vs actual podium, /3 per race
    (validation.py:109-130)."""
    correct = total = 0
    for pred, act in zip(predictions, actuals):
        if not act.get("podium"):
            continue
        podium_probs = pred.get("podium_probabilities", {})
        if not podium_probs:
            continue
        top3 = {
            d
            for d, _ in sorted(
                podium_probs.items(), key=lambda kv: kv[1], reverse=True
            )[:3]
        }
        correct += len(top3 & set(act["podium"]))
        total += 3
    return correct / total if total > 0 else 0.0


def calibration_analysis(predictions: list[dict], actuals: list[dict]) -> dict:
    """Win-probability calibration curve with sample-size-adaptive bins
    (validation.py:133-158)."""
    all_probs, all_outcomes = [], []
    for pred, act in zip(predictions, actuals):
        if not act.get("winner"):
            continue
        win_probs = pred.get("win_probabilities", {})
        for d, p in win_probs.items():
            all_probs.append(p)
            all_outcomes.append(1 if d == act["winner"] else 0)
    if not all_probs:
        return {"prob_true": [], "prob_pred": []}
    n_bins = min(10, max(2, len(all_probs) // 10))
    try:
        from sklearn.calibration import calibration_curve

        prob_true, prob_pred = calibration_curve(
            all_outcomes, all_probs, n_bins=n_bins
        )
        return {"prob_true": prob_true.tolist(), "prob_pred": prob_pred.tolist()}
    except (ImportError, ValueError):
        return _calibration_fallback(all_outcomes, all_probs, n_bins)


def _calibration_fallback(outcomes, probs, n_bins) -> dict:
    """NumPy uniform-bin calibration, used when sklearn is unavailable or the
    sample is degenerate."""
    probs = np.asarray(probs, float)
    outcomes = np.asarray(outcomes, float)
    edges = np.linspace(0.0, 1.0, n_bins + 1)
    idx = np.clip(np.digitize(probs, edges[1:-1]), 0, n_bins - 1)
    prob_true, prob_pred = [], []
    for b in range(n_bins):
        m = idx == b
        if m.any():
            prob_pred.append(float(probs[m].mean()))
            prob_true.append(float(outcomes[m].mean()))
    return {"prob_true": prob_true, "prob_pred": prob_pred}
