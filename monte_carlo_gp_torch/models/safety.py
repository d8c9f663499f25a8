"""Prediction-failure safety net: typed errors + uniform fallback.

The reference's design doc specifies (but never ships) a fallback-prediction
wrapper: a `PredictionError`/`InsufficientDataError` hierarchy, a
`safe_predict` wrapper that degrades to uniform predictions when the data
layer comes up empty, and `generate_fallback_predictions` producing a
result dict of the same shape as `predict_weekend`
(reference plan.md:2674-2760; the shipped code just raises — e.g. the
empty-practice ValueError path, reference src/predictor.py:188-190).
This module implements that contract for real.

Everything here is host-side orchestration (no device work): the fallback
is a closed-form uniform distribution, not a simulation.
"""

from __future__ import annotations

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.utils.logging import get_logger, log_event

__all__ = [
    "PredictionError",
    "InsufficientDataError",
    "generate_fallback_predictions",
    "safe_predict",
]


class PredictionError(Exception):
    """Base exception for prediction failures (plan.md:2678-2681)."""


class InsufficientDataError(PredictionError, ValueError):
    """Not enough data to make a prediction (plan.md:2683-2685).

    Also a ValueError so callers written against the pre-existing
    `raise ValueError("No practice data ...")` contract keep working.
    """


# Weather defaults mirror the fallback spec (plan.md:2742, :2755): a mild
# dry baseline, used only when the data layer produced nothing at all.
_FALLBACK_WEATHER = {
    "air_temp": 25,
    "track_temp": 35,
    "humidity": 50,
    "rainfall": False,
    "wind_speed": 5,
}


def generate_fallback_predictions(
    season: int,
    race: str,
    prediction_point: str = "fp2",
    drivers: list[str] | None = None,
) -> dict:
    """Uniform predictions when data is unavailable (plan.md:2726-2760).

    Args:
      season / race: identify the weekend (recorded for the caller; the
        uniform distribution itself is weekend-independent).
      prediction_point: echoed into the result.
      drivers: field to predict over; defaults to the configured
        `DRIVER_TEAMS` roster (plan.md:2729).

    Returns a dict with the same keys as `F1Predictor.predict_weekend`,
    plus ``fallback=True`` and ``confidence='none'``. Pole/win are uniform
    1/n; podium is min(3/n, 1); the full distribution is uniform over
    positions 1..n.
    """
    del season, race  # shape is data-free; args kept for call-site symmetry
    if drivers is None:
        drivers = list(cfg.DRIVER_TEAMS.keys())
    n = len(drivers)
    if n == 0:
        return {
            "pole_probabilities": {},
            "win_probabilities": {},
            "podium_probabilities": {},
            "full_distributions": {},
            "weather": dict(_FALLBACK_WEATHER),
            "fallback": True,
            "prediction_point": prediction_point,
            "confidence": "none",
            "grid_is_actual": False,
            "n_simulations_effective": 0,
        }
    uniform = 1.0 / n
    podium = min(3.0 / n, 1.0)
    return {
        "pole_probabilities": {d: uniform for d in drivers},
        "win_probabilities": {d: uniform for d in drivers},
        "podium_probabilities": {d: podium for d in drivers},
        "full_distributions": {
            d: {p: uniform for p in range(1, n + 1)} for d in drivers
        },
        "weather": dict(_FALLBACK_WEATHER),
        "fallback": True,
        "prediction_point": prediction_point,
        "confidence": "none",
        "grid_is_actual": False,
        # Real predictions always carry this (predictor.assemble_result);
        # consumers reading it must not crash exactly on the degraded path.
        "n_simulations_effective": 0,
    }


def safe_predict(
    predictor,
    season: int,
    race: str,
    grid_penalties: dict | None = None,
    prediction_point: str = "fp2",
    actual_grid: dict[str, int] | None = None,
    **predict_kwargs,
) -> dict | None:
    """`predict_weekend` with graceful degradation (plan.md:2687-2724).

    InsufficientDataError -> uniform fallback predictions (flagged
    ``fallback=True``); any other exception -> log and return None.
    Extra keyword arguments (``n_simulations``, ``seed``, ...) pass through.
    """
    try:
        return predictor.predict_weekend(
            season,
            race,
            grid_penalties=grid_penalties,
            prediction_point=prediction_point,
            actual_grid=actual_grid,
            **predict_kwargs,
        )
    except InsufficientDataError as e:
        get_logger().warning("%s, using fallback predictions", e)
        log_event("prediction_fallback", season=season, race=race, reason=str(e))
        return generate_fallback_predictions(season, race, prediction_point)
    except Exception as e:  # noqa: BLE001 — the wrapper's contract is "never raise"
        get_logger().error("Error predicting %s: %s", race, e)
        log_event("prediction_error", season=season, race=race, reason=str(e))
        return None
