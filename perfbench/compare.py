"""The numbers a check compares: the program's outputs against the plain
reference's, each as one worst gap. A structure that differs (another
field, driver or key) reads infinity, which no limit passes.
"""

from __future__ import annotations

import math

import numpy as np

INF = math.inf
# SimParams fields, the grid apart (`grid_gap`)
PLAN_FIELDS = ("base_pace", "tire_deg", "variance", "dnf_rate", "team_dnf_rate", "active",
               "pit_loss", "overtake_delta", "drs_delta", "sc_prob", "vsc_prob",
               "red_flag_prob", "dirty_air_threshold", "dirty_air_penalty", "track_condition",
               "compound_pace", "compound_deg", "compound_optimal")


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach") else x, np.float64)


def plan_gap(plan, ref) -> float:
    """The worst relative gap over the plan's SimParams fields but the
    grid: per field, max |a - b| over max |b| (the absolute gap where the
    reference field is all zero). Another field of drivers or lap count:
    infinity."""
    if list(plan.drivers) != list(ref.drivers) or plan.total_laps != ref.total_laps:
        return INF
    worst = 0.0
    for name in PLAN_FIELDS:
        a, b = _np(getattr(plan.params, name)), _np(getattr(ref.params, name))
        if a.shape != b.shape:
            return INF
        scale = float(np.max(np.abs(b))) if b.size else 0.0
        gap = float(np.max(np.abs(a - b))) if b.size else 0.0
        worst = max(worst, gap / scale if scale > 0 else gap)
    return worst


def grid_gap(plan, ref) -> float:
    """The worst gap of a qualifying position probability (the plan's
    (D, D) grid), and of the plan's quali probabilities behind it."""
    if list(plan.drivers) != list(ref.drivers):
        return INF
    a, b = _np(plan.params.grid_probs), _np(ref.params.grid_probs)
    if a.shape != b.shape:
        return INF
    q = max((float(np.max(np.abs(np.asarray(plan.quali_probs[d]) - np.asarray(ref.quali_probs[d]))))
             for d in ref.drivers), default=0.0)
    return max(float(np.max(np.abs(a - b))), q)


def number_gap(a, b) -> float:
    """The worst gap between two nested structures of numbers (dicts with
    the same keys, lists of one length, numbers); infinity where they differ
    otherwise. Dict keys compare as strings (a JSON body's keys are)."""
    if isinstance(b, dict):
        if not isinstance(a, dict):
            return INF
        ka, kb = {str(k): v for k, v in a.items()}, {str(k): v for k, v in b.items()}
        if ka.keys() != kb.keys():
            return INF
        return max((number_gap(ka[k], kb[k]) for k in kb), default=0.0)
    if isinstance(b, (list, tuple)):
        if not isinstance(a, (list, tuple)) or len(a) != len(b):
            return INF
        return max((number_gap(x, y) for x, y in zip(a, b)), default=0.0)
    if isinstance(b, bool) or b is None or isinstance(b, str):
        return 0.0 if a == b else INF
    if isinstance(a, bool) or not isinstance(a, (int, float)):
        return INF
    if math.isnan(a) or math.isnan(b):
        return 0.0 if math.isnan(a) and math.isnan(b) else INF
    return abs(float(a) - float(b))


RESULT_KEYS = ("pole_probabilities", "win_probabilities", "podium_probabilities",
               "full_distributions", "weather", "prediction_point", "confidence",
               "grid_is_actual", "n_simulations_effective")


# the result's fields that no race simulation sets: they follow from the plan
FIXED_KEYS = ("pole_probabilities", "weather", "prediction_point", "confidence",
              "grid_is_actual", "n_simulations_effective")


def fixed_gap(result: dict, ref: dict) -> float:
    """The worst gap over the fields of a result that no race simulation
    sets (`FIXED_KEYS`); infinity where one is missing."""
    if not all(k in result for k in FIXED_KEYS):
        return INF
    return max(number_gap(result[k], ref[k]) for k in FIXED_KEYS)


def _dense(dists: dict, drivers) -> np.ndarray:
    """`full_distributions` ({driver: {position: probability}}, a position
    left out where it has no probability) as a (drivers, positions) array."""
    out = np.zeros((len(drivers), len(drivers)))
    for i, d in enumerate(drivers):
        for pos, prob in dists[d].items():
            out[i, int(pos) - 1] = prob
    return out


def result_gap(result: dict, ref: dict) -> float:
    """The worst gap over an assembled weekend result's fields, the finish
    distributions compared position by position."""
    if not all(k in result for k in RESULT_KEYS):
        return INF
    drivers = list(ref["full_distributions"])
    if list(result["full_distributions"]) != drivers:
        return INF
    try:
        dists = float(np.max(np.abs(_dense(result["full_distributions"], drivers)
                                    - _dense(ref["full_distributions"], drivers))))
    except (ValueError, IndexError, TypeError, AttributeError):
        return INF
    return max([dists] + [number_gap(result[k], ref[k]) for k in RESULT_KEYS
                          if k != "full_distributions"])


def scores_gap(scores: dict, ref: dict) -> float:
    """The worst gap of a season's Brier scores, infinity where it scored
    another number of races. The podium accuracy and the calibration bins
    are counts over the per-race predictions, which `result` compares;
    compared again here they would jump by a whole count."""
    if scores.get("n_races") != ref.get("n_races"):
        return INF
    return max(number_gap(scores[k], ref[k]) for k in ("pole_brier", "win_brier"))
