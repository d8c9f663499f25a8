"""Shared data preparation and ranking of the two alternative qualifying
models (`models/bayesian.py` and `models/ml.py`).

Both models filter the same archive the same way and turn simulated gap
draws into grid-position distributions with the same Monte Carlo ranking,
so the two stay comparable on one scale. Host code (numpy/pandas); the
results equal `monte_carlo_gp_tpu.models.quali_common`'s.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

_REQUIRED = {"LapTime", "Driver", "Team", "circuit"}


def needs_refit(cached, frame_token, cached_token) -> bool:
    """The walk-forward fit-cache gate of both alternative models (the
    leakage contract: race k's model sees only races < k). Refit when
    nothing is cached, when the frame carries no loader token (a directly
    assigned archive cannot be verified), or when the token's identity
    changed (the loader rebuilt the archive, so the cached fit may have
    seen other data)."""
    return cached is None or frame_token is None or frame_token is not cached_token


def valid_q_rows(laps: pd.DataFrame, session_type: str | None = "Q") -> pd.DataFrame:
    """The archive filter of both models: rows with a positive LapTime and
    a Driver, Team and circuit.

    When `session_type` is given and the archive has the column, the filter
    is strict: an archive with no matching row raises rather than fit a
    qualifying model on race laps; the predictor turns the ValueError into
    its Elo path. An archive without the column trains on every row. Pass
    session_type=None to skip the session filter."""
    if laps.empty or not _REQUIRED.issubset(laps.columns):
        raise ValueError("No valid lap times to build model")
    rows = laps
    if session_type is not None and "session_type" in rows.columns:
        rows = rows[rows["session_type"] == session_type]
        if rows.empty:
            raise ValueError(
                f"no {session_type!r} session laps in the archive to fit "
                "the qualifying model"
            )
    rows = rows.dropna(subset=["LapTime", "Driver", "Team", "circuit"])
    rows = rows[rows["LapTime"] > 0]
    if rows.empty:
        raise ValueError("No valid lap times to build model")
    return rows


def rank_draws_to_probs(draws: np.ndarray, drivers: list[str]) -> dict[str, list[float]]:
    """Monte Carlo ranking to position distributions.

    `draws` is (S, n) simulated gaps (lower is better). Each draw is ranked
    with a stable argsort (ties break by driver index); averaging the
    one-hot grids over the draws gives each driver's position distribution,
    in the `dict[str, list[float]]` form of the Elo qualifying path."""
    n = len(drivers)
    s = draws.shape[0]
    order = np.argsort(draws, axis=1, kind="stable")  # (S, n) driver per rank
    counts = np.zeros((n, n), np.float64)  # (driver, position)
    for p in range(n):
        np.add.at(counts[:, p], order[:, p], 1.0)
    probs = counts / s
    return {d: probs[j].tolist() for j, d in enumerate(drivers)}
