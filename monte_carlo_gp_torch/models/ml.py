"""Gradient-boosted qualifying model.

The host copy of `monte_carlo_gp_tpu.models.ml`: scikit-learn's
`HistGradientBoostingRegressor` (histogram-binned gradient-boosted trees,
native NaN handling) over leakage-free features of the qualifying archive,
five expanding-window folds, the ensemble kept. Its results equal the JAX
package's for the same scikit-learn and numpy.

The training rows come from one chronological pass over the archive: each
(event, driver) row's features are running aggregates over strictly
earlier events, so appending later events cannot change an earlier row.
The response is the driver's best lap's percentage gap to the event's
pole, the Bayesian model's scale. Prediction turns the point regression
into grid-position distributions by Monte Carlo ranking under the
out-of-fold residual noise.

scikit-learn is an optional dependency of the package: constructing the
model raises `ImportError` naming scikit-learn where it cannot be imported,
so a predictor asked for this model fails before any work.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pandas as pd

from monte_carlo_gp_torch.models.quali_common import (
    needs_refit,
    rank_draws_to_probs,
    valid_q_rows,
)
from monte_carlo_gp_torch.utils.logging import log_event

FORM_WINDOW = 5  # rolling form over the driver's last 5 events

FEATURES = [
    "last_gap",  # previous event's gap
    "form_gap",  # mean gap over the last FORM_WINDOW events
    "career_gap",  # running mean over all prior events
    "team_gap",  # running mean of the driver's team (teammates pooled)
    "teammate_delta",  # career_gap - team_gap (negative = faster than car)
    "circuit_gap",  # running mean at this circuit
    "n_events",  # prior-event count (experience)
]


@dataclasses.dataclass(frozen=True)
class QualiTrainingData:
    """Chronological training rows: X[i]'s aggregates see only events
    before row i's."""

    X: pd.DataFrame  # (N, len(FEATURES)), NaN where no history exists
    y: np.ndarray  # (N,) float32 gap-to-pole percent at the row's event
    meta: pd.DataFrame  # (N,) Driver / Team / season / circuit per row
    # the aggregate state after folding the whole archive: what the
    # prediction-time features need, so predict need not fold it again
    agg: dict = dataclasses.field(default_factory=dict, repr=False)


def _event_best_gaps(laps: pd.DataFrame, session_type: str | None = "Q"):
    """Per (event, driver): the best lap's percentage gap to the event's
    pole, in the archive's chronological event order, as (season, circuit,
    {driver: (gap, team)}) tuples."""
    rows = valid_q_rows(laps, session_type)
    if "season" not in rows.columns:
        rows = rows.assign(season=0)

    events = []
    # groupby(sort=False) keeps the archive's chronological first-appearance
    # order (the loader emits past events in order, seasons ascending)
    for (season, circuit), ev in rows.groupby(["season", "circuit"], sort=False):
        best = ev.groupby("Driver", sort=False).agg(
            lap=("LapTime", "min"), Team=("Team", "last")
        )
        pole = float(best["lap"].min())
        gaps = {
            d: (float((r.lap - pole) / pole * 100.0), r.Team)
            for d, r in best.iterrows()
        }
        events.append((season, circuit, gaps))
    return events


def build_training_frame(
    laps: pd.DataFrame, session_type: str | None = "Q"
) -> QualiTrainingData:
    """One chronological pass over the archive to leakage-free rows.

    The running aggregates (driver form and career, team pool,
    driver-at-circuit) are read to form event e's rows and only then updated
    with event e's outcomes. First appearances get NaN features, which the
    regressor takes natively."""
    events = _event_best_gaps(laps, session_type)

    hist: dict[str, list[float]] = {}  # driver -> prior gaps (chronological)
    team_sum: dict[str, float] = {}
    team_n: dict[str, int] = {}
    circ_sum: dict[tuple, float] = {}
    circ_n: dict[tuple, int] = {}

    feats, targets, meta = [], [], []
    last_team: dict[str, str] = {}
    for season, circuit, gaps in events:
        # read: features from strictly earlier events
        for d, (gap, team) in gaps.items():
            h = hist.get(d, [])
            career = float(np.mean(h)) if h else np.nan
            tg = team_sum[team] / team_n[team] if team_n.get(team) else np.nan
            ck = (d, circuit)
            feats.append(
                {
                    "last_gap": h[-1] if h else np.nan,
                    "form_gap": float(np.mean(h[-FORM_WINDOW:])) if h else np.nan,
                    "career_gap": career,
                    "team_gap": tg,
                    "teammate_delta": career - tg
                    if h and team_n.get(team)
                    else np.nan,
                    "circuit_gap": circ_sum[ck] / circ_n[ck]
                    if circ_n.get(ck)
                    else np.nan,
                    "n_events": float(len(h)),
                }
            )
            targets.append(gap)
            meta.append(
                {"Driver": d, "Team": team, "season": season, "circuit": circuit}
            )
        # update: fold event e into the aggregates
        for d, (gap, team) in gaps.items():
            hist.setdefault(d, []).append(gap)
            team_sum[team] = team_sum.get(team, 0.0) + gap
            team_n[team] = team_n.get(team, 0) + 1
            ck = (d, circuit)
            circ_sum[ck] = circ_sum.get(ck, 0.0) + gap
            circ_n[ck] = circ_n.get(ck, 0) + 1
            last_team[d] = team

    return QualiTrainingData(
        X=pd.DataFrame(feats, columns=FEATURES),
        y=np.asarray(targets, np.float32),
        meta=pd.DataFrame(meta),
        agg={
            "hist": hist,
            "team_sum": team_sum,
            "team_n": team_n,
            "circ_sum": circ_sum,
            "circ_n": circ_n,
            "last_team": last_team,
        },
    )


def _current_features(
    laps: pd.DataFrame,
    drivers: list[str],
    driver_teams: dict[str, str | None],
    circuit: str,
    session_type: str | None = "Q",
    agg: dict | None = None,
) -> pd.DataFrame:
    """Feature rows of a weekend field as of now: the training pass's
    aggregates folded over the whole archive. Unknown drivers and teams
    give NaN features. `agg` (QualiTrainingData.agg) skips the fold."""
    if agg is None:
        agg = build_training_frame(laps, session_type).agg
    hist: dict[str, list[float]] = agg["hist"]
    team_sum: dict[str, float] = agg["team_sum"]
    team_n: dict[str, int] = agg["team_n"]
    circ_sum: dict[tuple, float] = agg["circ_sum"]
    circ_n: dict[tuple, int] = agg["circ_n"]
    last_team: dict[str, str] = agg["last_team"]

    rows = []
    for d in drivers:
        h = hist.get(d, [])
        career = float(np.mean(h)) if h else np.nan
        team = driver_teams.get(d) or last_team.get(d)
        tg = (
            team_sum[team] / team_n[team]
            if team is not None and team_n.get(team)
            else np.nan
        )
        ck = (d, circuit)
        rows.append(
            {
                "last_gap": h[-1] if h else np.nan,
                "form_gap": float(np.mean(h[-FORM_WINDOW:])) if h else np.nan,
                "career_gap": career,
                "team_gap": tg,
                "teammate_delta": career - tg
                if h and team is not None and team_n.get(team)
                else np.nan,
                "circuit_gap": circ_sum[ck] / circ_n[ck]
                if circ_n.get(ck)
                else np.nan,
                "n_events": float(len(h)),
            }
        )
    return pd.DataFrame(rows, columns=FEATURES, index=drivers)


def _sklearn():
    """(HistGradientBoostingRegressor, TimeSeriesSplit), or ImportError
    naming scikit-learn."""
    try:
        ensemble = importlib.import_module("sklearn.ensemble")
        model_selection = importlib.import_module("sklearn.model_selection")
    except ImportError as e:
        raise ImportError(
            "quali_model='gbm' needs scikit-learn (HistGradientBoostingRegressor), "
            f"which cannot be imported here ({e}); install scikit-learn or use "
            "the 'elo' or 'bayesian' qualifying model"
        ) from e
    return ensemble.HistGradientBoostingRegressor, model_selection.TimeSeriesSplit


class GBMQualiModel:
    """TimeSeriesSplit-ensembled gradient boosting over the qualifying
    archive: 5 expanding-window folds, one early-stopped regressor per fold,
    prediction averaging the folds; each fold's validation rows give the
    out-of-fold residuals behind the prediction noise.

    The fit is cached on the archive frame's loader token, as
    BayesianQualiModel's: a walk-forward backtest refits per race, repeated
    predictions of one weekend reuse the ensemble."""

    def __init__(
        self,
        n_splits: int = 5,
        max_iter: int = 1000,
        learning_rate: float = 0.05,
        max_leaf_nodes: int = 31,
        n_grid_draws: int = 2000,
        seed: int = 42,
    ):
        self._regressor, self._splitter = _sklearn()
        self.n_splits = n_splits
        self.max_iter = max_iter
        self.learning_rate = learning_rate
        self.max_leaf_nodes = max_leaf_nodes
        self.n_grid_draws = n_grid_draws
        self.seed = seed
        self._models: list | None = None
        self._agg: dict | None = None
        self._resid_sigma: float | None = None
        self._token: object | None = None

    def fit(self, laps: pd.DataFrame) -> "GBMQualiModel":
        data = build_training_frame(laps)
        n = len(data.y)
        n_splits = min(self.n_splits, max(2, n // 20)) if n >= 40 else 2
        if n < 2 * (n_splits + 1):
            raise ValueError(
                f"not enough training rows for TimeSeriesSplit "
                f"(need >= {2 * (n_splits + 1)}, archive has {n})"
            )
        tscv = self._splitter(n_splits=n_splits)
        models, residuals = [], []
        for train_idx, val_idx in tscv.split(data.X):
            Xt = data.X.iloc[train_idx]
            # early folds can have a column with no observed value yet (e.g.
            # circuit_gap before any circuit repeats), which the binner
            # rejects: fit each fold on the columns it has seen
            cols = [c for c in Xt.columns if Xt[c].notna().any()]
            m = self._regressor(
                loss="squared_error",
                learning_rate=self.learning_rate,
                max_leaf_nodes=self.max_leaf_nodes,
                max_iter=self.max_iter,
                # the default 20 forbids any split on the small early folds
                min_samples_leaf=int(max(2, min(20, len(train_idx) // 8))),
                early_stopping=True,
                validation_fraction=0.15,
                n_iter_no_change=50,
                random_state=self.seed,
            )
            m.fit(Xt[cols], data.y[train_idx])
            models.append((m, cols))
            residuals.append(data.y[val_idx] - m.predict(data.X.iloc[val_idx][cols]))
        self._models = models
        self._agg = data.agg
        pooled = np.concatenate(residuals)
        # RMS about zero, not np.std: a systematic bias of the early folds
        # belongs in the honest prediction-error spread sqrt(var + bias²)
        self._resid_sigma = float(max(np.sqrt(np.mean(np.square(pooled))), 1e-3))
        self._token = laps.attrs.get("_mcgp_loader_token")
        log_event(
            "gbm_quali_fit",
            rows=n,
            folds=len(models),
            resid_sigma=self._resid_sigma,
        )
        return self

    def _ensure_fit(self, laps: pd.DataFrame) -> None:
        token = laps.attrs.get("_mcgp_loader_token")
        if needs_refit(self._models, token, self._token):
            self.fit(laps)

    def predict_gaps(
        self,
        laps: pd.DataFrame,
        drivers: list[str],
        driver_teams: dict[str, str | None],
        circuit: str,
    ) -> np.ndarray:
        """Fold-ensemble mean predicted gap-to-pole percent per driver."""
        self._ensure_fit(laps)
        # the token cache guarantees self._agg was folded from this archive
        X = _current_features(laps, drivers, driver_teams, circuit, agg=self._agg)
        preds = np.stack([m.predict(X[cols]) for m, cols in self._models])
        return preds.mean(axis=0)

    def predict(
        self,
        laps: pd.DataFrame,
        drivers: list[str],
        driver_teams: dict[str, str | None],
        circuit: str,
        seed: int = 0,
    ) -> dict[str, list[float]]:
        """Grid-position distributions: Monte Carlo ranking of the point
        predictions under the out-of-fold residual noise."""
        n = len(drivers)
        if n == 0:
            return {}
        mu = self.predict_gaps(laps, drivers, driver_teams, circuit)
        rng = np.random.default_rng(seed)
        draws = mu[None, :] + self._resid_sigma * rng.standard_normal(
            (self.n_grid_draws, n)
        )
        return rank_draws_to_probs(draws, drivers)
