"""The season walk-forward's host side and its scores: a frozen copy of
`monte_carlo_gp_torch/validate/backtest.py`'s `prepare_season_plans`,
`score_season_plans`, `_score` and their helpers as the port had them when
the benchmark was written.
"""

from __future__ import annotations

import pandas as pd

from perfbench.reference.metrics import brier_score, calibration_analysis, podium_accuracy


def log_event(*_args, **_kwargs) -> None:
    """The frozen copy logs nothing."""


def get_races(loader, season: int) -> list[str]:
    """Past, non-testing event names for a season (validation.py:8-27)."""
    return [ev["EventName"] for ev in loader.past_events(season)]


def _race_cutoffs(loader, season: int) -> list[pd.Timestamp]:
    """Per-race clock cutoffs: just before each event's date, so pinning the
    loader there exposes only races strictly earlier in the calendar.

    Dateless (NaT) events back-fill from the nearest EARLIER cutoff — or the
    season's Jan 1 for a dateless opener — which can only hide information,
    never leak it.

    Race-day weather is deliberately NOT covered by the pin: the reference
    predicts with the actual race-session weather standing in for a
    pre-race forecast, and `load_session`/`get_weather` are clock-free by
    design (PARITY.md divergence #4)."""
    cutoffs: list[pd.Timestamp] = []
    fallback = pd.Timestamp(f"{season}-01-01", tz="UTC")
    for ev in loader.past_events(season):
        date = ev.get("EventDate")
        if date is None or pd.isna(date):
            cutoffs.append(cutoffs[-1] if cutoffs else fallback)
            continue
        date = pd.to_datetime(date)
        if date.tzinfo is None:
            date = date.tz_localize("UTC")
        cutoffs.append(date - pd.Timedelta(seconds=1))
    return cutoffs


def _pin(loader, cutoffs, idx: int, enabled: bool) -> None:
    if enabled and idx < len(cutoffs):
        loader.set_now(cutoffs[idx])


def get_actual_results(loader, season: int, race: str) -> dict:
    """Pole / winner / podium plus ordered result lists for Elo updates
    (validation.py:30-79)."""
    pole = winner = None
    podium: list[str] = []
    quali_results: list[str] = []
    race_results: list[str] = []

    q = loader.load_results(season, race, "Q")
    if q is not None and not q.empty and "Position" in q.columns:
        q_valid = q.dropna(subset=["Position"]).copy()
        if not q_valid.empty:
            q_valid["Position"] = q_valid["Position"].astype(int)
            ordered = q_valid.sort_values("Position")
            quali_results = ordered["Abbreviation"].tolist()
            top = ordered[ordered["Position"] == 1]
            pole = top["Abbreviation"].iloc[0] if not top.empty else None

    r = loader.load_results(season, race, "R")
    if r is not None and not r.empty and "Position" in r.columns:
        r_valid = r.dropna(subset=["Position"]).copy()
        if not r_valid.empty:
            r_valid["Position"] = r_valid["Position"].astype(int)
            ordered = r_valid.sort_values("Position")
            race_results = ordered["Abbreviation"].tolist()
            top = ordered[ordered["Position"] == 1]
            winner = top["Abbreviation"].iloc[0] if not top.empty else None
            podium = ordered[ordered["Position"] <= 3]["Abbreviation"].tolist()

    return {
        "pole": pole,
        "winner": winner,
        "podium": podium,
        "quali_results": quali_results,
        "race_results": race_results,
    }


def _score(predictions: list, actuals: list) -> dict:
    """The result dict both backtest entry points return (reference
    validation.py:203-209) — ONE assembly so a scored-key change cannot
    desynchronize the sequential and batched paths."""
    return {
        "pole_brier": brier_score(
            [p["pole_probabilities"] for p in predictions],
            [a["pole"] for a in actuals],
        ),
        "win_brier": brier_score(
            [p["win_probabilities"] for p in predictions],
            [a["winner"] for a in actuals],
        ),
        "podium_accuracy": podium_accuracy(predictions, actuals),
        "calibration_curve": calibration_analysis(predictions, actuals),
        "n_races": len(predictions),
    }


def score_season_plans(predictor, plans, acts, probs) -> tuple[list, list]:
    """Assemble the per-race probability dicts from a season batch's padded
    histograms — the ONE scoring boundary shared by `backtest_model_batched`
    and the parameter sweep (`validate/tune.py`), so any change to the
    padded-matrix slicing or the kept probability dicts lands once. Each
    race's histogram is sliced to its real field (`p[:d, :d]`: the season
    batch pads the driver axis to the widest field) before assembly."""
    predictions, actuals = [], []
    for plan, act, p in zip(plans, acts, probs):
        d = len(plan.drivers)
        pred = predictor.assemble_result(plan, p[:d, :d])
        predictions.append(
            {
                "pole_probabilities": pred["pole_probabilities"],
                "win_probabilities": pred["win_probabilities"],
                "podium_probabilities": pred["podium_probabilities"],
            }
        )
        actuals.append(act)
    return predictions, actuals


def prepare_season_plans(
    predictor,
    season: int,
    reference_compat_elo_noop: bool = False,
    pin_clock: bool = True,
    verbose: bool = True,
) -> tuple[list, list[dict]]:
    """Walk-forward host preparation for one season: per race (clock pinned
    to its date), prepare the weekend plan, fetch the actual results, and
    apply the actual-result Elo updates — the leakage-correct prep both the
    batched backtest and the parameter sweep (`validate/tune.py`) run before
    any device work. Returns ([WeekendPlan], [actuals dict])."""
    loader = predictor.data_loader
    plans, acts = [], []
    cutoffs = _race_cutoffs(loader, season)
    races = get_races(loader, season)
    for race_idx, race in enumerate(races):
        try:
            _pin(loader, cutoffs, race_idx, pin_clock)
            plan = predictor.prepare_weekend(season, race)
            act = get_actual_results(loader, season, race)
            plans.append(plan)
            acts.append(act)
            _apply_actual_elo(
                predictor, act, reference_compat_elo_noop,
                race_idx=race_idx, total_races=len(races),
            )
        except Exception as e:  # noqa: BLE001
            log_event("backtest_skip", season=season, race=race, error=str(e))
            if verbose:
                print(f"Skipping {season} {race}: {e}")
    return plans, acts


def _apply_actual_elo(
    predictor, act: dict, compat_noop: bool,
    race_idx: int | None = None, total_races: int | None = None,
) -> None:
    """Walk-forward Elo updates from actual results. With compat_noop the
    reference's silent no-op defect is reproduced (nothing happens).

    `race_idx`/`total_races` pin the CURRENT-SEASON recency weight
    (elo.recency_k's 0.75->1.5 race-index ramp) for these updates. Without
    them the updates silently inherited whatever K the last historical
    season build left behind (the previous season's flat 1.0x — or less,
    if a factory pre-processed older seasons), so the within-season ramp
    never applied to the walk-forward learning path."""
    if compat_noop:
        return
    try:
        if race_idx is not None:
            predictor.elo_system.set_recency_weight(
                0, race_idx, total_races
            )
        if act.get("quali_results"):
            predictor.elo_system.update_quali_ratings(act["quali_results"])
        if act.get("race_results"):
            predictor.elo_system.update_race_ratings(act["race_results"])
    except Exception:  # noqa: BLE001 — mirror reference tolerance (validation.py:199)
        pass
