"""Walk-forward season backtest — the port of
`monte_carlo_gp_tpu.validate.backtest`, with the same behaviour and log
events.

A fresh predictor per season (no leakage); per race: predict, fetch the
actuals, score, and update Elo with the actual results, skipping failed
races with a warning (the reference's src/validation.py:161-209).

What the JAX package fixes over the reference, kept here:
  * the actual-result Elo updates apply (the reference swallows an
    exception and never learns within the season); `reference_compat_elo_noop=True`
    reproduces the reference for A/B runs.
  * no look-ahead: before predicting race k the loader's clock is pinned
    just before race k's date (`loader.set_now`), so Elo and features see
    only races < k; `pin_clock=False` reproduces the reference's leak.
  * checkpoint/resume: per-race results append to a JSONL file; a resumed
    backtest replays completed races' Elo updates and continues from the
    first missing race.
  * `n_simulations` and the seed are honored and deterministic.

The sequential backtest runs the single-race kernel once per race through
`predict_weekend`; the batched one prepares the whole season on the host
and then runs every race in ONE launch of the season kernel
(`ops.race_kernel.run_monte_carlo_season`), on the predictor's device.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import pandas as pd

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.ops.race_kernel import MAX_DRIVERS, run_monte_carlo_season
from monte_carlo_gp_torch.utils.logging import log_event
from monte_carlo_gp_torch.validate.metrics import (
    brier_score,
    calibration_analysis,
    podium_accuracy,
)


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


def _checkpoint_read(path: Path) -> dict[tuple[int, str], dict]:
    done = {}
    if path.exists():
        for lineno, line in enumerate(path.read_text().splitlines(), 1):
            if not line.strip():
                continue
            try:
                rec = json.loads(line)
                done[(rec["season"], rec["race"])] = rec
            except (json.JSONDecodeError, KeyError, TypeError) as e:
                # A run killed mid-append (OOM/SIGKILL/disk-full) leaves a
                # truncated trailing line; resuming past it is the whole
                # point of the checkpoint, so skip the line (its race
                # simply re-runs) instead of refusing to start.
                log_event(
                    "checkpoint_skip_line", path=str(path), line=lineno,
                    error=str(e),
                )
    return done


def backtest_model(
    predictor_factory,
    seasons: list[int],
    seed: int = 42,
    n_simulations: int = 10_000,
    checkpoint_path: str | Path | None = None,
    reference_compat_elo_noop: bool = False,
    pin_clock: bool = True,
    verbose: bool = True,
) -> dict:
    """Run the walk-forward backtest and score it.

    Args:
      predictor_factory: zero-arg callable returning a fresh F1Predictor-like
        object (class or closure over data-backend configuration).
      seasons: seasons to walk, each with a fresh predictor (leakage control,
        validation.py:180).
      seed: base seed; race `race_idx` of `season` simulates with seed
        `seed * 1_000_003 + season * 1_000 + race_idx`, so results are
        order-independent and reproducible.
      checkpoint_path: optional JSONL file for resumable progress.
      pin_clock: pin the loader clock to each race's date before predicting
        it, so Elo/feature inputs never see that race or later ones (see
        module docstring). False reproduces the reference's leaky behavior.

    Returns the reference's result dict: pole_brier, win_brier,
    podium_accuracy, calibration_curve, n_races.
    """
    ckpt = Path(checkpoint_path) if checkpoint_path else None
    done = _checkpoint_read(ckpt) if ckpt else {}

    predictions, actuals = [], []
    for season in seasons:
        predictor = predictor_factory()
        loader = predictor.data_loader
        races = get_races(loader, season)
        cutoffs = _race_cutoffs(loader, season)
        if done and hasattr(predictor, "_build_elo"):
            # Resume: the historical-season Elo build must land BEFORE the
            # replayed actual-result updates — in an uninterrupted run,
            # race 1's predict_weekend builds it before any actuals apply.
            # Elo updates are order-dependent, so skipping this would make a
            # resumed backtest diverge from the original. Pin the clock to
            # race 1 first so the build matches the uninterrupted run's.
            _pin(loader, cutoffs, 0, pin_clock)
            predictor._build_elo(season)
        for race_idx, race in enumerate(races):
            key = (season, race)
            if key in done:
                rec = done[key]
                predictions.append(rec["prediction"])
                actuals.append(rec["actual"])
                # Replay must mirror the uninterrupted run's Elo evolution:
                # prepare_weekend seeds rookie priors BEFORE the race's
                # actual updates apply, so a resumed rookie_prior backtest
                # re-seeds from the checkpointed participants (team from
                # the static map — the FP-frame assignment isn't recorded;
                # identical for the synthetic world, approximate when a
                # weekend's frame teams diverge from config).
                if getattr(predictor, "_rookie_prior", False):
                    participants = list(dict.fromkeys(
                        (rec["actual"].get("quali_results") or [])
                        + (rec["actual"].get("race_results") or [])
                    ))
                    rookies = {
                        d: cfg.DRIVER_TEAMS.get(d)
                        for d in participants
                        if not predictor.elo_system.has_rating(d)
                    }
                    if rookies:
                        predictor.elo_system.initialize_rookies(rookies)
                _apply_actual_elo(
                    predictor, rec["actual"], reference_compat_elo_noop,
                    race_idx=race_idx, total_races=len(races),
                )
                continue
            try:
                _pin(loader, cutoffs, race_idx, pin_clock)
                pred = predictor.predict_weekend(
                    season,
                    race,
                    n_simulations=n_simulations,
                    seed=seed * 1_000_003 + season * 1_000 + race_idx,
                )
                act = get_actual_results(loader, season, race)
                slim = {
                    "pole_probabilities": pred["pole_probabilities"],
                    "win_probabilities": pred["win_probabilities"],
                    "podium_probabilities": pred["podium_probabilities"],
                }
                predictions.append(slim)
                actuals.append(act)
                _apply_actual_elo(
                    predictor, act, reference_compat_elo_noop,
                    race_idx=race_idx, total_races=len(races),
                )
                log_event(
                    "backtest_race",
                    season=season,
                    race=race,
                    idx=race_idx,
                    winner=act.get("winner"),
                    pole=act.get("pole"),
                )
                if ckpt:
                    ckpt.parent.mkdir(parents=True, exist_ok=True)
                    with ckpt.open("a") as f:
                        f.write(
                            json.dumps(
                                {
                                    "season": season,
                                    "race": race,
                                    "prediction": slim,
                                    "actual": act,
                                }
                            )
                            + "\n"
                        )
            except Exception as e:  # noqa: BLE001 — skip bad races (validation.py:201)
                log_event("backtest_skip", season=season, race=race, error=str(e))
                if verbose:
                    print(f"Skipping {season} {race}: {e}")

    return _score(predictions, actuals)


def backtest_model_batched(
    predictor_factory,
    seasons: list[int],
    seed: int = 42,
    n_simulations: int = 10_000,
    reference_compat_elo_noop: bool = False,
    pin_clock: bool = True,
    verbose: bool = True,
) -> dict:
    """Season backtest with one device launch per season: the walk-forward
    Elo/feature preparation runs sequentially on the host, then EVERY race's
    Monte Carlo runs in one launch of the season kernel on the predictor's
    device — BASELINE.md's "full-season backtest" configuration.

    Statistically equivalent to `backtest_model` (prediction for race k only
    uses information from races < k — the simulation itself never feeds back
    into preparation); the season's seed is `seed * 1_000_003 + season`, and
    race r is seeded with `philox.fold_in` of it.
    """
    predictions, actuals = [], []
    for season in seasons:
        predictor = predictor_factory()
        plans, acts = prepare_season_plans(
            predictor, season,
            reference_compat_elo_noop=reference_compat_elo_noop,
            pin_clock=pin_clock, verbose=verbose,
        )
        if not plans:
            continue
        probs = simulate_season_plans(
            predictor, plans, seed * 1_000_003 + season, n_simulations
        )
        preds, a = score_season_plans(predictor, plans, acts, probs)
        predictions.extend(preds)
        actuals.extend(a)

    return _score(predictions, actuals)


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


def simulate_season_plans(
    predictor,
    plans: list,
    season_seed: int,
    n_simulations: int,
    params_list: list | None = None,
) -> list:
    """Simulate a season's prepared plans on the predictor's device -> list
    of finish-probability arrays, one per plan.

    Race r is seeded with `philox.fold_in(season_seed, r)`, so a race's
    result does not depend on the other plans in the batch. `params_list`
    optionally overrides each plan's SimParams (same order and length as
    `plans`) — the parameter sweep's hook.

    A season whose widest field has at most MAX_DRIVERS (128) drivers runs
    as one launch of the season kernel, and every array is (D, D), D that
    widest field. A wider season runs race by race through
    `predictor.simulate_plan` at race r's seed, so each race takes the race
    kernel or, above 128 drivers, the lap engine, and its array is its own
    field's (d, d): the JAX package's route for such seasons
    (validate/backtest.py:457-471), with the same seed chain.
    """
    if params_list is None:
        params_list = [p.params for p in plans]
    n = int(n_simulations)
    if max(p.n_drivers for p in params_list) > MAX_DRIVERS:
        return [
            predictor.simulate_plan(
                dataclasses.replace(plan, params=prm), n, seed=philox.fold_in(season_seed, r)
            )
            for r, (plan, prm) in enumerate(zip(plans, params_list))
        ]
    probs = run_monte_carlo_season(
        [p.to(predictor.device) for p in params_list],
        [p.total_laps for p in plans],
        season_seed,
        n,
    )
    predictor.last_effective_sims = n
    return list(probs.cpu().numpy())


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
