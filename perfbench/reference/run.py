"""The reference's side of a check: the plans re-derived from the same
offline cache, the races simulated by the plain simulation, the results
assembled and scored, all by the frozen copies beside this file.

`lowp=True` gives the control: the same work with the plan's numbers, the
simulation and the fit in the precision below the configuration's (see
`race.py` and `bayes.py`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference import bayes, philox, race, season
from perfbench.reference.config import pad_params
from perfbench.reference.predictor import F1Predictor


def predictor(cache_dir, quali_model: str) -> F1Predictor:
    """A fresh reference predictor on the offline cache, with a deferred
    Bayesian model where the configuration fits one."""
    model = bayes.DeferredBayes() if quali_model == "bayesian" else None
    return F1Predictor(cache_dir=cache_dir, offline=True, quali_model=quali_model,
                       bayes_model=model)


def lowp_plan(plan):
    """The plan with every float field of its SimParams rounded to
    bfloat16."""
    params = plan.params
    rounded = {f.name: race._bf16(getattr(params, f.name))
               for f in dataclasses.fields(params)
               if getattr(params, f.name).dtype == torch.float32}
    return dataclasses.replace(plan, params=dataclasses.replace(params, **rounded))


def _with_grid(plan, quali_probs: dict):
    """The plan with the grid of `quali_probs` (the port's `_make_params`
    fill of the (D, D) grid)."""
    n = len(plan.drivers)
    grid = np.zeros((n, n), np.float32)
    for i, d in enumerate(plan.drivers):
        probs = quali_probs.get(d) or []
        grid[i, : len(probs)] = probs[:n]
    params = dataclasses.replace(plan.params, grid_probs=torch.from_numpy(grid))
    return dataclasses.replace(plan, params=params, quali_probs=quali_probs)


def _resolve(pred: F1Predictor, plans: list, device, lowp: bool, fit: dict | None) -> list:
    """The plans with their Bayesian grids, every fit in one batch at the
    budget `fit`."""
    model = pred._bayes_model
    if model is None:
        return plans
    if len(model.pending) != len(plans):
        raise RuntimeError(f"{len(model.pending)} grids were asked for {len(plans)} plans")
    dtype = torch.bfloat16 if lowp else torch.float64
    grids = model.resolve(fit, dtype=dtype, device=device)
    return [_with_grid(p, g) for p, g in zip(plans, grids)]


def weekend_plan(cache_dir, season_: int, race_: str, point: str, quali_model: str,
                 device, lowp: bool = False, fit: dict | None = None):
    """(predictor, plan) of one weekend."""
    pred = predictor(cache_dir, quali_model)
    plan = pred.prepare_weekend(season_, race_, prediction_point=point)
    (plan,) = _resolve(pred, [plan], device, lowp, fit)
    return pred, lowp_plan(plan) if lowp else plan


def weekend_result(pred: F1Predictor, plan, n_sims: int, seed: int, device,
                   lowp: bool = False) -> dict:
    """The assembled result of `n_sims` races of `plan` at `seed`."""
    probs = race.finish_probs(plan.params, plan.total_laps, n_sims, seed, device, lowp=lowp)
    pred.last_effective_sims = n_sims
    return pred.assemble_result(plan, probs)


def weekend_fields(pred: F1Predictor, plan, n_sims: int) -> dict:
    """The fields of a result of `n_sims` races of `plan` that no race
    simulation sets (`compare.FIXED_KEYS`), with no race simulated."""
    pred.last_effective_sims = n_sims
    n = len(plan.drivers)
    return pred.assemble_result(plan, np.zeros((n, n)))


def season_plans(cache_dir, season_: int, quali_model: str, device, lowp: bool = False,
                 fit: dict | None = None) -> dict:
    """One season of the walk-forward backtest up to its launch: the
    predictor, the plans (every Bayesian grid fitted in one batch), the
    actual results, and the fits' designs."""
    pred = predictor(cache_dir, quali_model)
    plans, acts = season.prepare_season_plans(pred, season_, verbose=False)
    plans = _resolve(pred, plans, device, lowp, fit)
    if lowp:
        plans = [lowp_plan(p) for p in plans]
    return {"pred": pred, "plans": plans, "acts": acts, "lowp": lowp,
            "designs": list(pred._bayes_model.designs) if pred._bayes_model else []}


def season_result(prepared: dict, n_sims: int, season_seed: int, device) -> dict:
    """The season of `season_plans` run at `season_seed`: each race's finish
    probabilities (race r at `philox.fold_in(season_seed, r)`, the fields
    padded to the widest as the season launch pads them), the per-race
    predictions and the scores."""
    pred, plans, lowp = prepared["pred"], prepared["plans"], prepared["lowp"]
    d_max = max(p.params.n_drivers for p in plans)
    probs = [race.finish_probs(pad_params(p.params, d_max), p.total_laps, n_sims,
                               philox.fold_in(season_seed, r), device, lowp=lowp)
             for r, p in enumerate(plans)]
    pred.last_effective_sims = n_sims
    preds, actuals = season.score_season_plans(pred, plans, prepared["acts"], probs)
    return {"plans": plans, "predictions": preds, "scores": season._score(preds, actuals)}
