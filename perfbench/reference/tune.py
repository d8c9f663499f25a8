"""The parameter sweep's plain reference: frozen copies of the port's
`monte_carlo_gp_torch/validate/tune.py` `apply_overrides`, `expand_grid`
and the sweep's evaluate-and-rank loop as the port had them when this cell
was written, run on the reference's own season (`run.season_plans`: the
frozen walk-forward of `season.py` on the offline cache), plain race
simulation (`race.finish_probs`) and scores (`season.score_season_plans`,
`metrics`).

Departures from the port's code:
  * the seasons come prepared (`run.season_plans`, once per season, by the
    caller) rather than from a predictor factory; their plans are on the
    CPU, and a season's failures are not logged;
  * each race is simulated by `race.finish_probs` at
    `philox.fold_in(season_seed, r)`, padded to the widest field as the
    season launch pads it, rather than by one launch of the season kernel
    per season; no engine or mesh;
  * `evaluate` returns the per-race predictions beside the record, for the
    check; no spans, counters or log events;
  * `lowp=True` (the control): each configuration's plans, after the
    overrides, with every float of their SimParams rounded to bfloat16, and
    the simulation in bfloat16 (`race.py`);
  * float32 matrix products are held to float32 (no TF32) while the
    reference computes, and the process's settings are restored after it.

Plain `torch` and numpy: it imports no JAX, no JAX package and no kernel of
the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from collections.abc import Sequence

import numpy as np
import torch

from perfbench.reference import philox, race, season
from perfbench.reference import run as ref_run
from perfbench.reference.config import SimParams, pad_params
from perfbench.reference.metrics import brier_score, podium_accuracy

SCALAR_KEYS = (
    "pit_loss",
    "overtake_delta",
    "drs_delta",
    "sc_prob",
    "vsc_prob",
    "red_flag_prob",
    "dirty_air_threshold",
    "dirty_air_penalty",
)

SCALE_KEYS = {
    "variance_scale": "variance",
    "tire_deg_scale": "tire_deg",
    "dnf_scale": "dnf_rate",
    "team_dnf_scale": "team_dnf_rate",
}

_MAXIMIZE = {"podium_accuracy"}


def _unknown_key(k: str) -> ValueError:
    valid = ", ".join([*SCALAR_KEYS, *SCALE_KEYS])
    return ValueError(f"unknown sweep key {k!r}; valid keys: {valid}")


def apply_overrides(params: SimParams, overrides: dict[str, float]) -> SimParams:
    """Return `params` with sweep overrides applied: scalars replaced by
    float32 0-d tensors, `*_scale` keys multiplying their per-driver array
    by the float32 scale, a scale of 1.0 skipped."""
    changed = {}
    for k, v in overrides.items():
        if k in SCALE_KEYS:
            if float(v) == 1.0:
                continue
            field = SCALE_KEYS[k]
            changed[field] = getattr(params, field) * torch.tensor(
                float(v), dtype=torch.float32, device=params.device
            )
        elif k in SCALAR_KEYS:
            changed[k] = torch.tensor(float(v), dtype=torch.float32, device=params.device)
        else:
            raise _unknown_key(k)
    return dataclasses.replace(params, **changed) if changed else params


def expand_grid(param_grid: dict[str, Sequence[float]]) -> list[dict[str, float]]:
    """Cartesian product of a {key: [values...]} grid, insertion-ordered."""
    for k in param_grid:
        if k not in SCALAR_KEYS and k not in SCALE_KEYS:
            raise _unknown_key(k)
    keys = list(param_grid)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(param_grid[k] for k in keys))
    ]


@contextlib.contextmanager
def exact_float32():
    """float32 matrix products in float32 (no TF32) inside the block; the
    process's settings restored after it."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _season_probs(prepared: dict, overrides: dict, n_sims: int, season_seed: int, device,
                  lowp: bool) -> list:
    """Each race's (D, D) finish probabilities under `overrides`, race r at
    `fold_in(season_seed, r)`, padded to the season's widest field."""
    plans = [dataclasses.replace(p, params=apply_overrides(p.params, overrides))
             for p in prepared["plans"]]
    if lowp:
        plans = [ref_run.lowp_plan(p) for p in plans]
    d_max = max(p.params.n_drivers for p in plans)
    return [race.finish_probs(pad_params(p.params, d_max), p.total_laps, n_sims,
                              philox.fold_in(season_seed, r), device, lowp=lowp)
            for r, p in enumerate(plans)]


def _zero_probs(prepared: dict) -> list:
    d_max = max(p.params.n_drivers for p in prepared["plans"])
    return [np.zeros((d_max, d_max), np.float32) for _ in prepared["plans"]]


def prepare(cache_dir, seasons: list[int], quali_model: str, device) -> list[dict]:
    """Each season's walk-forward up to its launches (`run.season_plans`,
    with its `season`), the seasons without a race left out, as the sweep
    leaves them out."""
    out = []
    for s in seasons:
        prepared = ref_run.season_plans(cache_dir, s, quali_model, device)
        if prepared["plans"]:
            out.append({**prepared, "season": s})
    if not out:
        raise ValueError(f"no races prepared for seasons {seasons}")
    return out


def evaluate(seasons: list[dict], overrides: dict[str, float], seed: int, n_sims: int, device,
             lowp: bool = False, simulate: bool = True) -> tuple[dict, list]:
    """(the sweep's record of one configuration, its per-race predictions)
    over `seasons` (`prepare`'s list; season s at seed `seed * 1_000_003 +
    s`). `simulate=False` scores all-zero finish probabilities: the pole
    Brier, which no race simulation sets, reads true."""
    with exact_float32():
        predictions, actuals = [], []
        for prepared in seasons:
            pred = prepared["pred"]
            s = prepared["season"]
            probs = (_season_probs(prepared, overrides, n_sims, seed * 1_000_003 + s, device,
                                   lowp) if simulate else _zero_probs(prepared))
            pred.last_effective_sims = n_sims
            preds, a = season.score_season_plans(pred, prepared["plans"], prepared["acts"],
                                                 probs)
            predictions.extend(preds)
            actuals.extend(a)
        rec = {
            "overrides": dict(overrides),
            "pole_brier": brier_score(
                [p["pole_probabilities"] for p in predictions],
                [a["pole"] for a in actuals],
            ),
            "win_brier": brier_score(
                [p["win_probabilities"] for p in predictions],
                [a["winner"] for a in actuals],
            ),
            "podium_accuracy": podium_accuracy(predictions, actuals),
            "n_races": len(predictions),
        }
    return rec, predictions


def sweep(seasons: list[dict], param_grid: dict[str, Sequence[float]], seed: int, n_sims: int,
          device, metric: str = "win_brier", include_default: bool = True,
          lowp: bool = False) -> dict:
    """The sweep's result dict (`results` best first, `best`, `default`,
    `metric`, `n_configs`) over `seasons` (see `evaluate`)."""
    configs = expand_grid(param_grid)
    if not configs:
        raise ValueError("param_grid produced no configurations")
    if metric not in ("win_brier", "podium_accuracy"):
        raise ValueError(f"the sweep cannot rank by {metric!r}")
    default = (evaluate(seasons, {}, seed, n_sims, device, lowp)[0]
               if include_default else None)
    results = [evaluate(seasons, cfg, seed, n_sims, device, lowp)[0] for cfg in configs]
    results.sort(key=lambda r: r[metric], reverse=metric in _MAXIMIZE)
    return {
        "results": results,
        "best": results[0],
        "default": default,
        "metric": metric,
        "n_configs": len(results),
    }
