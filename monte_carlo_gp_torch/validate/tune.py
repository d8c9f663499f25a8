"""Event-model parameter tuning: sweep simulation scalars against backtest
metrics — the port of `monte_carlo_gp_tpu.validate.tune`.

The reference hardcodes its event-model scalars (safety car 0.01, VSC
0.015, red flag 0.002, DRS delta 0.3, the dirty-air threshold and penalty)
and offers no way to ask "would a different safety-car rate or variance
scale score better on history?". This module makes that question cheap:

 - **Host preparation runs once, not once per config.** The walk-forward
   plan build (Elo, features, practice extraction — the expensive pandas
   work) is shared by every configuration; only SimParams fields change.
 - **One season launch per (config, season)** of the season kernel
   (`validate/backtest.simulate_season_plans`).
 - **Common random numbers.** Every config simulates under the SAME season
   seed (race r = fold_in(seed, r)), so config-to-config metric differences
   are paired comparisons, not two independent Monte Carlo noises — and a
   config with no overrides reproduces `backtest_model_batched` exactly.

Sweepable keys: any SimParams scalar (`sc_prob`, `vsc_prob`,
`red_flag_prob`, `drs_delta`, `overtake_delta`, `pit_loss`,
`dirty_air_threshold`, `dirty_air_penalty`) set absolutely, or a
multiplicative `*_scale` on a per-driver array (`variance_scale`,
`tire_deg_scale`, `dnf_scale`, `team_dnf_scale`). Quali probabilities are
NOT affected by race-sim scalars, so `pole_brier` is identical across
configs — a built-in self-check the tests assert.

Spans and counters (`utils/profiling.py`): `tune.sweep` is the whole call;
`tune.prepare` each season's `prepare_season_plans` (with `backtest.prepare`
inside); `tune.config` one configuration, the default included, over its
seasons, with `tune.overrides` (`apply_overrides` over the plans),
`backtest.simulate` ⊃ `simulate.readback` (each season's launch and the
host's wait for it) and `tune.score` (`score_season_plans`, with
`backtest.score`, and the record's Briers and podium accuracy) inside it;
`tune.rank` the sort. The counter `tune.configs` counts the configurations
evaluated.
"""

from __future__ import annotations

import dataclasses
import itertools
from collections.abc import Sequence

import torch

from monte_carlo_gp_torch.config import SimParams
from monte_carlo_gp_torch.parallel.mesh import Mesh
from monte_carlo_gp_torch.utils.logging import log_event
from monte_carlo_gp_torch.utils.profiling import count, span
from monte_carlo_gp_torch.validate.backtest import (
    prepare_season_plans,
    score_season_plans,
    simulate_season_plans,
)
from monte_carlo_gp_torch.validate.metrics import brier_score, podium_accuracy

__all__ = ["SCALAR_KEYS", "SCALE_KEYS", "apply_overrides", "expand_grid",
           "sweep_backtest"]

# SimParams scalar fields settable to an absolute value.
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

# Multiplicative scalings of per-driver arrays: sweep key -> SimParams field.
SCALE_KEYS = {
    "variance_scale": "variance",
    "tire_deg_scale": "tire_deg",
    "dnf_scale": "dnf_rate",
    "team_dnf_scale": "team_dnf_rate",
}

# Metrics where larger is better (everything else sorts ascending).
_MAXIMIZE = {"podium_accuracy"}


def _unknown_key(k: str) -> ValueError:
    valid = ", ".join([*SCALAR_KEYS, *SCALE_KEYS])
    return ValueError(f"unknown sweep key {k!r}; valid keys: {valid}")


def apply_overrides(params: SimParams, overrides: dict[str, float]) -> SimParams:
    """Return `params` with sweep overrides applied.

    Scalars are replaced by float32 0-d tensors on the params' device;
    `*_scale` keys multiply their per-driver array elementwise by the
    float32 scale. A scale of 1.0 is skipped entirely, so an identity
    override is bitwise identity. Unknown keys raise ValueError (catching
    sweep-grid typos beats silently sweeping nothing).
    """
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
    """Cartesian product of a {key: [values...]} grid, insertion-ordered.

    Keys are validated eagerly (same rules as `apply_overrides`)."""
    for k in param_grid:
        if k not in SCALAR_KEYS and k not in SCALE_KEYS:
            raise _unknown_key(k)
    keys = list(param_grid)
    return [
        dict(zip(keys, combo))
        for combo in itertools.product(*(param_grid[k] for k in keys))
    ]


def sweep_backtest(
    predictor_factory,
    seasons: list[int],
    param_grid: dict[str, Sequence[float]],
    seed: int = 42,
    n_simulations: int = 10_000,
    metric: str = "win_brier",
    reference_compat_elo_noop: bool = False,
    pin_clock: bool = True,
    include_default: bool = True,
    verbose: bool = True,
    engine: str | None = None,
    mesh: Mesh | None = None,
) -> dict:
    """Backtest every configuration in `param_grid` and rank by `metric`.

    Runs `prepare_season_plans` once per season (the expensive host work),
    then one season launch per (config, season) — all configs share the
    season seeds (common random numbers; see module docstring).

    Args:
      param_grid: {sweep key: [values...]}; configs are the Cartesian
        product. See SCALAR_KEYS / SCALE_KEYS.
      metric: 'win_brier' (default) or 'podium_accuracy' — what `best`
        minimizes (or maximizes, for accuracy metrics). 'pole_brier' is
        REJECTED as a ranking target: race-sim scalars cannot reach the
        quali model, so it is identical across configs (the module's
        built-in self-check) and 'best' would degenerate to grid order.
        It is still reported on every record.
      include_default: also evaluate the un-overridden configuration (it
        reproduces `backtest_model_batched` exactly) and report it as
        `default` for before/after comparison.
      engine, mesh: passed to `simulate_season_plans` (default: each
        predictor's own).

    Returns {'results': [per-config records, best first], 'best': record,
    'default': record or None, 'metric': metric, 'n_configs': int}. Each
    record carries 'overrides', 'pole_brier', 'win_brier',
    'podium_accuracy', 'n_races'.
    """
    configs = expand_grid(param_grid)
    if not configs:
        raise ValueError("param_grid produced no configurations")
    if metric == "pole_brier":
        raise ValueError(
            "pole_brier cannot rank a sweep: race-sim scalars do not affect "
            "quali probabilities, so it is identical for every config "
            "(it is still reported on each record); rank by 'win_brier' "
            "or 'podium_accuracy'"
        )
    if metric not in ("win_brier", "podium_accuracy"):
        raise ValueError(f"unknown metric {metric!r}")

    with span("tune.sweep"):
        # Phase 1 (host, once): leakage-correct walk-forward prep per season.
        prepared = []  # (predictor, plans, acts, season)
        for season in seasons:
            with span("tune.prepare"):
                predictor = predictor_factory()
                plans, acts = prepare_season_plans(
                    predictor, season,
                    reference_compat_elo_noop=reference_compat_elo_noop,
                    pin_clock=pin_clock, verbose=verbose,
                )
            if plans:
                prepared.append((predictor, plans, acts, season))
        if not prepared:
            raise ValueError(f"no races prepared for seasons {seasons}")

        # Phase 2+3 (a season launch per config + host scoring).
        def evaluate(overrides: dict[str, float]) -> dict:
            with span("tune.config"):
                count("tune.configs")
                with span("tune.overrides"):
                    params = [[apply_overrides(p.params, overrides) for p in plans]
                              for _, plans, _, _ in prepared]
                probs = [
                    simulate_season_plans(
                        predictor, plans, seed * 1_000_003 + season, n_simulations,
                        params_list=params_list, engine=engine, mesh=mesh,
                    )
                    for (predictor, plans, _, season), params_list in zip(prepared, params)
                ]
                with span("tune.score"):
                    predictions, actuals = [], []
                    for (predictor, plans, acts, _), p in zip(prepared, probs):
                        preds, a = score_season_plans(predictor, plans, acts, p)
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
                log_event("sweep_config", metric=metric, value=rec[metric],
                          **{f"grid_{k}": v for k, v in overrides.items()})
            return rec

        default = evaluate({}) if include_default else None
        results = [evaluate(cfg) for cfg in configs]
        with span("tune.rank"):
            results.sort(key=lambda r: r[metric], reverse=metric in _MAXIMIZE)
    return {
        "results": results,
        "best": results[0],
        "default": default,
        "metric": metric,
        "n_configs": len(results),
    }
