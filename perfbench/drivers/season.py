"""The walk-forward season backtest, closed loop: one modeller runs the
batched backtest of one season after another, each as
`backtest_model_batched`'s body does it for one season with a fresh
predictor (`prepare_season_plans`, `simulate_season_plans`,
`score_season_plans` and the scores).

The traffic names the season and the simulations per race; each season
takes a seed drawn from the run's seed, its season seed `seed * 1_000_003 +
season` as the backtest makes it. Set-up builds the world and warms one
race's prepare (and, with the Bayesian model, its fit) and one season
launch of as many races as the calendar has. `season_s` is the window's
seconds over the seasons completed.
"""

from __future__ import annotations

import time

from perfbench import compare, trace
from perfbench.drivers import common
from perfbench.harness import Check, Run
from perfbench.reference import bayes
from perfbench.reference import run as ref

SPANS = {"season.prepare", "season.simulate", "season.score"}
GAPS = ("plan", "grid", "result", "scores")


def measure(run: Run) -> None:
    from monte_carlo_gp_torch.validate import backtest

    world = common.setup(run)
    factory = common.program_predictor(run, world)
    season, n = run.param("season"), run.param("n_simulations")
    races = world.races[season]
    pred = factory()
    plan = pred.prepare_weekend(season, races[0])
    backtest.simulate_season_plans(pred, [plan] * len(races), 0, n)
    del pred, plan
    common.ready(run)
    seeds = run.rng("sims")
    spans = run.spans
    with trace.profiled(run.trace, run.device == "cuda") as prof:
        with common.window(run) as w:
            while not w.done():
                seed = int(seeds.integers(2**31))
                run.attempted += 1
                t = time.perf_counter()
                with spans("season.prepare"):
                    pred = factory()
                    plans, acts = backtest.prepare_season_plans(pred, season, verbose=False)
                with spans("season.simulate"):
                    probs = backtest.simulate_season_plans(pred, plans, seed * 1_000_003 + season,
                                                           n)
                with spans("season.score"):
                    preds, actuals = backtest.score_season_plans(pred, plans, acts, probs)
                    scores = backtest._score(preds, actuals)
                run.units.append({"season_seed": seed * 1_000_003 + season, "plans": plans,
                                  "predictions": preds, "scores": scores})
                run.samples.setdefault("unit_s", []).append(time.perf_counter() - t)
    run.e2e["season_s"] = w.elapsed / len(run.units)
    del pred
    common.finish(run, prof, SPANS)


def _plan_gaps(plans: list, ref_plans: list) -> dict:
    if len(plans) != len(ref_plans):
        return {"plan": compare.INF, "grid": compare.INF}
    return {"plan": max(compare.plan_gap(a, b) for a, b in zip(plans, ref_plans)),
            "grid": max(compare.grid_gap(a, b) for a, b in zip(plans, ref_plans))}


def _gaps(out: dict, ref_out: dict) -> dict:
    if len(out["plans"]) != len(ref_out["plans"]):
        return dict.fromkeys(GAPS, compare.INF)
    return {**_plan_gaps(out["plans"], ref_out["plans"]),
            "result": compare.number_gap(out["predictions"], ref_out["predictions"]),
            "scores": compare.scores_gap(out["scores"], ref_out["scores"])}


def _prepared(run: Run, lowp: bool = False) -> dict:
    return ref.season_plans(run.state["world"].cache_dir, run.param("season"),
                            run.param("quali_model"), run.device, lowp=lowp,
                            fit=run.cell.config.get("fit"))


def check(run: Run) -> list[Check]:
    """Every season's plans and grids against the reference's walk-forward
    (the same plans every season); the predictions and scores of a sample
    of seasons, simulated by the reference."""
    gaps = dict.fromkeys(GAPS, 0.0)
    prepared = _prepared(run)
    for unit in run.units:
        common.worst(gaps, **_plan_gaps(unit["plans"], prepared["plans"]))
    n = run.param("n_simulations")
    for unit in common.sample(run, run.units):
        common.worst(gaps, **_gaps(unit, ref.season_result(prepared, n, unit["season_seed"],
                                                           run.device)))
    run.work["fits"] = [(sum(d.sizes), bayes.nnz(d)) for d in prepared["designs"]]
    run.work["seasons"] = len(run.units)
    run.work["fit"] = run.cell.config.get("fit")
    return common.checks(run, gaps)


def control(run: Run) -> dict:
    """The control's gaps from the reference on the units `check` takes."""
    gaps = dict.fromkeys(GAPS, 0.0)
    prepared, lowp = _prepared(run), _prepared(run, lowp=True)
    n = run.param("n_simulations")
    for unit in common.sample(run, run.units):
        seed = unit["season_seed"]
        common.worst(gaps, **_gaps(ref.season_result(lowp, n, seed, run.device),
                                   ref.season_result(prepared, n, seed, run.device)))
    return gaps
