"""The event-model calibration sweep, closed loop: one modeller sweeps the
event model's grid over the walk-forward backtest of a season after
another, each as `python -m monte_carlo_gp_torch.tune` does it
(`sweep_backtest` with a fresh predictor per season on the offline cache,
ranked by the configuration's metric, the default evaluated beside the
grid).

The configuration's `sweep` names the grid, the seasons, the metric and
whether the default is evaluated; the traffic the simulations per race.
Each unit takes a sweep seed drawn from the run's seed (season s at
`seed * 1_000_003 + s`, as `sweep_backtest` makes it). Set-up builds the
world, reads every session frame of its cache into the program's frame
cache, and warms one race's prepare and one season launch of as many races
as the calendar has at the cell's simulations. `season_s` is the window's
seconds over the seasons swept.

The check, every unit: each record's pole Brier against the one the
reference computes from its own plans (no race simulation sets it), the
configuration that changes no plan equal to the default bit for bit, the
configurations equal to the grid, and the records in the metric's order.
For one configuration of one unit drawn from the seed, the reference
simulates every race in full: its win Brier, its podium accuracy and each
race's win and podium probabilities against the program's (which the
predictors the sweep is given keep as they assemble them).
"""

from __future__ import annotations

import dataclasses
import json
import time

import torch

from perfbench import compare, trace
from perfbench.drivers import common
from perfbench.harness import Check, Run
from perfbench.reference import tune as ref_tune

# the program's spans that label the device's idle gaps (a gap takes the
# span that covers most of it); a program without them reads "outside spans"
SPANS = {"tune.prepare", "tune.overrides", "tune.score", "tune.rank", "backtest.simulate",
         "simulate.readback"}
GAPS = ("pole", "identity", "configs", "order", "result", "scores", "podium")
KEPT = ("win_probabilities", "podium_probabilities")


def _keeping(make, kept: list):
    """A factory of `make`'s predictors, each of which keeps the win and
    podium probabilities of every result it assembles in `kept`."""

    def factory():
        pred = make()
        assemble = pred.assemble_result

        def assemble_result(plan, probs):
            result = assemble(plan, probs)
            kept.append({k: result[k] for k in KEPT})
            return result

        pred.assemble_result = assemble_result
        return pred

    return factory


def measure(run: Run) -> None:
    from monte_carlo_gp_torch.validate import backtest
    from monte_carlo_gp_torch.validate.tune import sweep_backtest

    world = common.setup(run)
    run.stderr.append(f"set-up: {common.warm_frames(world)} session frames read")
    make = common.program_predictor(run, world)
    sweep, n = run.param("sweep"), run.param("n_simulations")
    season = run.param("season")
    races = world.races[season]
    pred = make()
    plan = pred.prepare_weekend(season, races[0])
    backtest.simulate_season_plans(pred, [plan] * len(races), 0, n)
    del pred, plan
    kept: list = []
    factory = _keeping(make, kept)
    common.ready(run)
    seeds = run.rng("sims")
    with trace.profiled(run.trace, run.device == "cuda") as prof:
        with common.window(run) as w:
            while not w.done():
                seed = int(seeds.integers(2**31))
                run.attempted += 1
                t = time.perf_counter()
                out = sweep_backtest(factory, sweep["seasons"], sweep["grid"], seed=seed,
                                     n_simulations=n, metric=sweep["metric"],
                                     include_default=sweep["include_default"])
                run.units.append({"seed": seed, "out": out, "kept": list(kept)})
                kept.clear()
                run.samples.setdefault("unit_s", []).append(time.perf_counter() - t)
    run.e2e["season_s"] = w.elapsed / (len(run.units) * len(sweep["seasons"]))
    common.finish(run, prof, SPANS)


def _configs(sweep: dict) -> list[dict]:
    """The configurations in the order the sweep evaluates them."""
    return ([{}] if sweep["include_default"] else []) + ref_tune.expand_grid(sweep["grid"])


def _changes_nothing(seasons: list[dict], overrides: dict) -> bool:
    """Whether `overrides` leaves every reference plan's SimParams as it is."""
    for prepared in seasons:
        for plan in prepared["plans"]:
            new = ref_tune.apply_overrides(plan.params, overrides)
            if any(not torch.equal(getattr(new, k), getattr(plan.params, k))
                   for k in (f.name for f in dataclasses.fields(plan.params))):
                return False
    return True


def _key(overrides: dict) -> str:
    return json.dumps(overrides, sort_keys=True)


def _unit_gaps(out: dict, sweep: dict, pole: float, identity: list[dict]) -> dict:
    """The numbers every unit is held to: the worst pole-Brier gap, and 0
    or infinity for the identity, the configurations and the order."""
    inf = compare.INF
    records = out["results"] + ([out["default"]] if sweep["include_default"] else [])
    if not out["results"] or any(r is None for r in records):
        return dict.fromkeys(("pole", "identity", "configs", "order"), inf)
    grid = sorted(_key(c) for c in ref_tune.expand_grid(sweep["grid"]))
    configs_ok = (sorted(_key(r["overrides"]) for r in out["results"]) == grid
                  and out["n_configs"] == len(grid)
                  and (not sweep["include_default"] or out["default"]["overrides"] == {}))
    values = [r[sweep["metric"]] for r in out["results"]]
    order_ok = (values == sorted(values, reverse=sweep["metric"] == "podium_accuracy")
                and out["best"] == out["results"][0] and out["metric"] == sweep["metric"])
    same = ("pole_brier", "win_brier", "podium_accuracy", "n_races")
    identity_ok = not sweep["include_default"] or all(
        r[k] == out["default"][k] for r in out["results"] if r["overrides"] in identity
        for k in same)
    return {"pole": max(abs(r["pole_brier"] - pole) for r in records),
            "identity": 0.0 if identity_ok else inf,
            "configs": 0.0 if configs_ok else inf,
            "order": 0.0 if order_ok else inf}


def _sim_gaps(rec: dict, kept: list, ref_rec: dict, ref_preds: list) -> dict:
    """The gaps of one configuration simulated by the reference: each race's
    win and podium probabilities, the win Brier, the podium accuracy."""
    if rec is None or rec["n_races"] != ref_rec["n_races"] or len(kept) != len(ref_preds):
        return dict.fromkeys(("result", "scores", "podium"), compare.INF)
    want = [{k: p[k] for k in KEPT} for p in ref_preds]
    return {"result": compare.number_gap(kept, want),
            "scores": abs(rec["win_brier"] - ref_rec["win_brier"]),
            "podium": abs(rec["podium_accuracy"] - ref_rec["podium_accuracy"])}


def _program_config(unit: dict, configs: list[dict], overrides: dict) -> tuple[dict, list]:
    """The program's record of `overrides` in `unit` and the per-race
    probabilities its predictors kept for it (the sweep assembles each
    configuration's races in turn, in `configs`' order)."""
    out = unit["out"]
    records = out["results"] + ([out["default"]] if out["default"] is not None else [])
    rec = next((r for r in records if r["overrides"] == overrides), None)
    kept = unit["kept"]
    if rec is None or len(kept) != len(configs) * rec["n_races"]:
        return rec, []
    k, n = configs.index(overrides), rec["n_races"]
    return rec, kept[k * n:(k + 1) * n]


def _sampled(run: Run) -> list[tuple[dict, dict]]:
    """(unit, configuration) pairs the reference simulates in full: the
    units of `common.sample`, each with one configuration drawn from the
    seed."""
    configs = _configs(run.param("sweep"))
    rng = run.rng("config")
    return [(unit, configs[int(rng.integers(len(configs)))])
            for unit in common.sample(run, run.units)]


def _prepared(run: Run) -> list[dict]:
    return ref_tune.prepare(run.state["world"].cache_dir, run.param("sweep")["seasons"],
                            run.param("quali_model"), run.device)


def check(run: Run) -> list[Check]:
    sweep, n = run.param("sweep"), run.param("n_simulations")
    seasons = _prepared(run)
    configs = _configs(sweep)
    pole = ref_tune.evaluate(seasons, {}, 0, n, run.device, simulate=False)[0]["pole_brier"]
    identity = [c for c in configs if c and _changes_nothing(seasons, c)]
    gaps = dict.fromkeys(GAPS, 0.0)
    for unit in run.units:
        common.worst(gaps, **_unit_gaps(unit["out"], sweep, pole, identity))
    for unit, overrides in _sampled(run):
        ref_rec, ref_preds = ref_tune.evaluate(seasons, overrides, unit["seed"], n, run.device)
        rec, kept = _program_config(unit, configs, overrides)
        common.worst(gaps, **_sim_gaps(rec, kept, ref_rec, ref_preds))
        run.stderr.append(f"sampled configuration {overrides or 'default'} of sweep seed "
                          f"{unit['seed']}: win Brier {rec and rec['win_brier']!r} against "
                          f"{ref_rec['win_brier']!r}")
    # the roofline's work: every launch of the window (one a season of each
    # configuration evaluated) with its races' fields and laps
    launch = [[(len(p.drivers), p.total_laps) for p in s["plans"]] for s in seasons]
    evaluated = sum(len(u["out"]["results"]) + (u["out"]["default"] is not None)
                    for u in run.units)
    run.work["launches"] = launch * evaluated
    run.work["n_simulations"] = n
    return common.checks(run, gaps)


def control(run: Run) -> dict:
    """The control's gaps from the reference on the configurations `check`
    simulates: the same configuration in bfloat16 (plans and simulation).
    The identity, the configurations and the order follow from the sweep's
    structure, not its precision, so the control reads no gap there."""
    n = run.param("n_simulations")
    seasons = _prepared(run)
    gaps = dict.fromkeys(("pole", "result", "scores", "podium"), 0.0)
    for unit, overrides in _sampled(run):
        ref_rec, ref_preds = ref_tune.evaluate(seasons, overrides, unit["seed"], n, run.device)
        low_rec, low_preds = ref_tune.evaluate(seasons, overrides, unit["seed"], n, run.device,
                                               lowp=True)
        kept = [{k: p[k] for k in KEPT} for p in low_preds]
        common.worst(gaps, pole=abs(low_rec["pole_brier"] - ref_rec["pole_brier"]),
                     **_sim_gaps(low_rec, kept, ref_rec, ref_preds))
    return gaps
