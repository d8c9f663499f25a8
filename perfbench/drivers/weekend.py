"""Weekend predictions, closed loop: one analyst predicts one race weekend
after another, each as one CLI run does it (a fresh `F1Predictor` on the
offline cache: `prepare_weekend`, `simulate_plan`, `assemble_result`).

The traffic names the season, the prediction point and the simulations;
the races come in an order drawn from the seed over the season's whole
calendar (repeated if the window outlasts it), each with a simulation seed
drawn from the seed. Set-up builds the world, reads every session frame of
its cache into the program's process-wide frame cache (so the window's first
pass over the calendar reads no parquet, as its later passes do not), and
warms one weekend of `warm_race` at the cell's simulations (the kernel
library). `weekend_s` is the window's
seconds over the weekends completed; the window runs on to the end of the
weekend under way when its seconds are up.
"""

from __future__ import annotations

import time

from perfbench import compare, trace
from perfbench.drivers import common
from perfbench.harness import Check, Run
from perfbench.reference import run as ref
from perfbench.reference import synthetic

SPANS = {"prepare", "simulate", "assemble"}


def _weekend(run: Run, pred_factory, race: str, seed: int):
    spans = run.spans
    season, point, n = run.param("season"), run.param("prediction_point"), run.param("n_simulations")
    with spans("prepare"):
        pred = pred_factory()
        plan = pred.prepare_weekend(season, race, prediction_point=point)
    with spans("simulate"):
        probs = pred.simulate_plan(plan, n, seed=seed)
    with spans("assemble"):
        result = pred.assemble_result(plan, probs)
    return plan, result


def measure(run: Run) -> None:
    world = common.setup(run)
    run.stderr.append(f"set-up: {common.warm_frames(world)} session frames read")
    factory = common.program_predictor(run, world)
    races = world.races[run.param("season")]
    order = run.rng("order").permutation(len(races))
    seeds = run.rng("sims")
    _weekend(run, factory, run.param("warm_race"), 0)
    run.spans.times.clear()
    common.ready(run)
    with trace.profiled(run.trace, run.device == "cuda") as prof:
        with common.window(run) as w:
            while not w.done():
                race, seed = races[order[run.attempted % len(races)]], int(seeds.integers(2**31))
                run.attempted += 1
                t = time.perf_counter()
                plan, result = _weekend(run, factory, race, seed)
                run.samples.setdefault("unit_s", []).append(time.perf_counter() - t)
                run.units.append({"race": race, "seed": seed, "plan": plan, "result": result})
    run.e2e["weekend_s"] = w.elapsed / len(run.units)
    common.finish(run, prof, SPANS)


def cover(run: Run) -> list[list[int]]:
    """The weekends the check has to run in full, by group: a wet event, a
    sprint event, and the longest race of the calendar (the kernel's
    longest lap loop), each as the indices of the window's units."""
    laps = run.cell.config["calendar_laps"]
    longest = max(laps.values())
    groups = [set(synthetic.WET_EVENTS), set(run.cell.config.get("sprint_events", ())),
              {r for r, n in laps.items() if n == longest}]
    return [[i for i, u in enumerate(run.units) if u["race"] in g] for g in groups]


def check(run: Run) -> list[Check]:
    """Every weekend's plan, grid and plan-set result fields against the
    reference's plan of its race; the results of a sample that covers
    `cover`, simulated by the reference, in full."""
    gaps = {"plan": 0.0, "grid": 0.0, "result": 0.0}
    n, plans = run.param("n_simulations"), {}
    for unit in run.units:
        if unit["race"] not in plans:
            plans[unit["race"]] = ref.weekend_plan(
                run.state["world"].cache_dir, run.param("season"), unit["race"],
                run.param("prediction_point"), run.param("quali_model"), run.device,
                fit=run.cell.config.get("fit"))
        pred, plan = plans[unit["race"]]
        common.worst(gaps, plan=compare.plan_gap(unit["plan"], plan),
                     grid=compare.grid_gap(unit["plan"], plan),
                     result=compare.fixed_gap(unit["result"], ref.weekend_fields(pred, plan, n)))
    for unit in common.sample(run, run.units, cover(run)):
        pred, plan = plans[unit["race"]]
        result = ref.weekend_result(pred, plan, n, unit["seed"], run.device)
        common.worst(gaps, result=compare.result_gap(unit["result"], result))
    run.stderr.append(f"check: {len(run.units)} weekends' plans over {len(plans)} races")
    return common.checks(run, gaps)


def control(run: Run) -> dict:
    """The control's gaps from the reference on the units `check` takes."""
    gaps = {"plan": 0.0, "grid": 0.0, "result": 0.0}
    for unit in common.sample(run, run.units, cover(run)):
        args = (run.state["world"].cache_dir, run.param("season"), unit["race"],
                run.param("prediction_point"), run.param("quali_model"), run.device)
        fit = run.cell.config.get("fit")
        pred, plan = ref.weekend_plan(*args, fit=fit)
        cpred, cplan = ref.weekend_plan(*args, lowp=True, fit=fit)
        n, seed = run.param("n_simulations"), unit["seed"]
        result = ref.weekend_result(pred, plan, n, seed, run.device)
        cresult = ref.weekend_result(cpred, cplan, n, seed, run.device, lowp=True)
        common.worst(gaps, plan=compare.plan_gap(cplan, plan), grid=compare.grid_gap(cplan, plan),
                     result=compare.result_gap(cresult, result))
    return gaps
