"""`/predict` clients of a season whose field is an entry list, open loop:
the `serve` driver's clients, server (`serve_child.py`, the program's
`PredictionService` and handler in the `HTTPServer` that `serve.py`
builds) and check, on a world whose traffic season fields the
configuration's `entry_list` (`perfbench/reference/roster.py`; the season
before it the frozen 2025 map).

The world: the entry-list world made from the run's seed, the traffic's
season and the one before it, written to the users' offline parquet cache
by the frozen cache writer. The load: the traffic's fixed Poisson draw at
its rate, each request with a simulation seed drawn from the run's seed,
timed from when it was due; `request_p95_ms` as in `serve`. The server's
`/stats` is read before the window opens and after its last request: the
difference of its race-kernel counters (`kernels`: cars, slots, packed
races) is the window's, None where the program serves no such counters.

The check and its control are `serve`'s, with the reference's torch work
in exact float32.

The knee of such a cell (the procedure of `perfbench/sweep.py`: one warmed
server, open-loop Poisson load at each rate in turn, 20 s a rate, on this
world):

    python -m perfbench.drivers.serve_field --workload serve.elo.2026.1m --rates 6,8,10
"""

from __future__ import annotations

import argparse
import http.client
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from perfbench import harness, spec, trace
from perfbench.drivers import common, serve
from perfbench.harness import Check, Run, power_limit_w
from perfbench.reference import loader as ref_loader
from perfbench.reference import roster
from perfbench.world import World


class RosterWorld(World):
    """`World` with the entry-list generator: `entry_lists` ({season:
    {driver: team}}) field their seasons."""

    def __init__(self, world_seed: int, seasons: list[int], entry_lists: dict):
        self.cache_dir = Path(tempfile.mkdtemp(prefix="perfbench-world-"))
        backend = roster.RosterBackend(world_seed, entry_lists)
        ref_loader.F1DataLoader(cache_dir=self.cache_dir, offline=True,
                                backend=backend).build_cache(seasons)
        self.races = {s: [ev["Location"] for ev in backend.get_schedule(s)] for s in seasons}


def world(run: Run) -> RosterWorld:
    """The run's world (its offline cache), made as set-up."""
    season = run.param("season")
    made = RosterWorld(int(run.rng("world").integers(2**32)), [season - 1, season],
                       {season: run.param("entry_list")})
    run.state["world"] = made
    run.state["power_limit"] = power_limit_w()
    return made


def stats(port: int) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("GET", "/stats")
        return json.loads(conn.getresponse().read())
    finally:
        conn.close()


def kernel_counts(before: dict, after: dict) -> dict | None:
    """The race-kernel counters' growth between two `/stats` bodies; None
    where the program serves none."""
    if "kernels" not in before or "kernels" not in after:
        return None
    return {k: after["kernels"][k] - before["kernels"].get(k, 0) for k in after["kernels"]}


def _requests(run: Run, seeds) -> list[dict]:
    return [{"season": run.param("season"), "race": run.param("race"),
             "prediction_point": run.param("prediction_point"),
             "n_simulations": run.param("n_simulations"), "seed": int(s)} for s in seeds]


def measure(run: Run) -> None:
    made = world(run)  # the card is the server's alone until it exits
    child = serve.Child(run, made.cache_dir)
    run.state["server"] = child
    common.ready(run, sync=False)
    n_sims, rate = run.param("n_simulations"), float(run.param("rate_per_s"))
    n_req = max(1, round(rate * run.seconds))
    gaps = serve.arrival_gaps(n_req, rate, int(run.param("arrival_seed")))
    requests = _requests(run, run.rng("sims").integers(2**31, size=n_req))
    before = stats(child.port)
    child.send("start")
    child.expect("started", 60)
    start = time.perf_counter()
    records = serve.open_loop(child.port, requests, start + np.cumsum(gaps), run.seconds + 300)
    elapsed = max(r["end"] for r in records) - start
    after = stats(child.port)
    got = child.stop()
    if got["forbidden"]:
        raise RuntimeError(f"the server loaded {got['forbidden']}")
    run.attempted = n_req
    for r in records:
        r["ok"] = r["status"] == 200 and r["body"] is not None
    ok = [r for r in records if r["ok"]]
    run.failed = n_req - len(ok)
    latencies = [(r["end"] - r["due"]) if r["ok"] else elapsed for r in records]
    run.e2e["request_p95_ms"] = 1e3 * serve.p95(latencies)
    run.samples["server_latency_s"] = [r["body"]["server"]["latency_s"] for r in ok]
    run.stderr.append(f"serve: {n_req} requests at {rate}/s, generator at most "
                      f"{max(r['sent'] - r['due'] for r in records) * 1e3:.3f} ms late")
    run.units = [{"seed": requests[k]["seed"], "body": r["body"]}
                 for k, r in enumerate(records) if r["ok"]]
    run.memory_peak_bytes = got["memory_peak_bytes"]
    run.state["device_name"] = got["device_name"]
    if got["trace"] is not None:
        run.device_trace = trace.DeviceTrace(**got["trace"])
    drivers = len(ok[0]["body"]["win_probabilities"]) if ok else 0
    run.work = {"requests": got["requests"], "drivers": drivers, "n_simulations": n_sims,
                "laps": run.cell.config["calendar_laps"][run.param("race")],
                "kernels": kernel_counts(before, after)}
    run.stderr.append(f"serve: {drivers} drivers; kernel counters {run.work['kernels']}")


def check(run: Run) -> list[Check]:
    """`serve.check`: every body's plan-set fields, a sample in full."""
    with roster.exact_float32():
        return serve.check(run)


def control(run: Run) -> dict:
    with roster.exact_float32():
        return serve.control(run)


def main(argv: list[str]) -> int:
    """The knee: for each rate the requests sent and completed, the
    completed rate, p50 and p95 in ms, and the backlog's growth (the mean
    latency of the last fifth of the requests over the first fifth)."""
    p = argparse.ArgumentParser(prog="python -m perfbench.drivers.serve_field")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    cell = spec.find_cell(harness.ROOT, args.workload)
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
              t0=time.perf_counter())
    harness.program_env()
    made = world(run)
    child = serve.Child(run, made.cache_dir)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            n = max(1, round(rate * args.seconds))
            gaps = serve.arrival_gaps(n, rate, int(run.param("arrival_seed")))
            start = time.perf_counter()
            recs = serve.open_loop(child.port, _requests(run, [0] * n), start + np.cumsum(gaps),
                                   args.seconds + 300)
            lat = [r["end"] - r["due"] for r in recs if r["status"] == 200]
            fifth = max(len(lat) // 5, 1)
            print(json.dumps({
                "rate": rate, "sent": n, "completed": len(lat),
                "completed_per_s": len(lat) / (max(r["end"] for r in recs) - start),
                "p50_ms": 1e3 * statistics.median(lat), "p95_ms": 1e3 * serve.p95(lat),
                "backlog_growth": statistics.mean(lat[-fifth:]) / statistics.mean(lat[:fifth]),
            }), flush=True)
    finally:
        child.close()
        made.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
