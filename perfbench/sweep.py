"""The knee of a `serve` cell: the highest rate the server sustains, found
once when the cell is defined, by one server (`drivers/serve_child.py`)
offered open-loop Poisson load at each rate in turn: the cell's own draw
of arrivals (`serve.arrival_gaps` at the traffic's `arrival_seed`), scaled
to the rate. For each rate it
prints the requests sent and completed, the completed rate, p50 and p95 in
ms, and the backlog's growth: the mean latency of the last fifth of the
requests over that of the first fifth (about 1 while the queue is steady,
growing past capacity).

    python -m perfbench.sweep --workload serve.elo.1m --rates 10,12,14 --seconds 20
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

from perfbench import harness, spec
from perfbench.drivers import common, serve


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="python -m perfbench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    cell = spec.find_cell(harness.ROOT, args.workload)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=False,
                      t0=time.perf_counter())
    harness.program_env()
    world = common.world(run)
    child = serve.Child(run, world.cache_dir)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            n = max(1, round(rate * args.seconds))
            gaps = serve.arrival_gaps(n, rate, int(run.param("arrival_seed")))
            body = {"season": run.param("season"), "race": run.param("race"),
                    "prediction_point": run.param("prediction_point"),
                    "n_simulations": run.param("n_simulations"), "seed": 0}
            start = time.perf_counter()
            recs = serve.open_loop(child.port, [body] * n, start + np.cumsum(gaps),
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
        world.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
