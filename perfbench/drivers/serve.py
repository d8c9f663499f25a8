"""`/predict` clients, open loop: independent clients send requests on a
schedule whatever the server is doing, to the program's server in a child
process (`serve_child.py`).

The traffic names the weekend every request asks for (its plan is warmed
at set-up, so each request hits the plan cache), the simulations, and the
rate. The arrivals are Poisson at that rate: exponential gaps of one draw,
made from the traffic's `arrival_seed`, the same in every run, so a run's
seed does not change the load it offers (a draw of its own moved the p95 of
one seed's arrivals from 300 ms to another's 520); each request has a
simulation seed drawn from the run's seed. A request is timed at the client
from when it was due; one that fails is given the window's whole length,
which misses any tail. `request_p95_ms` is the nearest-rank 95th percentile
of every request of the window.
"""

from __future__ import annotations

import http.client
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from perfbench import compare, spec, trace
from perfbench.drivers import common
from perfbench.harness import ROOT, Check, Run
from perfbench.reference import run as ref

READY_TIMEOUT_S = 1100  # a checkout's first run builds the kernels


class Child:
    """The server process, stopped and waited for by `close`."""

    def __init__(self, run: Run, cache_dir: Path):
        self.log = tempfile.TemporaryFile(mode="w+")
        self.out = Path(tempfile.mkstemp(prefix="perfbench-serve-", suffix=".json")[1])
        self.traffic = self.traffic_file(run)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "perfbench.drivers.serve_child", "--cache", str(cache_dir),
             "--config", str(spec.HERE / "configs" / f"{run.cell.config['name']}.json"),
             "--traffic", str(self.traffic), "--trace", str(int(run.trace)),
             "--out", str(self.out), "--device", run.device],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=self.log, text=True)
        self.port = int(self.expect("ready", READY_TIMEOUT_S).split()[1])

    @staticmethod
    def traffic_file(run: Run) -> Path:
        """The traffic as the child reads it, with the run's overrides."""
        path = Path(tempfile.mkstemp(prefix="perfbench-traffic-", suffix=".json")[1])
        path.write_text(json.dumps({**run.cell.traffic, **run.overrides}))
        return path

    def expect(self, word: str, timeout: float) -> str:
        """The child's next line, which must start with `word`."""
        result: list[str] = []
        reader = threading.Thread(target=lambda: result.append(self.proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout)
        line = result[0] if result else ""
        if not line.startswith(word):
            raise RuntimeError(f"the server said {line!r}, not {word!r}:\n{self.tail()}")
        return line

    def send(self, command: str) -> None:
        self.proc.stdin.write(command + "\n")
        self.proc.stdin.flush()

    def tail(self) -> str:
        self.log.seek(0)
        return self.log.read()[-4000:]

    def stop(self, timeout: float = 120) -> dict:
        """Close the window; what the child measured."""
        self.send("stop")
        if self.proc.wait(timeout) != 0:
            raise RuntimeError(f"the server exited {self.proc.returncode}:\n{self.tail()}")
        return json.loads(self.out.read_text())

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self.log.close()
        self.out.unlink(missing_ok=True)
        self.traffic.unlink(missing_ok=True)


def arrival_gaps(n: int, rate: float, arrival_seed: int) -> np.ndarray:
    """The gaps of n Poisson arrivals at `rate`: n standard exponentials of
    the draw `arrival_seed` makes, over the rate. A draw's first gaps do not
    depend on n, and every rate scales the same draw."""
    return np.random.default_rng(arrival_seed).standard_exponential(n) / rate


def post(port: int, body: dict, timeout: float) -> tuple[int, dict | None]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", "/predict", json.dumps(body), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, json.loads(data) if resp.status == 200 else None
    except (OSError, http.client.HTTPException, ValueError):
        return 0, None
    finally:
        conn.close()


def open_loop(port: int, requests: list[dict], due: np.ndarray, timeout: float) -> list[dict]:
    """Send request k at `due[k]` (perf_counter seconds) whatever came back;
    each record holds its due, send and end times, status and body."""
    records = [{"due": float(t)} for t in due]

    def one(k: int) -> None:
        rec = records[k]
        rec["sent"] = time.perf_counter()
        rec["status"], rec["body"] = post(port, requests[k], timeout)
        rec["end"] = time.perf_counter()

    with ThreadPoolExecutor(max_workers=min(len(requests), 256)) as pool:
        futures = []
        for k, t in enumerate(due):
            wait = t - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            futures.append(pool.submit(one, k))
        for f in futures:
            f.result()
    return records


def p95(values: list[float]) -> float:
    """The nearest-rank 95th percentile."""
    ordered = sorted(values)
    return ordered[max(math.ceil(0.95 * len(ordered)) - 1, 0)]


def measure(run: Run) -> None:
    world = common.world(run)  # the card is the server's alone until it exits
    child = Child(run, world.cache_dir)
    run.state["server"] = child
    common.ready(run, sync=False)
    n_sims, rate = run.param("n_simulations"), float(run.param("rate_per_s"))
    n_req = max(1, round(rate * run.seconds))
    gaps = arrival_gaps(n_req, rate, int(run.param("arrival_seed")))
    seeds = run.rng("sims").integers(2**31, size=n_req)
    requests = [{"season": run.param("season"), "race": run.param("race"),
                 "prediction_point": run.param("prediction_point"), "n_simulations": n_sims,
                 "seed": int(s)} for s in seeds]
    child.send("start")
    child.expect("started", 60)
    start = time.perf_counter()
    records = open_loop(child.port, requests, start + np.cumsum(gaps), run.seconds + 300)
    elapsed = max(r["end"] for r in records) - start
    got = child.stop()
    if got["forbidden"]:
        raise RuntimeError(f"the server loaded {got['forbidden']}")
    run.attempted = n_req
    for r in records:
        r["ok"] = r["status"] == 200 and r["body"] is not None
    ok = [r for r in records if r["ok"]]
    run.failed = n_req - len(ok)
    latencies = [(r["end"] - r["due"]) if r["ok"] else elapsed for r in records]
    run.e2e["request_p95_ms"] = 1e3 * p95(latencies)
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
                "laps": run.cell.config["calendar_laps"][run.param("race")]}


def _body_gap(body: dict, result: dict, n_sims: int, seed: int) -> float:
    server = body.get("server", {})
    if server.get("n_simulations") != n_sims or server.get("seed") != seed:
        return compare.INF
    return compare.result_gap(body, result)


def check(run: Run) -> list[Check]:
    """Every body's plan-set fields against the reference's plan of the
    weekend; a sample of bodies, simulated by the reference, in full."""
    gaps = {"body": 0.0}
    if not run.units:
        gaps["body"] = compare.INF
        return common.checks(run, gaps)
    pred, plan = ref.weekend_plan(run.state["world"].cache_dir, run.param("season"),
                                  run.param("race"), run.param("prediction_point"),
                                  run.param("quali_model"), run.device,
                                  fit=run.cell.config.get("fit"))
    n = run.param("n_simulations")
    fields = ref.weekend_fields(pred, plan, n)
    for unit in run.units:
        common.worst(gaps, body=compare.fixed_gap(unit["body"], fields))
    for unit in common.sample(run, run.units):
        result = ref.weekend_result(pred, plan, n, unit["seed"], run.device)
        common.worst(gaps, body=_body_gap(unit["body"], result, n, unit["seed"]))
    return common.checks(run, gaps)


def control(run: Run) -> dict:
    """The control's gaps from the reference on the units `check` takes."""
    gaps = {"body": 0.0}
    args = (run.state["world"].cache_dir, run.param("season"), run.param("race"),
            run.param("prediction_point"), run.param("quali_model"), run.device)
    fit = run.cell.config.get("fit")
    pred, plan = ref.weekend_plan(*args, fit=fit)
    cpred, cplan = ref.weekend_plan(*args, lowp=True, fit=fit)
    n = run.param("n_simulations")
    for unit in common.sample(run, run.units):
        result = ref.weekend_result(pred, plan, n, unit["seed"], run.device)
        cresult = ref.weekend_result(cpred, cplan, n, unit["seed"], run.device, lowp=True)
        cresult["server"] = {"n_simulations": n, "seed": unit["seed"]}
        common.worst(gaps, body=_body_gap(cresult, result, n, unit["seed"]))
    return gaps
