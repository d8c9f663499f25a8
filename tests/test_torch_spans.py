"""The port's span and counter recorder (`utils/profiling.py`): the spans of
`prepare_weekend`, the server's handler and the walk-forward backtest, the
frame cache's and the race kernels' counters, and their readers (`--timings`, `/stats`, the
profile's own timeline).

Off a profile a span keeps its aggregates and opens no `record_function`
range; under `torch.profiler` it is a range of the profile, timed on the
same clock as the recorder's event.
"""

import json
import re
import threading
import time
import urllib.request
from http.server import HTTPServer
from pathlib import Path

import pandas as pd
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from monte_carlo_gp_torch import serve
from monte_carlo_gp_torch.__main__ import run
from monte_carlo_gp_torch.data import loader
from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
from monte_carlo_gp_torch.models.predictor import F1Predictor
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.utils.profiling import RECORDER, Phase, phase_report, span

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PREPARE_CHILDREN = ("weekend.elo", "weekend.archive", "weekend.session", "weekend.quali",
                    "weekend.practice", "weekend.params")
# a span's event and the profile's range of it differ by the range's own
# entry and exit (tens of µs)
SAME_CLOCK_US = 1000.0


def _predictor(cache_dir) -> F1Predictor:
    return F1Predictor(cache_dir=cache_dir, backend=SyntheticBackend(seed=5, n_events=3),
                       device="cpu")


def _events_since(t_ns: int) -> list:
    return [e for e in RECORDER.events if e.start_ns >= t_ns]


def test_a_span_off_a_profile_opens_no_range_but_keeps_its_aggregate(monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a span opened a record_function range with no profile recording")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    rec = Phase()
    for _ in range(2):
        with rec("outer"):
            with rec("inner"):
                pass
    rec.count("c", 3)
    assert not torch.autograd._profiler_enabled()
    assert rec.events == [] and rec.dropped == 0
    assert rec.counts == {"inner": 2, "outer": 2}
    assert rec.totals["outer"] >= rec.totals["inner"] >= 0.0
    assert [(path, agg[0]) for path, agg in rec.paths.items()] == [
        (("outer", "inner"), 2), (("outer",), 2)]
    n, total, own = rec.paths[("outer",)]
    assert own == total - rec.paths[("outer", "inner")][1]
    assert rec.counters == {"c": 3}
    before = len(RECORDER.events)
    with span("weekend.prepare"):
        pass
    assert len(RECORDER.events) == before


def test_a_span_that_raises_closes(monkeypatch):
    rec = Phase()
    with pytest.raises(ValueError):
        with rec("a"):
            with rec("b"):
                raise ValueError("inside")
    with rec("c"):
        pass
    assert set(rec.paths) == {("a", "b"), ("a",), ("c",)}


def test_prepare_weekend_spans_share_the_profile_clock(tmp_path):
    """Under a CPU profile a synthetic-world `prepare_weekend` records
    `weekend.prepare` and its six phases, each with its parent, and the
    Elo build's `elo.events` increments inside `weekend.elo`; the phases
    cover at least 90% of it; the profile holds each as a range whose
    length is the recorder's."""
    with profile(activities=[ProfilerActivity.CPU]):  # the ranges' first call, untimed
        with span("warm-up"):
            pass
    pred = _predictor(tmp_path)
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred.prepare_weekend(2024, "Bahrain")
    recorded = _events_since(t0)
    increments = [e for e in recorded if e.start_ns == e.end_ns]  # a counter's
    assert increments and {(e.name, e.parent) for e in increments} == {("elo.events", "weekend.elo")}
    events = {e.name: e for e in recorded if e not in increments}
    assert set(events) == {"weekend.prepare", *PREPARE_CHILDREN}
    parent = events["weekend.prepare"]
    assert parent.parent is None and parent.request is None
    for name in PREPARE_CHILDREN:
        e = events[name]
        assert e.parent == "weekend.prepare"
        assert parent.start_ns <= e.start_ns <= e.end_ns <= parent.end_ns
    covered = sum(events[n].end_ns - events[n].start_ns for n in PREPARE_CHILDREN)
    assert covered >= 0.9 * (parent.end_ns - parent.start_ns)
    ranges = {e.name: e.time_range.elapsed_us() for e in prof.events() if e.name in events}
    assert set(ranges) == set(events)
    for name, us in ranges.items():
        e = events[name]
        assert abs((e.end_ns - e.start_ns) / 1e3 - us) < SAME_CLOCK_US, name


def _post_and_serve(server, body: dict) -> dict:
    """POST `body` to /predict from a client thread while this thread
    handles the one request (as the benchmark's server child does)."""
    url = f"http://127.0.0.1:{server.server_address[1]}/predict"
    got = {}

    def client():
        req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got["status"], got["body"] = r.status, json.loads(r.read())

    thread = threading.Thread(target=client)
    thread.start()
    server.handle_request()
    thread.join(timeout=120)
    return got


def _stats_served(server) -> dict:
    """GET /stats from a client thread while this thread handles it."""
    stats = {}

    def client():
        url = f"http://127.0.0.1:{server.server_address[1]}/stats"
        with urllib.request.urlopen(url, timeout=60) as r:
            stats.update(json.loads(r.read()))

    thread = threading.Thread(target=client)
    thread.start()
    server.handle_request()
    thread.join(timeout=60)
    return stats


def test_a_served_request_records_its_spans_under_one_request_id(tmp_path):
    """A request through `serve.make_handler`: `serve.handle` holds
    `serve.read`, `serve.predict` (holding `serve.plan`) and `serve.reply`,
    all under one request id of their own; `/stats` serves their tree and
    the frame counters."""
    service = serve.PredictionService(_predictor(tmp_path), default_simulations=256)
    server = HTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    try:
        _post_and_serve(server, {"season": 2024, "race": "Bahrain", "seed": 1})
        t0 = time.perf_counter_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            got = _post_and_serve(server, {"season": 2024, "race": "Bahrain", "seed": 2})
        assert got["status"] == 200
        events = {e.name: e for e in _events_since(t0) if e.name.startswith("serve.")}
        assert set(events) == {"serve.handle", "serve.read", "serve.predict", "serve.plan",
                               "serve.reply"}
        assert {e.request for e in events.values()} == {events["serve.handle"].request}
        assert events["serve.handle"].request is not None
        assert events["serve.handle"].parent is None
        assert {events[n].parent for n in ("serve.read", "serve.predict", "serve.reply")} == {
            "serve.handle"}
        assert events["serve.plan"].parent == "serve.predict"

        stats = _stats_served(server)
    finally:
        server.server_close()
    handle = stats["spans"]["serve.handle"]
    assert handle["count"] >= 2 and handle["total_s"] > 0
    assert set(handle["children"]) == {"serve.read", "serve.predict", "serve.reply"}
    plan = handle["children"]["serve.predict"]["children"]["serve.plan"]
    assert plan["count"] >= 2
    # the first request prepared the weekend inside its plan lookup
    assert "weekend.prepare" in plan["children"]
    assert set(stats["frames"]) == {"read", "hit"}
    assert stats["plan_cache_hits"] >= 1


def test_stats_serve_the_race_kernels_counters(tmp_path):
    """`/stats` `kernels` holds the recorder's `race.cars`, `race.slots` and
    `race.packed`, which only a launch on the card raises: a request that
    the plain version serves on the CPU leaves them as they were, and what
    a launch counts (`race_kernel._count_launch`) shows in the next read."""
    service = serve.PredictionService(_predictor(tmp_path), default_simulations=64)
    server = HTTPServer(("127.0.0.1", 0), serve.make_handler(service))
    try:
        first = _stats_served(server)["kernels"]
        assert set(first) == {"cars", "slots", "packed"}
        got = _post_and_serve(server, {"season": 2024, "race": "Bahrain", "seed": 3})
        assert got["status"] == 200
        assert _stats_served(server)["kernels"] == first
        rk._count_launch(rk.kernel_tier(22), [22], 1 << 20)  # one-simulation-a-warp K1
        rk._count_launch(rk.kernel_tier(20), [20, 18], 3_000)  # a packed K2 of two races
        last = _stats_served(server)["kernels"]
    finally:
        server.server_close()
    assert {k: last[k] - first[k] for k in last} == {
        "cars": (22 << 20) + 38 * 3_000, "slots": (32 << 20) + 2 * 1_000 * 64, "packed": 2}


def test_a_parquet_file_read_twice_counts_one_read_and_one_hit(tmp_path):
    path = tmp_path / "laps_FP2.parquet"
    pd.DataFrame({"Driver": ["VER", "LEC"], "LapTime": [91.2, 91.5]}).to_parquet(path)
    before = RECORDER.copy()
    first = loader._read_parquet_cached(path)
    second = loader._read_parquet_cached(path)
    assert second is first
    assert RECORDER.since(before).counters == {"frames.read": 1, "frames.hit": 1}


def _program_span_names() -> set[str]:
    """Every span name the port opens, from its sources."""
    names = set()
    for path in (ROOT / "monte_carlo_gp_torch").rglob("*.py"):
        names |= set(re.findall(r"\bspan\(\s*\"([^\"]+)\"", path.read_text()))
    return names


def test_no_program_span_takes_a_benchmark_range_name():
    """The benchmark labels the device's idle gaps by its own ranges; a
    program span of the same name would change what they read."""
    from perfbench import trace
    from perfbench.drivers import season, weekend

    names = _program_span_names()
    assert {"weekend.prepare", *PREPARE_CHILDREN, "weekend.simulate", "simulate.upload",
            "simulate.launch", "simulate.readback", "weekend.assemble", "fit", "fit.design",
            "fit.chains", "fit.posterior", "backtest.prepare", "backtest.actuals",
            "backtest.simulate", "backtest.score", "serve.handle", "serve.read",
            "serve.predict", "serve.plan", "serve.reply", "tune.sweep", "tune.prepare",
            "tune.config", "tune.overrides", "tune.score", "tune.rank"} == names
    assert not names & (weekend.SPANS | season.SPANS | {"request", trace.WINDOW})


def test_timings_prints_the_span_tree(tmp_path, capsys):
    _, timers = run(["--race", "Bahrain", "--season", "2024", "--synthetic", "--device", "cpu",
                     "--simulations", "256", "--seed", "0", "--timings",
                     "--cache-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "span timings (total, self):" in out
    lines = out.splitlines()
    at = lines.index(next(line for line in lines if line.startswith("  weekend.prepare ")))
    children = [line.split()[0] for line in lines[at + 1:at + 1 + len(PREPARE_CHILDREN)]]
    assert children == list(PREPARE_CHILDREN)
    assert all(line.startswith("    weekend.") for line in lines[at + 1:at + 7])
    assert any(line.startswith("    simulate.launch ") for line in lines)
    assert "sims/sec on cpu" in out
    assert timers.counts["weekend.prepare"] == 1 and timers.counts["weekend.simulate"] == 1
    assert phase_report(timers) in out
