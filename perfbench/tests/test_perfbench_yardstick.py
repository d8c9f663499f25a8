"""The yardstick: traffic that repeats per seed, the frozen operation and
byte counts at a hand-counted shape, the idle share's union, the result
line's keys, and the whole-name import guard."""

from __future__ import annotations

import json
import math
import subprocess
import sys

import numpy as np
import pytest

from perfbench import harness, roofline, spec, trace
from perfbench.drivers import common, serve, weekend

ROOT = harness.ROOT


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 3_000_000_011, -3])
def test_traffic_repeats_per_seed(seed):
    for tags in (("order",), ("sims",), ("world",), ("check",)):
        a, b = harness.derive(seed, *tags), harness.derive(seed, *tags)
        assert np.array_equal(a.integers(2**31, size=50), b.integers(2**31, size=50))
    assert np.array_equal(serve.arrival_gaps(300, 12.0, 20240302),
                          serve.arrival_gaps(300, 12.0, 20240302))


def test_arrivals_are_one_poisson_draw_for_every_seed():
    traffic = json.loads((ROOT / "perfbench/traffic/serve-bahrain-1m.json").read_text())
    a = serve.arrival_gaps(4000, 12.0, traffic["arrival_seed"])
    assert (a > 0).all()
    assert a.mean() == pytest.approx(1 / 12.0, rel=0.05)  # at the rate
    assert a.std() == pytest.approx(1 / 12.0, rel=0.05)  # exponential, not spread evenly
    # the count in a second is Poisson: its variance about its mean
    counts = np.bincount(np.cumsum(a).astype(int))[:-1]
    assert counts.var() / counts.mean() == pytest.approx(1.0, abs=0.2)
    assert np.array_equal(serve.arrival_gaps(25, 12.0, traffic["arrival_seed"]), a[:25])
    assert np.allclose(serve.arrival_gaps(25, 6.0, traffic["arrival_seed"]), 2 * a[:25])
    assert not np.array_equal(serve.arrival_gaps(25, 12.0, 1), a[:25])
    assert harness.derive(1, "order").permutation(20).tolist() != \
        harness.derive(2, "order").permutation(20).tolist()


def _sampled_run(n_units: int, check_units: int, seed: int = 3) -> harness.Run:
    cell = spec.find_cell(ROOT, "weekend.elo.1m")
    return harness.Run(cell=cell, seed=seed, seconds=1, trace=False, t0=0.0,
                       overrides={"check_units": check_units},
                       units=[{"race": None} for _ in range(n_units)])


@pytest.mark.parametrize("seed", [1, 2, 3, 2**31 + 9])
def test_the_sample_covers_each_group(seed):
    run = _sampled_run(40, 3, seed)
    groups = [[5, 17, 30], [2, 5, 9, 17, 22, 30], [11, 31]]
    picked = common.sample(run, list(range(40)), groups)
    assert len(picked) == 3 and len(set(picked)) == 3
    assert all(set(picked) & set(g) for g in groups)
    assert picked == common.sample(run, list(range(40)), groups)  # repeats per seed
    # a group the window did not reach is left out; the rest are drawn
    assert len(common.sample(run, list(range(40)), [[], [4]])) == 3
    assert len(common.sample(_sampled_run(2, 3, seed), [0, 1], [[1], [0, 1], []])) == 2


def test_the_weekend_sample_takes_a_wet_sprint_and_the_longest_race():
    cell = spec.find_cell(ROOT, "weekend.elo.1m")
    races = list(cell.config["calendar_laps"]) * 2
    run = _sampled_run(len(races), 3)
    run.units = [{"race": r} for r in races]
    picked = [u["race"] for u in common.sample(run, run.units, weekend.cover(run))]
    assert len(picked) == 3
    assert set(picked) & {"Belgium", "Brazil"}
    assert set(picked) & set(cell.config["sprint_events"])
    assert "Monaco" in picked


def test_race_counts_at_a_hand_counted_shape():
    # 2 cars, 3 laps, 1 simulation: per car 17*2 + 49 + 61*2 = 205
    assert roofline.race_flops(2, 3, 1) == 410
    assert roofline.race_flops(20, 57, 1_048_576) == 1_048_576 * 20 * (340 + 49 + 56 * 61)
    # pmat 2x8, 24 scalars, grid_log 2x2 and counts 2x2, 4 bytes each
    assert roofline.race_bytes(2) == 4 * (16 + 24 + 4 + 4)


def test_hmc_counts_at_a_hand_counted_shape():
    # k = 2 columns, 3 non-zero counts, 1 chain, 1 leapfrog step: 2 gradients
    f64, f32 = roofline.hmc_ops(2, 3, 1, 1)
    assert f64 == 2 * (2 * 3 + 7 * 2 + 1)
    assert f32 == 2 * (10 * 2 + 5 * 7 + 25) + (8 * 7 + 2 * 2 + 30)
    assert roofline.hmc_ops(2, 3, 1, 1, adapt=True)[1] == f32 + 10 + 5 * 7
    assert roofline.hmc_bytes(2, 1) == 8 * (4 + 2) + 4 * (2 * 7 + 2) + 4 * (7 + 2) + 4 * (7 + 2)
    assert roofline.hmc_bytes(2, 1, trace=True) == roofline.hmc_bytes(2, 1) + 4 * (7 + 3)


def test_bound_is_the_slower_unit():
    assert roofline.bound_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.bound_s(67e12, 0, 68e12) == pytest.approx(2.0)
    assert roofline.fit_bound_s(50, 1290, 4, 48, 1000, 1000) > 0


def test_idle_share_is_the_union_of_device_work():
    device = [(1.0, 2.0, "k1"), (1.5, 2.5, "k2"), (4.0, 4.5, "k1"), (9.0, 11.0, "k3")]
    spans = [(0.0, 3.0, "prepare"), (3.0, 10.0, "simulate"), (3.5, 4.0, "assemble")]
    t = trace.summarize(device, spans, (0.0, 10.0))
    assert t.busy_s == pytest.approx(1.5 + 0.5 + 1.0)
    assert t.window_s == 10.0
    assert t.kernel_time("k1") == pytest.approx(1.5)
    assert t.device_ops[0] == ["k3", 2.0]
    # the gap [2.5, 4] lies in simulate (1.5 s) more than in assemble (0.5 s)
    assert t.idle_gaps[0] == ["simulate", pytest.approx(4.5)]
    assert ["simulate", pytest.approx(1.5)] in t.idle_gaps
    assert ["prepare", pytest.approx(1.0)] in t.idle_gaps
    assert trace.label((0.0, 10.0), [(0.0, 1.0, "request")]) == "outside spans"
    assert trace.label((0.0, 10.0), [(0.0, 6.0, "request")]) == "request"
    assert trace.union([(0, 1), (1, 2), (3, 4)]) == [(0, 2), (3, 4)]
    assert trace.gaps([(1, 2)], 0, 3) == [(0, 1), (2, 3)]


def _run(trace_on: bool) -> harness.Run:
    cell = spec.find_cell(ROOT, "weekend.elo.1m")
    run = harness.Run(cell=cell, seed=1, seconds=1, trace=trace_on, t0=0.0)
    run.e2e = {"weekend_s": 1.5, "setup_s": 20.0}
    run.spans.times = {"prepare": [1.0, 2.0], "simulate": [0.06]}
    run.device_trace = trace.summarize([(0.0, 1.0, "race_kernel<1>")], [], (0.0, 4.0))
    return run


@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line_keys(trace_on):
    checks = [harness.Check("plan", 0.0, 1e-6), harness.Check("result", math.inf, 1e-3)]
    line = harness.result_line(_run(trace_on), checks)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert set(line) - set(keys) == ({"breakdown", "card", "checks"} if trace_on else
                                     {"card", "checks"})
    assert line["correct"] is False  # an infinite gap fails
    assert line["checks"]["result"]["value"] is None
    json.loads(harness.dumps(line))
    if trace_on:
        assert set(line["metrics"]) == {"prepare_s.weekend", "simulate_ms.weekend",
                                        "device_idle_pct.weekend"}
        assert line["metrics"]["device_idle_pct.weekend"]["value"] == pytest.approx(75.0)
        assert line["device"]["busy_s"] == 1.0 and line["device"]["window_s"] == 4.0
    else:
        assert set(line["metrics"]) == {"weekend_s", "setup_s"}


def test_import_guard_compares_whole_names():
    loaded = ["monte_carlo_gp_torch", "monte_carlo_gp_torch.ops", "jaxtyping", "flaxen",
              "numpy", "monte_carlo_gp_tpux"]
    assert harness.forbidden_modules(loaded) == []
    assert harness.forbidden_modules(loaded + ["jax.numpy", "monte_carlo_gp_tpu.ops", "flax",
                                               "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                              "monte_carlo_gp_tpu"]


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; import perfbench.reference.run, perfbench.world; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('monte_carlo_gp_torch', 'monte_carlo_gp_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
    for path in (spec.HERE / "reference").glob("*.py"):
        for line in path.read_text().splitlines():
            if line.lstrip().startswith(("import ", "from ")):
                assert "monte_carlo_gp" not in line and "jax" not in line, (path, line)
