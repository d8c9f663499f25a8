"""The engine choice and the mesh in the port's routes: `resolve_engine`,
`--engine auto|xla|pallas` on the three CLIs (`python -m monte_carlo_gp_torch`,
`… .backtest`, `… .tune`), and a mesh of several shards sending
`simulate_plan` and `simulate_season_plans` to the sharded entries (after
tests/test_pallas_engine.py::test_simulate_plan_uses_sharded_pallas_on_multidevice).

On the CPU the race kernels run their plain versions, so the routes are read
from the calls of `race_counts_plain` and `season_counts_plain` and from the
lap engine's counter (`engine_counts.calls`, one per race and shard).
Everything runs on a three-race synthetic world.
"""

import functools

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch import backtest as backtest_cli
from monte_carlo_gp_torch import tune as tune_cli
from monte_carlo_gp_torch.__main__ import run as weekend_cli
from monte_carlo_gp_torch.data import synthetic
from monte_carlo_gp_torch.models import predictor as predictor_mod
from monte_carlo_gp_torch.models.predictor import F1Predictor, resolve_engine
from monte_carlo_gp_torch.ops import engine
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.parallel import mesh as mesh_mod
from monte_carlo_gp_torch.parallel.mesh import make_mesh
from monte_carlo_gp_torch.validate import backtest as tbt

torch.set_num_threads(2)

N_EVENTS = 3


@pytest.fixture
def routes(monkeypatch):
    """A three-race synthetic world for the CLIs, and the counts of every
    route's entry, set to 0."""
    monkeypatch.setattr(synthetic, "SyntheticBackend",
                        functools.partial(synthetic.SyntheticBackend, n_events=N_EVENTS))
    calls = {"race_plain": 0, "season_plain": 0}
    for name, key in (("race_counts_plain", "race_plain"), ("season_counts_plain", "season_plain")):
        real = getattr(rk, name)

        def spy(*a, _real=real, _key=key, **k):
            calls[_key] += 1
            return _real(*a, **k)

        monkeypatch.setattr(rk, name, spy)
    monkeypatch.setattr(engine.engine_counts, "calls", 0)

    def read():
        return dict(calls, engine_counts=engine.engine_counts.calls)

    return read


def test_resolve_engine():
    """`auto` is the race kernels on both devices (the port's plain version
    draws the kernel's own stream on the CPU, unlike the Pallas
    interpreter); unknown names raise, in the predictor too."""
    assert [resolve_engine(e) for e in ("auto", "pallas", "xla")] == ["pallas", "pallas", "xla"]
    with pytest.raises(ValueError, match="unknown engine"):
        resolve_engine("tpu")
    with pytest.raises(ValueError, match="unknown engine"):
        F1Predictor(device="cpu", engine="tpu")
    assert F1Predictor(device="cpu").engine == "pallas"


@pytest.mark.parametrize("engine_name", ["auto", "pallas", "xla"])
def test_weekend_cli_engine_flag(engine_name, routes, tmp_path):
    results, _ = weekend_cli(["--race", "Bahrain", "--season", "2024", "--synthetic",
                              "--device", "cpu", "--simulations", "512", "--seed", "1",
                              "--engine", engine_name, "--cache-dir", str(tmp_path)])
    got = routes()
    if engine_name == "xla":
        assert (got["race_plain"], got["engine_counts"]) == (0, 1)
    else:
        assert (got["race_plain"], got["engine_counts"]) == (1, 0)
    wins = results["win_probabilities"]
    assert abs(sum(wins.values()) - 1.0) < 1e-5 and results["n_simulations_effective"] == 512


@pytest.mark.parametrize(
    "engine_name, batched",
    [("auto", True), ("pallas", True), ("xla", True), ("xla", False)],
    ids=["auto_batched", "pallas_batched", "xla_batched", "xla_sequential"],
)
def test_backtest_cli_engine_flag(engine_name, batched, routes, tmp_path):
    out = backtest_cli.run(["--synthetic", "--seasons", "2024", "--device", "cpu",
                            "--simulations", "128", "--engine", engine_name,
                            "--cache-dir", str(tmp_path), *(["--batched"] if batched else [])])
    got = routes()
    assert out["n_races"] == N_EVENTS
    if engine_name != "xla":
        assert (got["season_plain"], got["engine_counts"]) == (1, 0)
    elif batched:
        # the lap-engine season: each race once over the one-shard mesh
        assert (got["season_plain"], got["race_plain"], got["engine_counts"]) == (0, 0, N_EVENTS)
    else:
        assert (got["race_plain"], got["engine_counts"]) == (0, N_EVENTS)


@pytest.mark.parametrize("engine_name", ["auto", "pallas", "xla"])
def test_tune_cli_engine_flag(engine_name, routes, tmp_path):
    out = tune_cli.run(["--synthetic", "--seasons", "2024", "--device", "cpu",
                        "--simulations", "128", "--grid", "sc_prob=0.01",
                        "--engine", engine_name, "--cache-dir", str(tmp_path)])
    got = routes()
    runs = out["n_configs"] + 1  # and the default
    if engine_name == "xla":
        assert (got["season_plain"], got["engine_counts"]) == (0, runs * N_EVENTS)
    else:
        assert (got["season_plain"], got["engine_counts"]) == (runs, 0)


# -- a mesh of several shards ------------------------------------------------------------


@pytest.fixture(scope="module")
def weekend(tmp_path_factory):
    p = F1Predictor(cache_dir=tmp_path_factory.mktemp("weekend"), device="cpu",
                    backend=synthetic.SyntheticBackend(seed=5, n_events=2))
    return p, p.prepare_weekend(2024, "Bahrain")


@pytest.mark.parametrize("engine_name", ["pallas", "xla"])
def test_simulate_plan_on_a_split_mesh_takes_the_sharded_entry(engine_name, weekend, monkeypatch):
    """A mesh of two shards sends `simulate_plan` to the sharded entry of
    its engine, with the mesh, and the probabilities are those of the
    one-shard default mesh, which takes the same entry."""
    p, plan = weekend
    entry = {"pallas": "run_monte_carlo_kernel_sharded", "xla": "run_monte_carlo_sharded"}[engine_name]
    seen = []
    real = getattr(predictor_mod, entry)
    monkeypatch.setattr(predictor_mod, entry, lambda *a: seen.append(a[-1].size) or real(*a))
    split = p.simulate_plan(plan, 300, seed=1, engine=engine_name, mesh=make_mesh(devices=["cpu"] * 2))
    whole = p.simulate_plan(plan, 300, seed=1, engine=engine_name)
    assert seen == [2, 1]
    np.testing.assert_array_equal(split, whole)
    assert p.last_effective_sims == 300


def test_wide_weekend_splits_any_simulation_count():
    """A 150-driver weekend (the lap engine) at 1,001 simulations over a
    mesh of 3 shards, which do not divide them: the split runs, and equals
    the unsplit lap engine bit for bit."""
    from test_torch_engine import bare_predictor, wide_plan

    plan = wide_plan(150, 6)
    probs = bare_predictor().simulate_plan(plan, 1001, seed=4, mesh=make_mesh(devices=["cpu"] * 3))
    want = engine.run_monte_carlo(plan.params, 4, 1001, 6).numpy()
    np.testing.assert_array_equal(probs, want)


def test_season_on_a_split_mesh_takes_one_launch_per_shard(weekend, monkeypatch):
    p, plan = weekend
    plans = [plan, plan]
    seen = []
    real = rk.season_counts_sharded
    monkeypatch.setattr(rk, "season_counts_sharded",
                        lambda *a, **k: seen.append(a[-1].size) or real(*a, **k))
    split = tbt.simulate_season_plans(p, plans, 17, 250, mesh=make_mesh(devices=["cpu"] * 3))
    whole = tbt.simulate_season_plans(p, plans, 17, 250)
    # the one-shard default mesh takes the same entry
    assert seen == [3, 1] and len(split) == 2
    for a, b in zip(split, whole):
        np.testing.assert_array_equal(a, b)
    # the lap-engine season on the same mesh is split too, each race once
    spy = []
    real_counts = mesh_mod.sharded_engine_counts
    monkeypatch.setattr("monte_carlo_gp_torch.parallel.sharded.sharded_engine_counts",
                        lambda *a, **k: spy.append(a[-1].size) or real_counts(*a, **k))
    xla = tbt.simulate_season_plans(p, plans, 17, 250, engine="xla",
                                    mesh=make_mesh(devices=["cpu"] * 3))
    assert spy == [3] and [x.shape for x in xla] == [a.shape for a in whole]


def test_batched_backtest_xla_against_pallas(tmp_path):
    """The batched backtest on the lap engine against the race kernel
    (after tests/test_validation.py:138): pole Brier equal (the qualifying
    model alone sets it), win Brier within 0.01 (Monte Carlo noise of two
    engines on two streams at 4,096 simulations per race)."""
    def factory(engine_name):
        return lambda: F1Predictor(cache_dir=tmp_path / engine_name, device="cpu",
                                   backend=synthetic.SyntheticBackend(seed=5, n_events=N_EVENTS),
                                   engine=engine_name)

    xla = tbt.backtest_model_batched(factory("xla"), [2024], seed=3, n_simulations=4096,
                                     verbose=False)
    pallas = tbt.backtest_model_batched(factory("pallas"), [2024], seed=3, n_simulations=4096,
                                        verbose=False)
    assert xla["n_races"] == pallas["n_races"] == N_EVENTS
    assert xla["pole_brier"] == pallas["pole_brier"]
    assert abs(xla["win_brier"] - pallas["win_brier"]) <= 0.01
