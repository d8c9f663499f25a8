"""The port's lap engine (`monte_carlo_gp_torch.ops.engine`) against the JAX
package's XLA engine and the native oracle, and the routes that take it:
fields of more than 128 drivers in `F1Predictor.simulate_plan` and in the
season paths.

The engine draws from its own Philox stream, so every comparison with
another engine is in distribution: per-driver total variation (TV) of the
finish distributions, under the bound the JAX package holds its own engines
to at the same simulation counts.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.models.predictor import F1Predictor, WeekendPlan
from monte_carlo_gp_torch.ops import engine, philox
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.validate import backtest as tbt
from monte_carlo_gp_tpu.config import make_sim_params as jax_make_sim_params
from test_torch_race_kernel import XLA_REGIMES, stress_fields

torch.set_num_threads(2)


def tv(a, b):
    return 0.5 * np.abs(np.asarray(a) - np.asarray(b)).sum(axis=1)


@pytest.mark.parametrize("regime", sorted(XLA_REGIMES))
def test_distribution_matches_jax_xla_engine(regime):
    """16,384 sims per side, 20 drivers, 20 laps: per-driver TV below 0.07,
    the bound the JAX package holds its Pallas kernel to against the XLA
    engine (Monte Carlo noise floor ~0.04 at this size)."""
    from monte_carlo_gp_tpu.ops.engine import run_monte_carlo as jax_run_monte_carlo

    fields = {**stress_fields(), **XLA_REGIMES[regime]}
    n, laps = 16_384, 20
    xla = np.asarray(
        jax_run_monte_carlo(jax_make_sim_params(**fields), jax.random.PRNGKey(6), n, laps)
    )
    port = engine.run_monte_carlo(make_sim_params(**fields), 5, n, laps).numpy()
    np.testing.assert_allclose(port.sum(axis=1), 1.0, atol=1e-5)
    assert tv(port, xla).max() < 0.07, tv(port, xla)


def test_distribution_matches_native_oracle():
    """32,768 sims per side, 20 drivers, 30 laps: per-driver TV below 0.05,
    about 3x the Monte Carlo noise (the race kernel's bound in
    tests/test_torch_race_kernel.py)."""
    from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle

    params = make_sim_params(**stress_fields())
    n, laps = 32_768, 30
    port = engine.run_monte_carlo(params, 11, n, laps).numpy()
    native = run_native_oracle(params, seed=42, n_sims=n, total_laps=laps)
    assert tv(port, native).max() < 0.05, tv(port, native)


def test_counts_do_not_depend_on_sims_per_block():
    """The Philox counter holds the global simulation index, so blocks of
    1,000 (the last one ragged) give the same counts as one block."""
    params = make_sim_params(**stress_fields(12))
    whole = engine.run_monte_carlo(params, 3, 2_500, 15)
    blocked = engine.run_monte_carlo(params, 3, 2_500, 15, sims_per_block=1_000)
    torch.testing.assert_close(whole, blocked, rtol=0, atol=0)
    other = engine.run_monte_carlo(params, 4, 2_500, 15)
    assert not torch.equal(whole, other)


def wide_fields(d):
    """`tests/test_pallas_engine.py::_wide_field_plan`'s field."""
    return dict(
        grid_probs=np.full((d, d), 1.0 / d, np.float32),
        base_pace=90 + 0.05 * np.arange(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


def wide_plan(d, total_laps=10):
    drivers = [f"D{i:03d}" for i in range(d)]
    return WeekendPlan(
        params=make_sim_params(**wide_fields(d)),
        total_laps=total_laps,
        drivers=drivers,
        quali_probs={dr: [1.0 / d] * d for dr in drivers},
        weather={},
        prediction_point="fp2",
        grid_is_actual=False,
    )


def test_150_driver_field_is_a_distribution():
    """Above 128 drivers the ranks take the exact lexicographic path: every
    driver finishes somewhere and every position is taken, every race."""
    probs = engine.run_monte_carlo(make_sim_params(**wide_fields(150)), 1, 256, 10)
    assert probs.shape == (150, 150) and probs.dtype == torch.float32
    torch.testing.assert_close(probs.sum(1), torch.ones(150), rtol=0, atol=1e-6)
    torch.testing.assert_close(probs.sum(0), torch.ones(150), rtol=0, atol=1e-6)


def bare_predictor(device="cpu"):
    p = F1Predictor.__new__(F1Predictor)  # simulate_plan needs no loader
    p.device = torch.device(device)
    p.last_effective_sims = None
    return p


@pytest.mark.parametrize("d", [40, 150])
def test_simulate_plan_routes_by_field_size(d, caplog, monkeypatch):
    """40 drivers run the race kernel (its plain version, on CPU tensors);
    150 run the lap engine and log `engine_fallback_eager`, the counterpart
    of the JAX package's `engine_fallback_xla`."""
    plain_calls = []
    real_plain = rk.race_counts_plain
    monkeypatch.setattr(rk, "race_counts_plain",
                        lambda *a, **k: plain_calls.append(1) or real_plain(*a, **k))
    calls = engine.run_monte_carlo.calls
    p = bare_predictor()
    with caplog.at_level(logging.INFO, logger="mcgp"):
        probs = p.simulate_plan(wide_plan(d), 300, seed=0)
    assert probs.shape == (d, d) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    assert p.last_effective_sims == 300
    fell_back = "engine_fallback_eager" in caplog.text
    if d <= rk.MAX_DRIVERS:
        assert (len(plain_calls), engine.run_monte_carlo.calls - calls, fell_back) == (1, 0, False)
    else:
        assert (len(plain_calls), engine.run_monte_carlo.calls - calls, fell_back) == (0, 1, True)
        want = engine.run_monte_carlo(wide_plan(d).params, 0, 300, 10).numpy()
        np.testing.assert_array_equal(probs, want)


def test_season_with_a_150_driver_race_runs_race_by_race():
    """A season whose widest field is over 128 drivers runs each race
    through `simulate_plan` at `fold_in(season_seed, r)`: race 1 (150
    drivers) equals one engine run at that seed exactly, and race 0 (20
    drivers) the race kernel's run at its own seed."""
    season_seed, n = 77, 200
    plans = [wide_plan(20, 12), wide_plan(150, 8)]
    p = bare_predictor()
    calls = engine.run_monte_carlo.calls
    probs = tbt.simulate_season_plans(p, plans, season_seed, n)
    assert engine.run_monte_carlo.calls - calls == 1
    assert [a.shape for a in probs] == [(20, 20), (150, 150)]
    want1 = engine.run_monte_carlo(plans[1].params, philox.fold_in(season_seed, 1), n, 8)
    np.testing.assert_array_equal(probs[1], want1.numpy())
    want0 = rk.run_monte_carlo_kernel(plans[0].params, philox.fold_in(season_seed, 0), n, 12)
    np.testing.assert_array_equal(probs[0], want0.numpy())
    # the sweep's hook: overridden params take the same route
    wide = dataclasses.replace(plans[1].params, sc_prob=torch.tensor(0.5))
    probs2 = tbt.simulate_season_plans(p, plans, season_seed, n,
                                       params_list=[plans[0].params, wide])
    np.testing.assert_array_equal(probs2[0], probs[0])
    assert not np.array_equal(probs2[1], probs[1])
