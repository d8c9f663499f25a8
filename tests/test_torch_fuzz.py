"""Property tests of the port (the twin of tests/test_fuzz.py): random valid
parameter sets always give finite, doubly stochastic finish histograms, on
the race kernel's plain version ("kernel") and on the lap engine ("lap"),
across track conditions, event rates, grid shapes and field sizes. The
parameter sets are the JAX test's, drawn by its own `random_params`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import engine
from monte_carlo_gp_torch.ops import race_kernel as rk
import test_fuzz

torch.set_num_threads(2)


def random_params(rng: np.random.Generator):
    """The port's SimParams of the JAX test's random draw: its
    `random_params` with the keyword arguments it passes to
    `make_sim_params` taken over (same rng calls, same values)."""
    real = test_fuzz.make_sim_params
    test_fuzz.make_sim_params = lambda **kwargs: kwargs
    try:
        kwargs, d = test_fuzz.random_params(rng)
    finally:
        test_fuzz.make_sim_params = real
    return make_sim_params(**kwargs), d


def run(which, params, seed, n, laps):
    if which == "kernel":
        return rk.run_monte_carlo_kernel(params, seed, n, laps).numpy()
    return engine.run_monte_carlo(params, seed, n, laps).numpy()


@pytest.mark.slow
@pytest.mark.parametrize("which", ["kernel", "lap"])
@pytest.mark.parametrize("case", range(8))
def test_random_params_produce_valid_histograms(case, which):
    rng = np.random.default_rng(1000 + case)
    params, d = random_params(rng)
    laps = int(rng.integers(5, 30))
    probs = run(which, params, case, 512, laps)
    assert probs.shape == (d, d)
    assert np.isfinite(probs).all(), (case, probs)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(probs.sum(axis=0), 1.0, atol=1e-5)
    assert (probs >= 0).all()


@pytest.mark.slow
@pytest.mark.parametrize("which", ["kernel", "lap"])
def test_extreme_rates_every_lap_event(which):
    """All event probabilities at 1.0: a red flag fires every lap (the
    priority chain), still a valid race."""
    params, d = random_params(np.random.default_rng(99))
    one = torch.ones(())
    params = dataclasses.replace(params, sc_prob=one, vsc_prob=one, red_flag_prob=one)
    probs = run(which, params, 0, 256, 15)
    assert np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["kernel", "lap"])
def test_single_driver_field(which):
    params = make_sim_params(
        grid_probs=np.ones((1, 1), np.float32),
        base_pace=np.array([90.0], np.float32),
        tire_deg=np.array([0.05], np.float32),
        variance=np.array([0.15], np.float32),
        dnf_rate=np.array([0.01], np.float32),
        team_dnf_rate=np.array([0.01], np.float32),
    )
    probs = run(which, params, 0, 128, 10)
    assert probs.shape == (1, 1) and probs[0, 0] == 1.0
