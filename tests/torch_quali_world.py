"""Shared inputs of the port's qualifying-model tests, importing torch and
the port only (so the GPU tests can use them on a machine without jax):
the small generative archive of tests/test_bayesian.py rebuilt from its
seed with numpy, and the walk-forward pole-Brier harness of
tests/test_validation.py:409-462 on the port."""

import numpy as np
import pandas as pd

TEAMS = [f"T{i}" for i in range(5)]
DRIVERS = [f"D{i}" for i in range(10)]
CIRCUITS = [f"C{i}" for i in range(6)]
TEAM_OF = {d: TEAMS[i // 2] for i, d in enumerate(DRIVERS)}
# the gate: pole Brier under 0.02 and under half the Elo grid's
GATE_ABS, GATE_REL = 0.02, 0.5


def world(seed=0, laps_per=8, noise=0.08):
    """(laps, truth): the synthetic lap archive of tests/test_bayesian.py,
    generated from the model's own story (known effects, so recovery is
    checkable)."""
    rng = np.random.default_rng(seed)
    true_team = rng.normal(0.5, 0.4, len(TEAMS))
    true_driver = rng.normal(0.0, 0.25, len(DRIVERS))
    true_circuit = rng.normal(0.0, 0.15, len(CIRCUITS))
    rows = []
    for c_i, c in enumerate(CIRCUITS):
        for d_i, d in enumerate(DRIVERS):
            mu = true_team[TEAMS.index(TEAM_OF[d])] + true_driver[d_i] + true_circuit[c_i]
            for _ in range(laps_per):
                gap = max(0.0, mu + rng.normal(0.0, noise))
                rows.append(dict(Driver=d, Team=TEAM_OF[d], circuit=c,
                                 LapTime=80.0 * (1.0 + gap / 100.0), session_type="Q"))
    truth = {
        "team": true_team,
        "driver": true_driver,
        "circuit": true_circuit,
        "total": np.array([true_team[TEAMS.index(TEAM_OF[d])] + true_driver[i]
                           for i, d in enumerate(DRIVERS)]),
    }
    return pd.DataFrame(rows), truth


def generated_design(n_rows, sizes, seed):
    """A Bayesian design of `n_rows` rows whose gaps follow the model: team,
    driver and circuit effects of (T, D, C) = `sizes` plus noise, from a
    numpy seed."""
    from monte_carlo_gp_torch.models.bayesian import QualiDesign

    rng = np.random.default_rng(seed)
    t, d, c = sizes
    team, driver, circuit = (rng.integers(0, k, n_rows) for k in sizes)
    y = (rng.normal(1.0, 0.5, t)[team] + rng.normal(0, 0.3, d)[driver]
         + rng.normal(0, 0.2, c)[circuit] + rng.normal(0, 0.1, n_rows))
    return QualiDesign(
        y=y.astype(np.float32), team_idx=team.astype(np.int32),
        driver_idx=driver.astype(np.int32), circuit_idx=circuit.astype(np.int32),
        teams=tuple(f"T{i}" for i in range(t)), drivers=tuple(f"D{i}" for i in range(d)),
        circuits=tuple(f"C{i}" for i in range(c)))


def total_pace(post) -> np.ndarray:
    """Each driver's posterior mean team + driver effect."""
    d = post.design
    return np.array([post.team_effect[:, d.teams.index(TEAM_OF[drv])].mean()
                     + post.driver_effect[:, d.drivers.index(drv)].mean() for drv in DRIVERS])


def alt_quali_pole_briers(cache_dir, models, device, bayes_budget=None) -> dict[str, float]:
    """Walk-forward pole Brier of each qualifying model in `models` over the
    synthetic 2024 season (seed 2718, 20 races, 64 sims a race: the pole
    Brier reads only the qualifying grid)."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.bayesian import BayesianQualiModel
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.validate.backtest import backtest_model

    def factory(quali_model):
        def make():
            p = F1Predictor(cache_dir=cache_dir / quali_model, backend=SyntheticBackend(seed=2718),
                            device=device, quali_model=quali_model)
            if quali_model == "bayesian" and bayes_budget is not None:
                p._bayes_model = BayesianQualiModel(**bayes_budget, device=device)
            return p

        return make

    out = {}
    for m in models:
        res = backtest_model(factory(m), [2024], seed=42, n_simulations=64, verbose=False)
        assert res["n_races"] == 20
        out[m] = res["pole_brier"]
    return out
