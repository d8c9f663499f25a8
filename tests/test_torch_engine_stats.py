"""Statistical-tolerance tests of the port (the twin of
tests/test_engine_stats.py): the finish distributions of the race kernel's
plain version ("kernel") and of the lap engine ("lap") against the
sequential Python oracle and the native C++ oracle, in the JAX tests'
scenarios, at their simulation counts and under their bounds. All `slow`,
as the JAX tests are.

Held elsewhere, so not repeated here: the two-compound mutation on the
kernel's plain version (`tests/test_torch_native_oracle.py`), which this
file runs on the lap engine; the wide fields on the card (`chip_smoke.py`).
The D = 80 anchor, which the JAX package runs only on a TPU, runs here on
the kernel's plain version (the lap engine's (S, D, D) ranks make it too
slow on a CPU at that width, as the JAX note says of its XLA engine).
"""

import numpy as np
import pytest
import torch
from scipy import stats

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import engine
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.validate.native_oracle import (
    MUT_NO_TWO_COMPOUND_RULE,
    run_native_oracle,
)
from oracle.reference_sim import OracleConfig, run_oracle_monte_carlo
from test_engine_stats import scenario

torch.set_num_threads(2)

ENGINES = ("kernel", "lap")


def run(which, params, seed, n, laps):
    if which == "kernel":
        return rk.run_monte_carlo_kernel(params, seed, n, laps).numpy().astype(np.float64)
    return engine.run_monte_carlo(params, seed, n, laps).numpy().astype(np.float64)


def tv(a, b):
    return 0.5 * np.abs(a - b).sum(axis=1)


def mean_z(ref, n_ref, eng, n_eng):
    positions = np.arange(1, ref.shape[0] + 1)
    mean_r, mean_e = ref @ positions, eng @ positions
    var_r = ref @ positions**2 - mean_r**2
    var_e = eng @ positions**2 - mean_e**2
    se = np.sqrt(var_r / n_ref + var_e / n_eng)
    return (mean_r - mean_e) / np.maximum(se, 1e-6)


def python_oracle(sc, seed, n, cfg):
    return run_oracle_monte_carlo(
        seed=seed, cfg=cfg, n_sims=n,
        grid_probs=sc["grid_probs"], base_pace=sc["base_pace"], tire_deg=sc["tire_deg"],
        variance=sc["variance"], dnf_rate=sc["dnf_rate"], team_dnf_rate=sc["team_dnf_rate"],
    )


@pytest.mark.slow
@pytest.mark.parametrize("which", ENGINES)
def test_finish_distribution_matches_oracle(which):
    d, laps = 10, 30
    sc = scenario(d)
    ocfg = OracleConfig(total_laps=laps, pit_loss=21.0, overtake_delta=0.6,
                        sc_prob=0.01, vsc_prob=0.015, red_prob=0.002)
    n_oracle, n_eng = 6000, 16384
    oracle_probs = python_oracle(sc, 42, n_oracle, ocfg)
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **sc)
    eng = run(which, params, 42, n_eng, laps)
    z = mean_z(oracle_probs, n_oracle, eng, n_eng)
    assert (np.abs(z) < 4.0).all(), z
    assert tv(oracle_probs, eng).max() < 0.04, tv(oracle_probs, eng)
    rho = stats.spearmanr(oracle_probs[:, 0], eng[:, 0]).statistic
    assert rho > 0.8, (oracle_probs[:, 0], eng[:, 0])
    pod_o, pod_e = oracle_probs[:, :3].sum(1), eng[:, :3].sum(1)
    se_pod = np.sqrt(pod_o * (1 - pod_o) / n_oracle + pod_e * (1 - pod_e) / n_eng)
    z_pod = (pod_o - pod_e) / np.maximum(se_pod, 1e-3)
    assert (np.abs(z_pod) < 4.5).all(), z_pod


@pytest.mark.slow
@pytest.mark.parametrize("which", ENGINES)
def test_dnf_rate_matches_oracle(which):
    d, laps = 8, 25
    sc = scenario(d)
    sc["dnf_rate"] = np.full(d, 0.01, np.float32)
    sc["team_dnf_rate"] = np.full(d, 0.01, np.float32)
    oracle_probs = python_oracle(sc, 7, 6000, OracleConfig(total_laps=laps, overtake_delta=0.6))
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **sc)
    eng = run(which, params, 7, 16384, laps)
    assert tv(oracle_probs, eng).max() < 0.04, tv(oracle_probs, eng)


@pytest.mark.slow
def test_native_oracle_matches_python_oracle():
    """The port's binding of the C++ oracle against the Python oracle."""
    d, laps = 10, 30
    sc = scenario(d)
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **sc)
    native = run_native_oracle(params, seed=42, n_sims=160_000, total_laps=laps)
    py = python_oracle(sc, 42, 12_000,
                       OracleConfig(total_laps=laps, pit_loss=21.0, overtake_delta=0.6))
    assert tv(native, py).max() < 0.03, tv(native, py)


@pytest.mark.slow
@pytest.mark.parametrize("which", ENGINES)
def test_engine_matches_native_oracle_high_n(which):
    d, laps = 10, 30
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **scenario(d))
    n_nat, n_eng = 400_000, 65_536
    native = run_native_oracle(params, seed=7, n_sims=n_nat, total_laps=laps)
    eng = run(which, params, 7, n_eng, laps)
    z = mean_z(native, n_nat, eng, n_eng)
    assert (np.abs(z) < 4.0).all(), z
    assert tv(native, eng).max() < 0.012, tv(native, eng)


def wide_scenario(d, seed, pace_step):
    """The JAX D = 40 / D = 80 anchors' field."""
    rng = np.random.default_rng(seed)
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 6.0).astype(np.float32)
    gp /= gp.sum(axis=1, keepdims=True)
    return dict(
        grid_probs=gp,
        base_pace=(90.0 + pace_step * np.arange(d) + 0.05 * rng.standard_normal(d)).astype(np.float32),
        tire_deg=np.clip(0.05 + 0.02 * rng.standard_normal(d), 0.01, 0.15).astype(np.float32),
        variance=np.full(d, 0.15, np.float32),
        dnf_rate=np.full(d, 0.001, np.float32),
        team_dnf_rate=np.full(d, 0.002, np.float32),
    )


@pytest.mark.slow
@pytest.mark.parametrize("which", ENGINES)
def test_engine_matches_native_oracle_d40(which):
    d, laps = 40, 30
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **wide_scenario(d, 5, 0.06))
    n_nat, n_eng = 200_000, 32_768
    native = run_native_oracle(params, seed=7, n_sims=n_nat, total_laps=laps)
    eng = run(which, params, 7, n_eng, laps)
    assert tv(native, eng).max() < 0.025, tv(native, eng)
    assert (np.abs(mean_z(native, n_nat, eng, n_eng)) < 4.5).all()


@pytest.mark.slow
def test_engine_matches_native_oracle_d80():
    """The (R = 3) tier of the race kernel's plain version at D = 80."""
    d, laps = 80, 30
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **wide_scenario(d, 6, 0.05))
    n_nat, n_eng = 100_000, 16_384
    native = run_native_oracle(params, seed=11, n_sims=n_nat, total_laps=laps)
    eng = run("kernel", params, 11, n_eng, laps)
    assert tv(native, eng).max() < 0.04, tv(native, eng)
    assert (np.abs(mean_z(native, n_nat, eng, n_eng)) < 4.5).all()


@pytest.mark.slow
def test_mutation_two_compound_rule_is_detected():
    """On the lap engine (the kernel's plain version holds the same in
    tests/test_torch_native_oracle.py): the oracle with the two-compound
    rule dropped fails the tight bound the real oracle passes."""
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **scenario(10))
    laps = 24
    eng = run("lap", params, 9, 65_536, laps)
    good = run_native_oracle(params, seed=42, n_sims=400_000, total_laps=laps)
    assert tv(good, eng).max() < 0.012, ("the lap engine must pass the tight bound", tv(good, eng))
    mutated = run_native_oracle(params, seed=42, n_sims=400_000, total_laps=laps,
                                mutation=MUT_NO_TWO_COMPOUND_RULE)
    assert tv(mutated, eng).max() > 0.05, ("the dropped rule must blow the tolerance",
                                           tv(mutated, eng))


@pytest.mark.slow
@pytest.mark.parametrize("which", ENGINES)
def test_event_heavy_race_matches_native_oracle(which):
    d, laps = 10, 40
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, sc_prob=0.15, vsc_prob=0.15,
                             red_flag_prob=0.03, **scenario(d, seed=13))
    native = run_native_oracle(params, seed=3, n_sims=200_000, total_laps=laps)
    eng = run(which, params, 3, 16_384, laps)
    assert tv(native, eng).max() < 0.04, tv(native, eng)


@pytest.mark.slow
@pytest.mark.parametrize("which", ENGINES)
def test_wet_race_matches_native_oracle(which):
    d, laps = 10, 35
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, track_condition="damp",
                             **scenario(d, seed=17))
    native = run_native_oracle(params, seed=5, n_sims=200_000, total_laps=laps)
    eng = run(which, params, 5, 16_384, laps)
    assert tv(native, eng).max() < 0.04, tv(native, eng)


@pytest.mark.slow
@pytest.mark.parametrize("which", ENGINES)
def test_exact_default_deg_matches_native_oracle(which):
    """tire_deg exactly 0.05 (the default) must not trip the '> 0.05'
    high-degradation pit adjustment: float32 comparisons everywhere."""
    d, laps = 10, 40
    sc = scenario(d, seed=23)
    sc["tire_deg"] = np.full(d, 0.05, np.float32)
    sc["base_pace"] = (90.0 + 0.08 * np.arange(d)).astype(np.float32)
    gp = np.zeros((d, d), np.float32)
    gp[np.arange(d), d - 1 - np.arange(d)] = 1.0
    sc["grid_probs"] = gp
    params = make_sim_params(pit_loss=21.0, overtake_delta=0.6, **sc)
    native = run_native_oracle(params, seed=11, n_sims=20_000, total_laps=laps)
    eng = run(which, params, 11, 16_384, laps)
    positions = np.arange(1, d + 1)
    diff = np.abs(native @ positions - eng @ positions)
    assert diff.max() < 0.25, (native @ positions, eng @ positions)
