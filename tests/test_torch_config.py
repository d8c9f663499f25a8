"""The port's config (`monte_carlo_gp_torch.config`) against the JAX
package's: the static tables, `make_sim_params` validation, and the carrying
of JAX `SimParams` fields into the port."""

import dataclasses

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch import config as tcfg
from monte_carlo_gp_tpu import config as jcfg

torch.set_num_threads(2)

TABLES = [
    "DRIVER_TEAMS", "DEFAULT_DNF_RATES", "TIRE_COMPOUNDS", "COMPOUND_NAMES",
    "COMPOUND_IDS", "CIRCUITS", "PENALTY_TYPES", "TRACK_TYPES", "DEFAULT_CIRCUIT",
    "TRACK_CONDITIONS", "SC_PROBABILITY", "VSC_PROBABILITY",
    "RED_FLAG_PROBABILITY", "DRS_DELTA", "DRY_COMPOUND_MASK", "N_COMPOUNDS",
    "SOFT", "MEDIUM", "HARD", "INTERMEDIATE", "WET", "DRY", "DAMP", "FULL_WET",
]


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_jax_tables(name):
    assert getattr(tcfg, name) == getattr(jcfg, name)


@pytest.mark.parametrize("race", ["Bahrain", "Monaco Grand Prix", "Atlantis"])
def test_circuit_and_penalty_lookups_match(race):
    assert tcfg.circuit_info(race) == jcfg.circuit_info(race)
    assert tcfg.get_similar_tracks("Bahrain") == jcfg.get_similar_tracks("Bahrain")
    for p in ("engine", "gearbox", "unknown", 3):
        assert tcfg.resolve_penalty(p) == jcfg.resolve_penalty(p)


def _good(d=4):
    return dict(
        grid_probs=np.eye(d, dtype=np.float32),
        base_pace=np.full(d, 90.0),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
    )


BAD_INPUTS = {
    "negative_pace": dict(base_pace=np.array([90.0, 90.0, -1.0, 90.0])),
    "negative_deg": dict(tire_deg=np.array([0.05, -0.01, 0.05, 0.05])),
    "nan_deg": dict(tire_deg=np.array([0.05, np.nan, 0.05, 0.05])),
    "rank_key_overflow": dict(base_pace=np.full(4, 1e6)),
    "nan_pace": dict(base_pace=np.array([90.0, np.nan, 90.0, 90.0])),
    "inf_variance": dict(variance=np.array([0.1, np.inf, 0.1, 0.1])),
    "nan_dnf": dict(dnf_rate=np.array([np.nan, 0.0, 0.0, 0.0])),
    "nan_team_dnf": dict(team_dnf_rate=np.array([0.0, 0.0, np.nan, 0.0])),
    "inf_grid": dict(grid_probs=np.full((4, 4), np.inf, np.float32)),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_make_sim_params_raises_the_same_errors(case):
    kw = {**_good(), **BAD_INPUTS[case]}
    with pytest.raises(ValueError) as jax_err:
        jcfg.make_sim_params(**kw)
    with pytest.raises(ValueError) as port_err:
        tcfg.make_sim_params(**kw)
    assert str(port_err.value) == str(jax_err.value)


def _jax_fields(params) -> dict:
    return {f.name: np.asarray(getattr(params, f.name)) for f in dataclasses.fields(params)}


def test_sim_params_from_numpy_of_jax_params_equals_make_sim_params():
    rng = np.random.default_rng(0)
    d = 20
    gp = rng.random((d, d)).astype(np.float32)
    gp /= gp.sum(1, keepdims=True)
    kw = dict(
        grid_probs=gp,
        base_pace=90.0 + rng.random(d),
        tire_deg=rng.uniform(0.01, 0.15, d),
        variance=rng.uniform(0.05, 0.3, d),
        dnf_rate=rng.uniform(0, 0.003, d),
        team_dnf_rate=rng.uniform(0, 0.003, d),
        pit_loss=23.5,
        overtake_delta=0.7,
        track_condition="damp",
        compound_table={
            c: {**v, "pace_delta": v["pace_delta"] + 0.1}
            for c, v in jcfg.TIRE_COMPOUNDS.items()
        },
        active=np.arange(d) < 18,
    )
    carried = tcfg.sim_params_from_numpy(_jax_fields(jcfg.make_sim_params(**kw)))
    own = tcfg.make_sim_params(**kw)
    for f in dataclasses.fields(tcfg.SimParams):
        a, b = getattr(carried, f.name), getattr(own, f.name)
        assert a.dtype == b.dtype, f.name
        assert torch.equal(a, b), f.name
    assert own.n_drivers == d
    assert own.grid_probs.dtype == torch.float32
    assert own.track_condition.dtype == torch.int32 and int(own.track_condition) == 1
    assert own.active.dtype == torch.bool and int(own.active.sum()) == 18
    moved = own.to("cpu")
    assert moved.device == torch.device("cpu") and torch.equal(moved.base_pace, own.base_pace)


def test_sim_params_from_numpy_names_missing_fields():
    fields = _jax_fields(jcfg.make_sim_params(**_good()))
    del fields["pit_loss"]
    with pytest.raises(ValueError, match="pit_loss"):
        tcfg.sim_params_from_numpy(fields)
