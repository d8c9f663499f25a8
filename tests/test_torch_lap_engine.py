"""Every event-model rule of the port's lap engine
(`monte_carlo_gp_torch.ops.lap_engine`) against the JAX package's
(`monte_carlo_gp_tpu/ops/lap_engine.py`): the 30 per-rule tests of
tests/test_lap_engine.py, driven through `init_cars`/`lap_step`/`classify`
of both packages with the same crafted state, built with numpy.

Where a rule is deterministic (stochastic effects off, as in
`quiet_params`), the two final states must be equal field by field, with no
tolerance: both compute in float32 in the same order. Each case also checks
the rule itself, on both sides. Where a rule is statistical (overtake
success and cap, the VSC refund), the two packages draw from different
streams, so each side must pass the JAX test's own bound.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import lap_engine as tle
from monte_carlo_gp_torch.ops.ranking import gather_at_rank, rank_by_unique, scatter_by_rank
from monte_carlo_gp_tpu.config import make_sim_params as jax_make_sim_params
from monte_carlo_gp_tpu.ops import lap_engine as jle

torch.set_num_threads(2)

KEY = jax.random.PRNGKey(123)
FIELDS = [f.name for f in dataclasses.fields(tle.Cars)]


def quiet_fields(d=4, **overrides):
    """All stochastic effects off: no noise, no events, no DNFs, no
    overtakes, no dirty air, no pit stops (huge optimal stints)."""
    table = {name: dict(info) for name, info in cfg.TIRE_COMPOUNDS.items()}
    for info in table.values():
        info["optimal_laps"] = 10_000
    fields = dict(
        grid_probs=np.eye(d, dtype=np.float32),
        base_pace=np.full(d, 90.0, np.float32),
        tire_deg=np.full(d, 0.05, np.float32),
        variance=np.zeros(d, np.float32),
        dnf_rate=np.zeros(d, np.float32),
        team_dnf_rate=np.zeros(d, np.float32),
        sc_prob=0.0,
        vsc_prob=0.0,
        red_flag_prob=0.0,
        overtake_delta=1e9,
        dirty_air_threshold=0.0,
        pit_loss=21.0,
        compound_table=table,
    )
    fields.update(overrides)
    return fields


def pit_fields(d=3, **kw):
    return quiet_fields(d=d, compound_table=None, **kw)  # real optimal laps


def both_params(fields):
    return jax_make_sim_params(**fields), make_sim_params(**fields)


def fresh_state(jparams, gaps, n=1, **overrides):
    """Car i starts grid slot i with cum_time gaps[i] and one lap done, as
    numpy arrays (the JAX package's init_cars, which the init cases hold
    the port's to)."""
    d = len(gaps)
    cars = jle.init_cars(jparams, jnp.tile(jnp.arange(d, dtype=jnp.int32), (n, 1)))
    state = {f: np.array(getattr(cars, f)) for f in FIELDS}
    state["cum_time"] = np.tile(np.asarray(gaps, np.float32), (n, 1))
    state["laps_done"] = np.ones((n, d), np.int32)
    for k, v in overrides.items():
        state[k] = np.broadcast_to(np.asarray(v, state[k].dtype), (n, d)).copy()
    return state


@functools.partial(jax.jit, static_argnums=(1,))
def _jit_step(params, total_laps, cars, d0, lap):
    cars, drs_until, _rank = jle.lap_step(params, total_laps, cars, d0, lap, KEY)
    return cars, drs_until


def step_both(jparams, tparams, state, lap=10, total_laps=57, drs_until=0, seed=0):
    """One lap from `state` through both packages -> (jax, port) final
    states as dicts of numpy arrays."""
    n, d = state["cum_time"].shape
    jcars = jle.Cars(**{f: jnp.asarray(v) for f, v in state.items()})
    jout, _ = _jit_step(jparams, total_laps, jcars, jnp.full((n,), drs_until, jnp.int32),
                        jnp.int32(lap))
    tcars = tle.Cars(**{f: torch.from_numpy(v.copy()) for f, v in state.items()})
    tout, _, _ = tle.lap_step(
        tparams, total_laps, tcars, torch.full((n,), drs_until, dtype=torch.int32), lap,
        tle.LapDraws(seed, 0, n, d),
    )
    return ({f: np.asarray(getattr(jout, f)) for f in FIELDS},
            {f: getattr(tout, f).numpy() for f in FIELDS})


def assert_states_equal(port, want):
    for f in FIELDS:
        np.testing.assert_array_equal(port[f], want[f], err_msg=f)
        assert port[f].dtype == want[f].dtype, f


# ---------------------------------------------------------------------------
# init_cars (simulation.py:244-273)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cond", ["dry", "wet", "damp"])
def test_init_tires(cond):
    """test_init_dry_tires and test_init_wet_and_damp_tires."""
    jparams, tparams = both_params(quiet_fields(d=12, track_condition=cond))
    want = jle.init_cars(jparams, jnp.arange(12, dtype=jnp.int32)[None, :])
    got = tle.init_cars(tparams, torch.arange(12, dtype=torch.int32)[None, :])
    assert_states_equal({f: getattr(got, f).numpy() for f in FIELDS},
                        {f: np.asarray(getattr(want, f)) for f in FIELDS})
    comp, age = got.compound.numpy()[0], got.tire_age.numpy()[0]
    if cond == "dry":
        assert (comp[:10] == cfg.SOFT).all() and (comp[10:] == cfg.MEDIUM).all()
        assert (age[:10] == 4).all() and (age[10:] == 0).all()
    else:
        assert (comp == (cfg.WET if cond == "wet" else cfg.INTERMEDIATE)).all()
        assert (age == 0).all()
    assert (got.fuel.numpy() == 110.0).all()
    np.testing.assert_array_equal(got.used_mask.numpy()[0], 1 << comp)


# ---------------------------------------------------------------------------
# One deterministic lap: (fields, gaps, state overrides, lap, total laps,
# drs_until, check of the port's first simulation)
# ---------------------------------------------------------------------------


def _lap_times(before, after):
    return after["cum_time"][0] - before["cum_time"][0]


def _check_lap_time_formula(before, out):
    expected = np.array([
        90.0 + 3 * 0.08 * 1.0 - 0.0 + (-0.8),
        90.0 + 5 * 0.05 * 2.0 - 10 * 0.03 + 0.0,
        90.0 + 2 * 0.03 * 1.0 - 15 * 0.03 + 0.6,  # deg=0 -> factor 1.0
        90.0 + 0 - 0.0 + 10.0,
    ])
    np.testing.assert_allclose(_lap_times(before, out), expected, rtol=1e-5)
    np.testing.assert_array_equal(out["tire_age"][0], [4, 6, 3, 1])
    np.testing.assert_allclose(out["fuel"][0], [108.5, 98.5, 93.5, 108.5], rtol=1e-6)
    np.testing.assert_array_equal(out["laps_done"][0], [2, 2, 2, 2])


def _gaps(out):
    cum = out["cum_time"][0]
    return cum - cum[0]


LAP_CASES = {
    "lap_time_formula_exact": (
        quiet_fields(d=4, tire_deg=np.array([0.05, 0.10, 0.0, 0.05], np.float32)),
        [0.0, 10.0, 20.0, 30.0],
        dict(tire_age=[3, 5, 2, 0], fuel=[110.0, 100.0, 95.0, 110.0],
             compound=[cfg.SOFT, cfg.MEDIUM, cfg.HARD, cfg.WET]),
        10, 57, 0, _check_lap_time_formula,
    ),
    "drs_gain_applied": (
        quiet_fields(d=2), [0.0, 30.0], dict(drs=[False, True]), 10, 57, 0,
        # clean lap 89.52 (4-lap-old SOFTs); the DRS car gains drs_delta 0.3
        lambda b, o: np.testing.assert_allclose(_lap_times(b, o), [89.52, 89.22], atol=1e-4),
    ),
    "dirty_air_clamps_to_car_ahead": (
        quiet_fields(d=2, dirty_air_threshold=2.0), [0.0, 1.0], dict(last_lap=[95.0, 90.0]),
        10, 57, 0,
        # car 1: clean 89.52 + 0.5 < 95 -> held to 95; the leader unaffected
        lambda b, o: np.testing.assert_allclose(_lap_times(b, o), [89.52, 95.0], atol=1e-4),
    ),
    "dirty_air_penalty_when_ahead_is_slower_history": (
        quiet_fields(d=2, dirty_air_threshold=2.0), [0.0, 1.0], dict(last_lap=[10.0, 90.0]),
        10, 57, 0,
        lambda b, o: np.testing.assert_allclose(_lap_times(b, o)[1], 89.52 + 0.5, atol=1e-4),
    ),
    "no_dirty_air_outside_threshold": (
        quiet_fields(d=2, dirty_air_threshold=2.0), [0.0, 5.0], dict(last_lap=[95.0, 90.0]),
        10, 57, 0,
        lambda b, o: np.testing.assert_allclose(_lap_times(b, o)[1], 89.52, atol=1e-4),
    ),
    "no_dirty_air_without_history": (
        quiet_fields(d=2, dirty_air_threshold=2.0), [0.0, 1.0], {}, 10, 57, 0,
        lambda b, o: np.testing.assert_allclose(_lap_times(b, o)[1], 89.52, atol=1e-4),
    ),
    "forced_dnf_freezes_car": (
        quiet_fields(d=3, dnf_rate=np.array([0.0, 1.0, 0.0], np.float32)), [0.0, 1.0, 2.0], {},
        7, 57, 0,
        lambda b, o: (
            np.testing.assert_array_equal(o["dnf"][0], [False, True, False]),
            np.testing.assert_array_equal(
                [o["dnf_lap"][0][1], o["cum_time"][0][1], o["laps_done"][0][1]], [7, 1.0, 1]),
        ),
    ),
    # after this lap: age 16 > optimal 15 -> pit; remaining 37 -> HARD
    "pit_triggers_hard": (
        pit_fields(d=3), [0.0, 0.0, 0.0],
        dict(compound=cfg.SOFT, used_mask=1 << cfg.SOFT, tire_age=15), 20, 57, 0,
        lambda b, o: (
            np.testing.assert_array_equal(o["pit_stops"][0], 1),
            np.testing.assert_array_equal(o["compound"][0], cfg.HARD),
            np.testing.assert_array_equal(o["tire_age"][0], 0),
        ),
    ),
    "pit_picks_medium": (  # remaining 27 -> MEDIUM
        pit_fields(d=3), [0.0, 0.0, 0.0],
        dict(compound=cfg.SOFT, used_mask=1 << cfg.SOFT, tire_age=15), 30, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["compound"][0], cfg.MEDIUM),
    ),
    # remaining 12 -> SOFT, but SOFT is the only dry compound used: the
    # two-compound rule switches, and with remaining <= 20 to MEDIUM
    "pit_two_compound_short_stint": (
        pit_fields(d=3), [0.0, 0.0, 0.0],
        dict(compound=cfg.SOFT, used_mask=1 << cfg.SOFT, tire_age=15), 45, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["compound"][0], cfg.MEDIUM),
    ),
    # thresholds int(25*0.85)=21 -> pit; 25 -> no; int(27.5)=27 -> no
    "pit_deg_adjusted_optimal": (
        pit_fields(d=3, tire_deg=np.array([0.10, 0.05, 0.015], np.float32)), [0.0, 0.0, 0.0],
        dict(compound=cfg.MEDIUM, used_mask=1 << cfg.MEDIUM, tire_age=21), 20, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["pit_stops"][0], [1, 0, 0]),
    ),
    "no_pit_when_few_laps_remain": (  # remaining 4 <= 5
        pit_fields(d=1), [0.0], dict(compound=cfg.SOFT, tire_age=30), 53, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["pit_stops"][0], [0]),
    ),
    "pit_boundary_remaining_exactly_six": (
        pit_fields(d=1), [0.0], dict(compound=cfg.SOFT, tire_age=30), 51, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["pit_stops"][0], [1]),
    ),
    "pit_boundary_remaining_five": (
        pit_fields(d=1), [0.0], dict(compound=cfg.SOFT, tire_age=30), 52, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["pit_stops"][0], [0]),
    ),
    # remaining 27 -> MEDIUM, but only MEDIUM used: remaining > 20 -> HARD
    "two_compound_rule_forces_switch": (
        pit_fields(d=1), [0.0], dict(compound=cfg.MEDIUM, used_mask=1 << cfg.MEDIUM, tire_age=26),
        30, 57, 0,
        lambda b, o: np.testing.assert_array_equal(
            [o["compound"][0][0], o["used_mask"][0][0]],
            [cfg.HARD, (1 << cfg.MEDIUM) | (1 << cfg.HARD)]),
    ),
    # bunched to 0.5 s per position, then one identical lap; tire age -1
    # (refund) +1 (the lap): unchanged
    "safety_car_bunches_field": (
        quiet_fields(d=4, sc_prob=1.0), [0.0, 10.0, 20.0, 30.0], {}, 10, 57, 0,
        lambda b, o: (
            np.testing.assert_allclose(np.sort(o["cum_time"][0] - o["cum_time"][0].min()),
                                       [0.0, 0.5, 1.0, 1.5], atol=1e-5),
            np.testing.assert_array_equal(o["tire_age"][0], b["tire_age"][0]),
        ),
    ),
    "sc_keeps_lapped_cars_lapped": (  # car 2 is 2 laps down
        quiet_fields(d=3, sc_prob=1.0), [0.0, 10.0, 200.0], dict(laps_done=[10, 10, 8]),
        12, 57, 0,
        lambda b, o: np.testing.assert_array_less(170.0, _gaps(o)[2]),
    ),
    "red_flag_resets_gaps_and_tires": (  # remaining 47 -> HARD
        quiet_fields(d=3, red_flag_prob=1.0), [0.0, 10.0, 20.0], dict(tire_age=20), 10, 57, 0,
        lambda b, o: (
            np.testing.assert_allclose(_gaps(o), [0.0, 0.1, 0.2], atol=1e-5),
            np.testing.assert_array_equal(o["tire_age"][0], [1, 1, 1]),
            np.testing.assert_array_equal(o["compound"][0], cfg.HARD),
            np.testing.assert_array_equal(o["used_mask"][0] & (1 << cfg.HARD), 1 << cfg.HARD),
        ),
    ),
    "event_priority_red_over_sc": (  # red-flag gaps (0.1), not SC gaps (0.5)
        quiet_fields(d=3, red_flag_prob=1.0, sc_prob=1.0, vsc_prob=1.0), [0.0, 10.0, 20.0], {},
        10, 57, 0,
        lambda b, o: np.testing.assert_allclose(_gaps(o), [0.0, 0.1, 0.2], atol=1e-5),
    ),
    "red_flag_near_race_end_picks_soft": (  # remaining 7 -> SOFT
        quiet_fields(d=2, red_flag_prob=1.0), [0.0, 5.0], {}, 50, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["compound"][0], cfg.SOFT),
    ),
    "drs_awarded_within_window": (  # the leader never; a 0.5 s gap yes
        quiet_fields(d=3), [0.0, 0.5, 5.0], {}, 10, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["drs"][0], [False, True, False]),
    ),
    "drs_disabled_after_sc_until_expiry": (
        quiet_fields(d=2), [0.0, 0.5], {}, 10, 57, 10,
        lambda b, o: np.testing.assert_array_equal(o["drs"][0], [False, False]),
    ),
    "drs_back_after_expiry": (
        quiet_fields(d=2), [0.0, 0.5], {}, 11, 57, 10,
        lambda b, o: np.testing.assert_array_equal(o["drs"][0], [False, True]),
    ),
    "drs_never_on_early_laps": (
        quiet_fields(d=2), [0.0, 0.5], {}, 2, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["drs"][0], [False, False]),
    ),
    "drs_window_is_strict": (  # exactly 1.0 -> no DRS; 0.5 -> DRS
        quiet_fields(d=3), [0.0, 1.0, 1.5], {}, 10, 57, 0,
        lambda b, o: np.testing.assert_array_equal(o["drs"][0], [False, False, True]),
    ),
}


@pytest.mark.parametrize("case", sorted(LAP_CASES))
def test_deterministic_lap_rule(case):
    fields, gaps, overrides, lap, total_laps, drs_until, check = LAP_CASES[case]
    jparams, tparams = both_params(fields)
    before = fresh_state(jparams, gaps, **overrides)
    want, got = step_both(jparams, tparams, before, lap, total_laps, drs_until)
    assert_states_equal(got, want)
    check(before, got)
    check(before, want)


def test_vsc_scales_gaps():
    """Gaps scale by 0.8 under VSC. The 30% tire-age refund is a random
    draw per simulation, so the two packages are held to the rule, not to
    each other."""
    jparams, tparams = both_params(quiet_fields(d=3, vsc_prob=1.0))
    before = fresh_state(jparams, [0.0, 10.0, 20.0])
    for out in step_both(jparams, tparams, before, lap=10):
        np.testing.assert_allclose(_gaps(out), [0.0, 8.0, 16.0], atol=1e-5)


def test_no_overtake_below_delta_threshold():
    """delta 0.5 < 0.6: no car is ever eligible, so no draw matters."""
    fields = quiet_fields(d=2, base_pace=np.array([90.5, 90.0], np.float32), overtake_delta=0.6)
    jparams, tparams = both_params(fields)
    before = fresh_state(jparams, [0.0, 3.0], n=512)
    want, got = step_both(jparams, tparams, before, lap=10)
    assert_states_equal(got, want)
    assert (got["cum_time"][:, 0] < got["cum_time"][:, 1]).all()


# ---------------------------------------------------------------------------
# Classification (simulation.py:230-242)
# ---------------------------------------------------------------------------

CLASSIFY_CASES = {
    # active by time: car2 (75) P1, car0 (100) P2; DNFs by (lap desc, cum
    # desc): car4 (lap 40) P3, then lap 30 by cum desc: car3 (60) P4, car1 P5
    "classification_order": (
        [100.0, 50.0, 75.0, 60.0, 80.0], [False, True, False, True, True], [0, 30, 0, 30, 40],
        [2, 5, 1, 4, 3],
    ),
    # everyone retired: lap 9 ties broken by cum desc, then 5, then 2
    "all_cars_dnf_classification": (
        [10.0, 20.0, 30.0, 40.0], [True] * 4, [5, 9, 9, 2], [3, 2, 1, 4],
    ),
    # exact ties on every key break by driver index
    "ties_break_by_index": (
        [50.0, 50.0, 40.0, 40.0, 40.0, 50.0], [False, False, True, True, False, True],
        [0, 0, 7, 7, 0, 7], [2, 3, 5, 6, 1, 4],
    ),
}


@pytest.mark.parametrize("case", sorted(CLASSIFY_CASES))
def test_classification(case):
    cum, dnf, dnf_lap, expected = CLASSIFY_CASES[case]
    jparams, _ = both_params(quiet_fields(d=len(cum)))
    state = fresh_state(jparams, cum, dnf=dnf, dnf_lap=dnf_lap)
    want = np.asarray(jle.classify(jle.Cars(**{f: jnp.asarray(v) for f, v in state.items()})))
    got = tle.classify(tle.Cars(**{f: torch.from_numpy(v) for f, v in state.items()})).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], expected)
    assert got.dtype == want.dtype


def test_classification_equals_jax_on_random_states():
    """Random states with retirements on shared laps and exact time ties."""
    rng = np.random.default_rng(8)
    n, d = 64, 30
    jparams, _ = both_params(quiet_fields(d=d))
    state = fresh_state(
        jparams, np.zeros(d), n=n,
        dnf=rng.uniform(size=(n, d)) < 0.4, dnf_lap=rng.integers(1, 5, (n, d)),
    )
    state["cum_time"] = rng.choice(np.float32([100.0, 100.5, 101.0, 250.0]), (n, d))
    want = np.asarray(jle.classify(jle.Cars(**{f: jnp.asarray(v) for f, v in state.items()})))
    got = tle.classify(tle.Cars(**{f: torch.from_numpy(v) for f, v in state.items()})).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Statistical rules (simulation.py:496-536, :393): each package on its own
# stream, each held to the JAX test's bound
# ---------------------------------------------------------------------------


def _duel(base_pace, gap, n=4000, **state):
    fields = quiet_fields(d=2, base_pace=np.array(base_pace, np.float32), overtake_delta=0.6)
    jparams, tparams = both_params(fields)
    before = fresh_state(jparams, [0.0, gap], n=n, **state)
    return step_both(jparams, tparams, before, lap=10, seed=17)


def test_overtake_success_rate_and_time_rewrite():
    """The car behind is 1.2 s/lap faster: delta 1.2 > 0.6, prob
    min(0.5, 0.6) = 0.5; a pass leaves the new order 0.3 s apart."""
    for out in _duel([91.2, 90.0], 3.0, compound=cfg.MEDIUM, tire_age=0):
        cum = out["cum_time"]
        swapped = cum[:, 1] < cum[:, 0]
        assert 0.45 < swapped.mean() < 0.55, swapped.mean()
        np.testing.assert_allclose(cum[swapped, 0] - cum[swapped, 1], 0.3, atol=1e-4)


def test_overtake_probability_caps_at_half():
    """delta/2 > 0.5 still succeeds at most 50% (simulation.py:524); a 10 s
    gap cannot close in one lap, so only the overtake step moves cars."""
    for out in _duel([95.0, 90.0], 10.0):
        rate = (out["cum_time"][:, 1] < out["cum_time"][:, 0]).mean()
        assert 0.45 < rate < 0.55, rate


def test_vsc_refund_is_about_30_percent():
    fields = quiet_fields(d=2, vsc_prob=1.0)
    jparams, tparams = both_params(fields)
    before = fresh_state(jparams, [0.0, 10.0], n=4000, tire_age=10)
    for out in step_both(jparams, tparams, before, lap=10, seed=3):
        # refund: age 10 - 1 + 1 = 10; no refund: 11
        refunded = (out["tire_age"][:, 0] == 10).mean()
        assert 0.25 < refunded < 0.35, refunded


def test_overtake_poison_fold_matches_masked_form():
    """The DNF/DRS poison fold in the port's `_overtakes` equals the
    explicit-mask form it stands for, bit for bit, on random states with
    retired cars and DRS holders (the same draws feed both)."""

    def masked_overtakes(params, cars, rng, lap):
        d = cars.cum_time.shape[-1]
        pace = params.base_pace[None, :] + cars.tire_age.to(torch.float32) * params.tire_deg[None, :]
        pass_active = torch.ones(cars.cum_time.shape[:-1], dtype=torch.bool)
        cum = cars.cum_time
        for p in range(tle.OVERTAKE_PASSES):
            rank = rank_by_unique(cum)
            cum_pos = scatter_by_rank(cum, rank)
            pace_pos = scatter_by_rank(pace, rank)
            dnf_pos = scatter_by_rank(cars.dnf, rank)
            drs_pos = scatter_by_rank(cars.drs, rank)
            ahead_pace = torch.cat([pace_pos[..., :1], pace_pos[..., :-1]], -1)
            ahead_dnf = torch.cat([dnf_pos[..., :1], dnf_pos[..., :-1]], -1)
            delta = ahead_pace - pace_pos + torch.where(drs_pos, params.drs_delta, 0.0)
            eligible = ((torch.arange(d) > 0)[None, :] & ~dnf_pos & ~ahead_dnf
                        & (delta > params.overtake_delta))
            prob = (delta / 2.0).clamp_max(0.5)
            u = rng.uniform(lap, tle.STREAM_OVERTAKE + p)
            swap = eligible & (u < prob) & pass_active[..., None]
            cols = list(cum_pos.unbind(-1))
            for i in range(1, d):
                nb = (cols[i - 1] - 0.1).clamp_min(0.1)
                cols[i - 1] = torch.where(swap[..., i], nb + tle.OVERTAKE_RESET_GAP, cols[i - 1])
                cols[i] = torch.where(swap[..., i], nb, cols[i])
            cum = gather_at_rank(torch.stack(cols, -1), rank)
            pass_active = pass_active & swap.any(-1)
        return cum

    d, n = 12, 256
    nprng = np.random.default_rng(11)
    fields = quiet_fields(
        d=d,
        base_pace=(90.0 + 2.0 * nprng.standard_normal(d)).astype(np.float32),
        tire_deg=np.clip(0.05 + 0.02 * nprng.standard_normal(d), 0.01, 0.15),
        overtake_delta=0.4,
    )
    tparams = make_sim_params(**fields)
    cars = tle.init_cars(tparams, torch.arange(d, dtype=torch.int32).repeat(n, 1))
    cars = dataclasses.replace(
        cars,
        cum_time=torch.from_numpy(np.cumsum(nprng.uniform(0.1, 3.0, (n, d)), axis=1).astype(np.float32)),
        tire_age=torch.from_numpy(nprng.integers(0, 30, (n, d)).astype(np.int32)),
        dnf=torch.from_numpy(nprng.uniform(size=(n, d)) < 0.15),
        drs=torch.from_numpy(nprng.uniform(size=(n, d)) < 0.4),
    )
    folded = tle._overtakes(tparams, cars, tle.LapDraws(21, 0, n, d), 10).cum_time
    masked = masked_overtakes(tparams, cars, tle.LapDraws(21, 0, n, d), 10)
    torch.testing.assert_close(folded, masked, rtol=0, atol=0)
    assert not torch.equal(folded, cars.cum_time)  # some passes happened
    assert bool(cars.dnf.any()) and bool(cars.drs.any())
