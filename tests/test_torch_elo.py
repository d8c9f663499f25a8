"""The port's Elo (`monte_carlo_gp_torch.models.elo`, float32 torch on the
CPU) against the JAX package's `lax.scan` version. Sums over opponents run
in another order, so ratings agree to rtol=1e-5, not bitwise. The rules of
tests/test_elo.py hold against the sequential oracle
(tests/oracle/reference_elo.py) at that file's tolerances."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import elo as telo
from monte_carlo_gp_tpu.models import elo as jelo
from oracle.reference_elo import OracleElo

torch.set_num_threads(2)


def _random_events(seed, n_drivers=14, n_events=60):
    rng = np.random.default_rng(seed)
    ratings = (1500.0 + 120.0 * rng.standard_normal((n_drivers, 2))).astype(np.float32)
    # integer-valued outcomes half the time, so ties (actual score 0.5) occur
    values = rng.uniform(80.0, 95.0, (n_events, n_drivers)).astype(np.float32)
    values[::2] = np.round(values[::2])
    masks = rng.random((n_events, n_drivers)) < 0.7
    masks[5] = False  # an empty event is a no-op
    masks[6] = False
    masks[6, 3] = True  # so is a one-driver event
    ks = rng.uniform(16.0, 48.0, n_events).astype(np.float32)
    discs = rng.integers(0, 2, n_events).astype(np.int32)
    return ratings, values, masks, ks, discs


@pytest.mark.parametrize("seed", [0, 1])
def test_scan_update_matches_jax(seed):
    ratings, values, masks, ks, discs = _random_events(seed)
    want = np.asarray(
        jelo.scan_update(
            jnp.asarray(ratings), jnp.asarray(values), jnp.asarray(masks),
            jnp.asarray(ks), jnp.asarray(discs),
        )
    )
    got = telo.scan_update(
        torch.from_numpy(ratings), torch.from_numpy(values), torch.from_numpy(masks),
        torch.from_numpy(ks), torch.from_numpy(discs.astype(np.int64)),
    ).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert not np.allclose(got, ratings)


def test_event_update_leaves_small_events_alone():
    r = torch.tensor([1500.0, 1600.0, 1400.0])
    mask = torch.tensor([False, True, False])
    assert torch.equal(telo.event_update(r, torch.zeros(3), mask, 32.0), r)


def _feed_synthetic_seasons(system, loader, season=2024):
    """The predictor's Elo build order over (season-1, season)."""
    for hist in (season - 1, season):
        years_ago = season - hist
        data = loader.load_season_data(hist)
        total = len(data["qualifying"])
        for key, update in (
            ("qualifying", system.update_quali_ratings),
            ("sprint_qualifying", system.update_quali_ratings),
            ("races", system.update_race_ratings),
            ("sprints", system.update_race_ratings),
        ):
            for idx, ev in enumerate(data.get(key, [])):
                system.set_recency_weight(years_ago, idx, total)
                update(ev)


def test_elo_system_on_synthetic_seasons_matches_jax(tmp_path):
    from monte_carlo_gp_tpu.data.loader import F1DataLoader
    from monte_carlo_gp_tpu.data.synthetic import SyntheticBackend

    loader = F1DataLoader(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718))
    jsys, tsys = jelo.F1EloSystem(), telo.F1EloSystem()
    _feed_synthetic_seasons(jsys, loader)
    _feed_synthetic_seasons(tsys, loader)
    assert tsys.names == jsys.names and len(tsys.names) >= 20
    jstate, tstate = jsys.state_dict(), tsys.state_dict()
    np.testing.assert_allclose(tstate["ratings"], jstate["ratings"], rtol=1e-5)
    drivers = tsys.names[:20]
    jp, tp = jsys.predict_quali_probs(drivers), tsys.predict_quali_probs(drivers)
    np.testing.assert_allclose(
        [tp[d] for d in drivers], [jp[d] for d in drivers], rtol=1e-4, atol=1e-7
    )
    for d in drivers[:3]:
        assert tsys.get_rating(d, "race") == pytest.approx(jsys.get_rating(d, "race"), rel=1e-5)
    restored = telo.F1EloSystem.from_state_dict(tstate)
    assert restored.names == tsys.names
    np.testing.assert_array_equal(restored.state_dict()["ratings"], tstate["ratings"])


def test_rookie_priors_match_jax():
    jsys, tsys = jelo.F1EloSystem(), telo.F1EloSystem()
    for s in (jsys, tsys):
        s.update_quali_ratings([("VER", 89.1), ("LAW", 89.5), ("NOR", 89.3)])
    teams = {"VER": "Red Bull", "LAW": "Red Bull", "NOR": "McLaren", "NEW": "Red Bull", "X": None}
    rookies = {"NEW": "Red Bull", "X": None}
    got = tsys.initialize_rookies(rookies, teams)
    want = jsys.initialize_rookies(rookies, teams)
    assert got.keys() == want.keys()
    for d in got:
        assert got[d] == pytest.approx(want[d], rel=1e-6)
    assert tsys.has_rating("NEW") and not tsys.has_rating("X")


# -- the rules of tests/test_elo.py, against the sequential oracle ----------------


def _random_history(seed=0, n_events=30, n_drivers=12):
    rng = np.random.default_rng(seed)
    names = [f"D{i:02d}" for i in range(n_drivers)]
    events = []
    for e in range(n_events):
        k = rng.integers(4, n_drivers + 1)
        drivers = rng.choice(names, size=k, replace=False)
        if e % 2 == 0:  # quali: lap times
            vals = 88.0 + rng.random(k) * 3.0
            events.append(("quali", list(zip(drivers.tolist(), vals.tolist()))))
        else:  # race: positions
            pos = rng.permutation(k) + 1
            events.append(("race", list(zip(drivers.tolist(), pos.tolist()))))
    return events


def test_matches_oracle_on_random_history():
    events = _random_history()
    oracle, system = OracleElo(), telo.F1EloSystem()
    for i, (kind, results) in enumerate(events):
        oracle.set_recency_weight(i % 3, race_index=i, total_races=len(events))
        system.set_recency_weight(i % 3, race_index=i, total_races=len(events))
        if kind == "quali":
            oracle.update_quali(results)
            system.update_quali_ratings(results)
        else:
            oracle.update_race(results)
            system.update_race_ratings(results)
    for name in oracle.ratings:
        assert abs(system.get_rating(name, "quali") - oracle.ratings[name]["quali"]) < 2e-2
        assert abs(system.get_rating(name, "race") - oracle.ratings[name]["race"]) < 2e-2


def test_tie_handling():
    system, oracle = telo.F1EloSystem(), OracleElo()
    results = [("A", 90.0), ("B", 90.0), ("C", 91.0)]
    system.update_quali_ratings(results)
    oracle.update_quali(results)
    for d in "ABC":
        assert abs(system.get_rating(d) - oracle.ratings[d]["quali"]) < 1e-3
    assert abs(system.get_rating("A") - system.get_rating("B")) < 1e-4  # tied


def test_single_driver_event_is_noop():
    system = telo.F1EloSystem()
    system.update_quali_ratings([("A", 90.0)])
    assert system.get_rating("A") == 1500.0


def test_unknown_driver_default():
    system = telo.F1EloSystem()
    assert system.get_rating("ZZZ") == 1500.0
    assert system.get_rating("ZZZ", "race") == 1500.0


def test_ordered_list_form_equals_position_pairs():
    a, b = telo.F1EloSystem(), telo.F1EloSystem()
    a.update_race_ratings(["X", "Y", "Z"])
    b.update_race_ratings([("X", 1), ("Y", 2), ("Z", 3)])
    for d in "XYZ":
        assert abs(a.get_rating(d, "race") - b.get_rating(d, "race")) < 1e-4


def test_softmax_probs_match_oracle():
    system, oracle = telo.F1EloSystem(), OracleElo()
    results = [("A", 1.0), ("B", 2.0), ("C", 3.0), ("D", 4.0)]
    system.update_quali_ratings(results)
    oracle.update_quali(results)
    p_sys = system.predict_quali_probs(["A", "B", "C", "D", "E"])
    p_or = oracle.predict_quali_probs(["A", "B", "C", "D", "E"])
    assert abs(sum(p_sys.values()) - 1.0) < 1e-5
    for d in p_or:
        assert abs(p_sys[d] - p_or[d]) < 1e-4
    assert p_sys["A"] > p_sys["B"] > p_sys["C"] > p_sys["D"]


def test_recency_k_schedule():
    assert telo.recency_k(32, 0, 0, 24) == 32 * 0.75
    assert telo.recency_k(32, 0, 23, 24) == 32 * 1.5
    assert telo.recency_k(32, 1) == 32.0
    assert telo.recency_k(32, 2) == 32 * 0.7
    assert telo.recency_k(32, 3) == 32 * 0.5
    assert telo.recency_k(32, 10) == 32 * 0.5


def test_state_dict_roundtrip():
    system = telo.F1EloSystem()
    system.update_race_ratings([("A", 1), ("B", 2)])
    restored = telo.F1EloSystem.from_state_dict(system.state_dict())
    assert restored.get_rating("A", "race") == system.get_rating("A", "race")
    assert restored.names == system.names
