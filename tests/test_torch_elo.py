"""The port's Elo (`monte_carlo_gp_torch.models.elo`, float32 torch on the
CPU) against the JAX package's `lax.scan` version. Sums over opponents run
in another order, so ratings agree to rtol=1e-5, not bitwise."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import elo as telo
from monte_carlo_gp_tpu.models import elo as jelo

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
