"""The port's grid sampler (`monte_carlo_gp_torch.ops.grid_sampling`): the
without-replacement categorical of the reference (simulation.py:102-145), as
tests/test_grid_sampling.py holds the JAX package's. The two draw from
different random streams, so the statistical checks run the same bound on
each side: a chi-square p-value above 1e-4, or the JAX test's absolute
bound on a frequency.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from monte_carlo_gp_torch.ops.grid_sampling import sample_grid
from monte_carlo_gp_torch.ops.lap_engine import STREAM_GRID, LapDraws
from monte_carlo_gp_tpu.ops.grid_sampling import sample_grid as jax_sample_grid

torch.set_num_threads(2)


def port_grid(gp, n, seed=0, active=None):
    d = gp.shape[0]
    rng = LapDraws(seed, 0, n, d)
    return sample_grid(
        lambda slot: rng.uniform(slot, STREAM_GRID), torch.from_numpy(gp), n,
        None if active is None else torch.from_numpy(active),
    ).numpy()


def jax_grid(gp, n, seed=0, active=None):
    return np.asarray(jax_sample_grid(
        jax.random.PRNGKey(seed), jnp.asarray(gp), n,
        None if active is None else jnp.asarray(active),
    ))


SIDES = {"port": port_grid, "jax": jax_grid}


@pytest.mark.parametrize("side", sorted(SIDES))
@pytest.mark.parametrize("d", [20, 150])
def test_grids_are_permutations(side, d):
    gp = np.random.default_rng(0).random((d, d)).astype(np.float32)
    pos = SIDES[side](gp, 64, seed=1)
    assert pos.shape == (64, d) and pos.dtype == np.int32
    assert (np.sort(pos, axis=1) == np.arange(d)).all()


def test_deterministic_grid_equals_jax():
    """A one-hot probability matrix yields exactly that grid every time, on
    both sides."""
    d = 8
    perm = np.array([3, 1, 0, 2, 7, 6, 5, 4])
    gp = np.zeros((d, d), np.float32)
    gp[np.arange(d), perm] = 1.0
    got = port_grid(gp, 32)
    np.testing.assert_array_equal(got, np.tile(perm, (32, 1)))
    np.testing.assert_array_equal(got, jax_grid(gp, 32))


def test_inactive_drivers_get_the_sentinel():
    d = 10
    gp = np.random.default_rng(5).random((d, d)).astype(np.float32)
    active = np.ones(d, bool)
    active[[2, 7]] = False
    for side in SIDES.values():
        pos = side(gp, 128, seed=2, active=active)
        assert (pos[:, [2, 7]] == d).all()
        assert (np.sort(pos[:, active], axis=1) == np.arange(d - 2)).all()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_first_slot_marginal_matches_probs(side):
    """The slot-0 pick is an exact categorical over column 0."""
    d = 6
    col0 = np.array([0.4, 0.25, 0.15, 0.1, 0.07, 0.03])
    gp = np.full((d, d), 1.0 / d, np.float32)
    gp[:, 0] = col0
    n = 20000
    pos = SIDES[side](gp, n, seed=2)
    counts = np.bincount(np.argmin(pos, axis=1), minlength=d)
    assert stats.chisquare(counts, col0 * n).pvalue > 1e-4, (counts / n, col0)


@pytest.mark.parametrize("side", sorted(SIDES))
def test_uniform_fallback_on_zero_column(side):
    """When remaining drivers all have zero probability in a column, the
    sampler falls back to uniform over remaining (simulation.py:125-130)."""
    d = 4
    gp = np.zeros((d, d), np.float32)
    gp[0, 0] = 1.0  # driver 0 always on pole; all later columns are zero
    n = 8000
    pos = SIDES[side](gp, n, seed=3)
    assert (pos[:, 0] == 0).all()
    for slot in range(1, d):
        counts = np.bincount(np.argmax(pos == slot, axis=1), minlength=d)[1:]
        assert stats.chisquare(counts, np.full(3, n / 3)).pvalue > 1e-4, counts


@pytest.mark.parametrize("side", sorted(SIDES))
def test_without_replacement_renormalization(side):
    """Two-driver duel for slot 0; the loser must take slot 1."""
    gp = np.array([[0.7, 0.5, 0.0], [0.3, 0.5, 0.0], [0.0, 0.0, 1.0]], np.float32)
    pos = SIDES[side](gp, 20000, seed=4)
    assert (pos[:, 2] == 2).all()
    assert abs((pos[:, 0] == 0).mean() - 0.7) < 0.02
