"""The port's rank and permutation primitives (`monte_carlo_gp_torch.ops.ranking`)
against the JAX package's (`monte_carlo_gp_tpu/ops/ranking.py`): the same
inputs, made with numpy from a seed, give exactly the same ranks and
permutations (tolerance: none; ranks are integers and the permutations move
values without arithmetic). The counterpart of tests/test_ranking.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.ops import ranking as tr
from monte_carlo_gp_tpu.ops import ranking as jr

torch.set_num_threads(2)

WIDTHS = [20, 40, 80, 128, 150]


def race_keys(d, seed, n=16):
    """Race-scale times, distinct beyond the widest 2**Q-ULP bucket, in a
    random car order, with 20% of the cars retired."""
    rng = np.random.default_rng(seed)
    x = (4000.0 + np.cumsum(rng.uniform(0.05, 3.0, (n, d)), axis=-1)).astype(np.float32)
    perm = rng.permuted(np.broadcast_to(np.arange(d), (n, d)), axis=-1)
    return np.take_along_axis(x, perm, axis=-1), rng.uniform(size=(n, d)) < 0.2


def tied_keys(d, seed, n=16):
    """Keys with many exact ties (a few distinct values), exact float32 ties
    of race times, and times below the 0.25 s key floor."""
    rng = np.random.default_rng(seed)
    x = rng.choice(np.array([0.0, 0.1, 0.3, 90.5, 91.25, 4000.0], np.float32), (n, d))
    return x.astype(np.float32), rng.uniform(size=(n, d)) < 0.3


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("keys", ["race", "tied"])
def test_rank_by_unique_equals_jax(d, keys):
    """Every packing tier, (2, 32), (3, 64), (4, 128), and the exact
    lexicographic path above 128 rows, with and without DNF flags."""
    x, dnf = (race_keys if keys == "race" else tied_keys)(d, d)
    for flags in (None, dnf):
        want = np.asarray(jr.rank_by_unique(jnp.asarray(x), None if flags is None else jnp.asarray(flags)))
        got = tr.rank_by_unique(torch.from_numpy(x), None if flags is None else torch.from_numpy(flags))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", WIDTHS)
def test_rank_by_equals_jax_with_ties(d):
    x, _ = tied_keys(d, d + 1)
    want = np.asarray(jr.rank_by(jnp.asarray(x)))
    got = tr.rank_by(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tr.rank_by(torch.tensor([[1.0, 0.0, 1.0, 0.0]])).numpy(),
                                  [[2, 0, 3, 1]])


@pytest.mark.parametrize("d", WIDTHS)
def test_permutations_equal_jax(d):
    """scatter_by_rank, gather_at_rank and value_of_car_ahead, on float,
    int and bool values."""
    rng = np.random.default_rng(d + 2)
    x, _ = race_keys(d, d + 3)
    rank_np = np.array(jr.rank_by(jnp.asarray(x)))
    rank_t = torch.from_numpy(rank_np)
    for vals in (
        rng.standard_normal(x.shape).astype(np.float32),
        rng.integers(0, 100, x.shape).astype(np.int32),
        rng.uniform(size=x.shape) < 0.5,
    ):
        sorted_j = np.asarray(jr.scatter_by_rank(jnp.asarray(vals), jnp.asarray(rank_np)))
        sorted_t = tr.scatter_by_rank(torch.from_numpy(vals), rank_t)
        np.testing.assert_array_equal(sorted_t.numpy(), sorted_j)
        back = tr.gather_at_rank(sorted_t, rank_t)
        np.testing.assert_array_equal(back.numpy(), vals)
    vals = rng.standard_normal(x.shape).astype(np.float32)
    want = np.asarray(jr.value_of_car_ahead(jnp.asarray(vals), jnp.asarray(rank_np), fill=-1.0))
    got = tr.value_of_car_ahead(torch.from_numpy(vals), rank_t, fill=-1.0)
    np.testing.assert_array_equal(got.numpy(), want)
