"""Reproducibility contract of the port (the twin of
tests/test_determinism.py): bitwise-identical results per seed, on the
race kernel's plain version ("kernel") and on the lap engine ("lap"),
invariant to how the simulations are cut into chunks, ranges and shards.

`test_carry_codec_is_bitwise_transparent` has no counterpart: the JAX lap
engine's int8 scan-carry narrowing is not ported (ROADMAP "Do not port").
Its slot holds the plain version's own chunking, which must change nothing
bitwise. The JAX package's block splitting (another key fan-out per block)
becomes the split by first simulation index, which the port's Philox
counter makes exact.
"""

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import engine, philox
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.parallel.mesh import make_mesh, run_monte_carlo_sharded

torch.set_num_threads(2)

ENGINES = ("kernel", "lap")


@pytest.fixture(scope="module")
def std_params():
    """tests/conftest.py::std_setup's 20-driver field, as the port's
    SimParams."""
    d = 20
    rng = np.random.default_rng(7)
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0).astype(np.float32)
    gp /= gp.sum(axis=1, keepdims=True)
    return make_sim_params(
        grid_probs=gp,
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15, np.float32),
        dnf_rate=np.full(d, 0.0008, np.float32),
        team_dnf_rate=np.full(d, 0.002, np.float32),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


def counts(which, params, seed, n, laps, sim_offset=0):
    if which == "kernel":
        return rk.race_counts_plain(*rk.pack_inputs(params), laps, n, seed, sim_offset)
    return engine.engine_counts(params, seed, n, laps, sim_offset)


@pytest.mark.parametrize("which", ENGINES)
def test_same_seed_same_result(which, std_params):
    a = counts(which, std_params, 0, 512, 20)
    b = counts(which, std_params, 0, 512, 20)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(a.sum()) == 512 * 20


@pytest.mark.parametrize("which", ENGINES)
def test_different_seed_different_result(which, std_params):
    a = counts(which, std_params, 0, 512, 20)
    b = counts(which, std_params, 99, 512, 20)
    assert not torch.equal(a, b)


def test_plain_version_chunking_is_bitwise_transparent(std_params):
    """The plain version runs a long range in chunks of 4,096 simulations
    (ops/race_kernel.py, `race_counts_plain`) to bound memory; one chunk of
    the same Philox stream over the whole range gives the same counts bit
    for bit (the twin of the JAX carry-codec test's slot)."""
    pmat, scal, grid_log = rk.pack_inputs(std_params)
    n, laps, seed, d = 10_000, 24, 5, std_params.n_drivers
    chunked = rk.race_counts_plain(pmat, scal, grid_log, laps, n, seed)
    whole = rk.race_counts_plain(
        pmat, scal, grid_log, laps, n, seed,
        bits=philox.PhiloxBits(seed, 0, n, max(d, rk._RACE_CONTROL_ROWS), pmat.device),
    )
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


@pytest.mark.parametrize("which", ENGINES)
def test_split_by_first_simulation_index_changes_nothing(which, std_params):
    """Ranges cut at any first simulation index sum to the whole range bit
    for bit, and each range is itself deterministic; the probabilities are
    a distribution."""
    whole = counts(which, std_params, 3, 512, 20)
    parts = [counts(which, std_params, 3, hi - lo, 20, lo)
             for lo, hi in ((0, 128), (128, 300), (300, 512))]
    torch.testing.assert_close(sum(parts), whole, rtol=0, atol=0)
    torch.testing.assert_close(counts(which, std_params, 3, 172, 20, 128), parts[1], rtol=0, atol=0)
    np.testing.assert_allclose((whole.double() / 512).sum(dim=1).numpy(), 1.0, rtol=1e-12)


def test_sharding_invariance(std_params):
    """The headline contract: the same seed gives bitwise the same
    histogram on one device or split over 8 shards (here 8 CPU shards)."""
    n, laps = 1024, 20
    single = rk.run_monte_carlo_kernel(std_params, 0, n, laps)
    mesh = make_mesh(devices=[torch.device("cpu")] * 8)
    sharded = rk.run_monte_carlo_kernel_sharded(std_params, 0, n, laps, mesh)
    torch.testing.assert_close(single, sharded, rtol=0, atol=0)
    lap_single = engine.run_monte_carlo(std_params, 0, n, laps)
    torch.testing.assert_close(lap_single, run_monte_carlo_sharded(std_params, 0, n, laps, mesh),
                               rtol=0, atol=0)
