"""The port's split over several devices (`monte_carlo_gp_torch.parallel` and
the sharded entries of `ops.race_kernel`), after tests/test_sharding.py: a
split run must be bitwise the run on one device, for any shard count and any
split, on the race kernel and on the lap engine; season batches must match
per-race runs.

Here every shard of a mesh is the CPU (a mesh may name one device several
times), so the race kernel runs its plain version; the CUDA shards are held
in tests/test_torch_race_kernel_gpu.py. Against the JAX package, on its
conftest's 8-device virtual mesh: the port's sharded plain version fed
all-zero bits equals `run_monte_carlo_pallas_sharded` under the Pallas
interpreter exactly, and the port's sharded lap engine is within a stated
total variation of JAX's `sharded_monte_carlo` (another bit source).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import engine, philox
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.ops.philox import ZeroBits
from monte_carlo_gp_torch.parallel import make_mesh, sharded_monte_carlo, simulate_season_sharded, stack_params
from monte_carlo_gp_torch.parallel.mesh import local_shards, run_monte_carlo_sharded, shard_range
from monte_carlo_gp_tpu.config import make_sim_params as jax_make_sim_params
from test_torch_race_kernel import stress_fields, zero_bits_fields

torch.set_num_threads(2)

SHARD_COUNTS = [1, 2, 3, 5, 8]


def cpu_mesh(n_shards, axis_sizes=None):
    return make_mesh(axis_sizes, devices=["cpu"] * n_shards)


@pytest.fixture(scope="module")
def std_params():
    """The JAX conftest's `std_setup` field."""
    return make_sim_params(**stress_fields())


def test_make_mesh_shapes():
    mesh = cpu_mesh(8)
    assert mesh.shape == {"sims": 8} and mesh.size == 8
    mesh2 = make_mesh({"race": 2, "sims": 4}, devices=["cpu"] * 8)
    assert mesh2.shape == {"race": 2, "sims": 4} and mesh2.size == 8
    with pytest.raises(ValueError):
        make_mesh({"sims": 99}, devices=["cpu"] * 8)
    # the default: every visible CUDA device, or the CPU alone
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert make_mesh().shape == {"sims": max(1, n_cuda)}


def test_shard_ranges_cover_every_simulation_once():
    for n, w in ((1001, 8), (7, 3), (3, 5), (1_048_576, 4)):
        ranges = [shard_range(n, w, i) for i in range(w)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert max(hi - lo for lo, hi in ranges) - min(hi - lo for lo, hi in ranges) <= 1
    assert [(lo, hi) for _, lo, hi in local_shards(cpu_mesh(3), 10, torch.device("cpu"))] == [
        (0, 3), (3, 6), (6, 10)]
    with pytest.raises(ValueError):
        shard_range(10, 2, 2)


def test_sharded_matches_single_device(std_params):
    single = engine.run_monte_carlo(std_params, 0, 1024, 15)
    sharded = sharded_monte_carlo(std_params, 0, 1024, 15, mesh=cpu_mesh(8))
    torch.testing.assert_close(sharded, single, rtol=0, atol=0)


def test_sharded_rejects_uneven_split(std_params):
    with pytest.raises(ValueError, match="divide evenly"):
        sharded_monte_carlo(std_params, 0, 1001, 15, mesh=cpu_mesh(8))
    # the weekend's route splits any count, bitwise the unsplit run
    single = engine.run_monte_carlo(std_params, 0, 1001, 15)
    split = run_monte_carlo_sharded(std_params, 0, 1001, 15, mesh=cpu_mesh(8))
    torch.testing.assert_close(split, single, rtol=0, atol=0)


CUDA_MESH = ["cuda:0", "cuda:0"]


@pytest.mark.parametrize("entry", ["race_counts_sharded", "season_counts_sharded",
                                   "run_monte_carlo_sharded", "simulate_season_sharded"])
def test_split_refuses_shards_of_another_device_type(entry, std_params):
    """A mesh naming CUDA devices for CPU inputs raises before any shard
    runs, on every sharded entry: a split runs where its inputs lie (the
    converse, CUDA inputs on a CPU mesh, is held on the card in
    tests/test_torch_race_kernel_gpu.py)."""
    mesh = make_mesh(devices=CUDA_MESH)
    pmat, scal, grid_log = rk.pack_inputs(std_params)
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs([std_params])
    run = {
        "race_counts_sharded": lambda: rk.race_counts_sharded(
            pmat, scal, grid_log, 10, 100, mesh=mesh),
        "season_counts_sharded": lambda: rk.season_counts_sharded(
            pmat_s, scal_s, grid_log_s, [10], 100, [1], mesh=mesh),
        "run_monte_carlo_sharded": lambda: run_monte_carlo_sharded(std_params, 0, 100, 10, mesh),
        "simulate_season_sharded": lambda: simulate_season_sharded([std_params], [10], 0, 100, mesh),
    }[entry]
    with pytest.raises(ValueError, match="every shard must be a device of the inputs' type"):
        run()
    with pytest.raises(ValueError, match="mesh has shards on cpu"):
        local_shards(cpu_mesh(2), 100, torch.device("cuda", 0))


def test_season_sharded_matches_per_race(std_params):
    laps, seed = [12, 17], 21
    probs = simulate_season_sharded(
        [std_params, std_params], laps, seed, n_sims=512, mesh=make_mesh(
            {"race": 2, "sims": 4}, devices=["cpu"] * 8),
    )
    assert probs.shape == (2, 20, 20)
    for r, lap_count in enumerate(laps):
        solo = engine.run_monte_carlo(std_params, philox.fold_in(seed, r), 512, lap_count)
        torch.testing.assert_close(probs[r], solo, rtol=0, atol=0)


def test_stack_params_pads_drivers(std_params):
    small = dataclasses.replace(
        std_params,
        grid_probs=std_params.grid_probs[:16, :16],
        **{f: getattr(std_params, f)[:16] for f in
           ("base_pace", "tire_deg", "variance", "dnf_rate", "team_dnf_rate", "active")},
    )
    stacked, d = stack_params([std_params, small])
    assert d == 20
    assert stacked.base_pace.shape == (2, 20) and stacked.grid_probs.shape == (2, 20, 20)
    assert not bool(stacked.active[1, 16])
    # the padded race still simulates: real drivers take positions 1..16,
    # padded slots always classify last (positions 17-20)
    probs = simulate_season_sharded(
        [std_params, small], [10, 10], 0, n_sims=256, mesh=make_mesh(
            {"race": 2, "sims": 4}, devices=["cpu"] * 8),
    ).numpy()
    np.testing.assert_allclose(probs[1, 16:, 16:].sum(axis=-1), 1.0, atol=1e-5)
    assert probs[1, :16, 16:].sum() == 0.0


# -- the sharded race kernel ---------------------------------------------------------


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_sharded_kernel_equals_one_launch(shards, std_params):
    """1,001 simulations (no shard count divides them) split over 1-8
    shards give one launch's probabilities bit for bit."""
    single = rk.run_monte_carlo_kernel(std_params, 3, 1001, 12)
    before = rk.race_counts_sharded.launches
    split = rk.run_monte_carlo_kernel_sharded(std_params, 3, 1001, 12, mesh=cpu_mesh(shards))
    torch.testing.assert_close(split, single, rtol=0, atol=0)
    # CPU shards run the plain version: no kernel launch is counted
    assert rk.race_counts_sharded.launches == before


@pytest.mark.parametrize("shards", SHARD_COUNTS)
def test_sharded_season_equals_one_launch(shards):
    """A ragged season (20, 18 and 6 drivers, padded to 20) of 333
    simulations per race split over 1-8 shards: bitwise the one launch."""
    rng_fields = [stress_fields(20), stress_fields(18), stress_fields(6)]
    plist = [make_sim_params(**f) for f in rng_fields]
    laps, seed = [15, 12, 9], 99
    single = rk.run_monte_carlo_season(plist, laps, seed, 333)
    split = rk.run_monte_carlo_season(plist, laps, seed, 333, mesh=cpu_mesh(shards))
    torch.testing.assert_close(split, single, rtol=0, atol=0)


def test_season_counts_plain_takes_a_simulation_offset():
    """A season's counts at simulation offset N are the slice [N, 2N) of
    every race's stream: the two halves sum to the whole, and race r at the
    offset is the single-race plain version at the same offset."""
    plist = [make_sim_params(**stress_fields(8)), make_sim_params(**stress_fields(6))]
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs(plist)
    laps, seeds, n = [10, 7], [5, 6], 200
    whole = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, 2 * n, seeds)
    first = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    second = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds, sim_offset=n)
    torch.testing.assert_close(whole, first + second, rtol=0, atol=0)
    assert not torch.equal(first, second)
    for r in range(2):
        single = rk.race_counts_plain(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seeds[r],
                                      sim_offset=n)
        torch.testing.assert_close(second[r], single, rtol=0, atol=0)
    # the wrapper takes the offset to the plain version for CPU tensors
    got = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds, sim_offset=n)
    torch.testing.assert_close(got, second, rtol=0, atol=0)
    with pytest.raises(ValueError):
        rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds, sim_offset=2**32 - 1)


# -- against the JAX package -------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_zero_bits_sharded_equals_pallas_sharded(n_dev, monkeypatch):
    """The port's sharded entry over n_dev CPU shards, its plain version
    fed all-zero bits, equals the JAX package's shard_map'd Pallas launch
    over n_dev virtual devices under the interpreter (all-zero PRNG)
    exactly: 10 tiles of 128 simulations, not divisible by 4 or 8 devices,
    so the JAX side pads the tile grid and zeroes the pad tiles."""
    from monte_carlo_gp_tpu.ops.pallas_engine import run_monte_carlo_pallas_sharded
    from monte_carlo_gp_tpu.parallel.mesh import make_mesh as jax_make_mesh

    d, laps, n = 8, 12, 1280
    fields = zero_bits_fields(d, vsc_prob=0.2)
    mesh = jax_make_mesh({"sims": n_dev}, devices=jax.devices()[:n_dev])
    want = np.asarray(
        run_monte_carlo_pallas_sharded(
            jax_make_sim_params(**fields), jax.random.PRNGKey(0), n, laps, mesh=mesh,
            sims_per_tile=128,
        ),
        np.float64,
    )
    monkeypatch.setattr(philox, "PhiloxBits",
                        lambda seed, sim_offset, n_sims, rows, device: ZeroBits(n_sims, device))
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**fields))
    got = rk.race_counts_sharded(pmat, scal, grid_log, laps, n, seed=0, mesh=cpu_mesh(n_dev))
    np.testing.assert_array_equal(got.numpy(), np.rint(want * n).astype(np.int64))
    np.testing.assert_allclose(want * n, np.rint(want * n), atol=1e-3)
    # the zero-bits race is not the grid order: the overtakes ran
    assert not np.array_equal(np.argmax(got.numpy(), axis=1), np.arange(d))


def test_sharded_lap_engine_matches_jax_sharded_monte_carlo():
    """The port's lap engine split over 8 CPU shards against the JAX
    package's `sharded_monte_carlo` on its 8 virtual devices: 16,384
    simulations a side, 20 drivers, 20 laps, per-driver total variation
    below 0.07, the bound the JAX package holds its engines to at this size
    (Monte Carlo floor ~0.04): Philox against threefry, so in distribution."""
    from monte_carlo_gp_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from monte_carlo_gp_tpu.parallel.mesh import sharded_monte_carlo as jax_sharded_monte_carlo

    n, laps = 16_384, 20
    want = np.asarray(jax_sharded_monte_carlo(
        jax_make_sim_params(**stress_fields()), jax.random.PRNGKey(6), n, laps,
        mesh=jax_make_mesh({"sims": 8}),
    ))
    got = sharded_monte_carlo(make_sim_params(**stress_fields()), 5, n, laps, mesh=cpu_mesh(8))
    got = got.numpy()
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)
    tv = 0.5 * np.abs(got - want).sum(axis=1)
    assert tv.max() < 0.07, tv
