"""The port's season launch (`monte_carlo_gp_torch.ops.race_kernel`:
`pack_season_inputs`, `season_counts_plain`, `season_counts`,
`run_monte_carlo_season`) against the JAX package's race-batched Pallas
launch, and its contract with the single-race launch.

On the CPU the port runs `season_counts_plain`, the plain PyTorch version of
the CUDA season kernel; the kernel itself is tested in
tests/test_torch_race_kernel_gpu.py.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.config import make_sim_params, sim_params_from_numpy
from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.ops.philox import ZeroBits
from monte_carlo_gp_tpu.config import make_sim_params as jax_make_sim_params

torch.set_num_threads(2)


def small_fields(d, **overrides):
    """`tests/test_pallas_engine.py::small_params`'s field, as host arrays."""
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 6.0)
    gp = (gp / gp.sum(1, keepdims=True)).astype(np.float32)
    fields = dict(
        grid_probs=gp,
        base_pace=90 + 0.12 * np.arange(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )
    fields.update(overrides)
    return fields


def carried_across(jax_params):
    """The port's SimParams from the JAX package's, field by field."""
    return sim_params_from_numpy(
        {f.name: np.asarray(getattr(jax_params, f.name)) for f in dataclasses.fields(jax_params)}
    )


# With the interpreter's all-zero bits every uniform draw is 0: `small_params`
# as is retires every car on lap 1 (0 < 4 * team DNF rate), so only the
# regime without DNF rates runs the lap loop.
ZERO_BITS_REGIMES = {
    "small_params": {},
    "no_dnf": dict(dnf_rate=np.zeros(8), team_dnf_rate=np.zeros(8)),
}


@pytest.mark.parametrize("regime", sorted(ZERO_BITS_REGIMES))
def test_zero_bits_season_counts_equal_pallas_season_launch(regime):
    from monte_carlo_gp_tpu.ops.pallas_engine import run_monte_carlo_pallas_season

    overrides = ZERO_BITS_REGIMES[regime]
    jplist = [
        jax_make_sim_params(**small_fields(d, **{k: v[:d] for k, v in overrides.items()}))
        for d in (8, 7, 6)
    ]
    laps, n = [12, 10, 9], 256
    want = np.asarray(
        run_monte_carlo_pallas_season(
            jplist, laps, jax.random.PRNGKey(7), n, total_laps=12, sims_per_tile=64
        ),
        np.float64,
    ) * n
    pmat_s, scal_s, grid_log_s, d_max = rk.pack_season_inputs(
        [carried_across(p) for p in jplist]
    )
    assert d_max == 8
    got = rk.season_counts_plain(
        pmat_s, scal_s, grid_log_s, laps, n, seeds=[0, 0, 0], bits=ZeroBits(n)
    ).numpy()
    np.testing.assert_array_equal(got, np.rint(want).astype(np.int64))
    np.testing.assert_allclose(want, np.rint(want), atol=1e-3)


def test_pack_season_inputs_equals_jax_stacked_packing():
    """Padding as `stack_params` pads, packing as the Pallas `_pack_inputs`
    packs (whose scalar pack also carries the lap count, a launch argument
    in the port)."""
    from monte_carlo_gp_tpu.ops.pallas_engine import _pack_inputs
    from monte_carlo_gp_tpu.parallel.sharded import stack_params

    jplist = [jax_make_sim_params(**small_fields(d)) for d in (8, 5)]
    stacked, _ = stack_params(jplist)
    jpmat, jscal, jgrid = jax.vmap(_pack_inputs)(stacked, jax.numpy.asarray([12.0, 9.0]))
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs([carried_across(p) for p in jplist])
    np.testing.assert_array_equal(pmat_s.numpy(), np.asarray(jpmat))
    np.testing.assert_array_equal(scal_s.numpy(), np.asarray(jscal)[:, :-1])
    # XLA's and torch's float32 log may differ in the last bit
    np.testing.assert_allclose(grid_log_s.numpy(), np.asarray(jgrid), rtol=2.4e-7, atol=0)
    assert np.array_equal(grid_log_s.numpy() <= -1e30, np.asarray(jgrid) <= -1e30)


def field(d, seed, **overrides):
    rng = np.random.default_rng(seed)
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0)
    gp = (gp / gp.sum(1, keepdims=True)).astype(np.float32)
    kw = dict(
        grid_probs=gp,
        base_pace=90.0 + 0.06 * np.arange(d) + 0.05 * rng.standard_normal(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.0008),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )
    kw.update(overrides)
    return make_sim_params(**kw)


def test_season_race_equals_single_race_bitwise():
    """Race r of the season is the single-race plain version at
    fold_in(seed, r) on its padded inputs, bit for bit, and its real drivers
    finish in positions 1..d."""
    widths, laps, n, seed = (20, 18, 6), [57, 44, 78], 512, 42 * 1_000_003 + 2024
    plist = [field(d, i, sc_prob=0.05 * i) for i, d in enumerate(widths)]
    probs = rk.run_monte_carlo_season(plist, laps, seed, n)
    assert probs.shape == (3, 20, 20) and probs.dtype == torch.float32
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs(plist)
    for r, d in enumerate(widths):
        single = rk.race_counts_plain(
            pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=philox.fold_in(seed, r)
        )
        torch.testing.assert_close(probs[r] * n, single.float(), rtol=0, atol=0)
        torch.testing.assert_close(probs[r][:d, :d].sum(1), torch.ones(d), rtol=0, atol=1e-6)
        assert float(probs[r][:d, d:].sum()) == 0.0


def test_season_padded_to_40_drivers():
    """A 40-driver race (rank-key tier Q=3, M=64) beside a 20-driver one:
    the narrower field is padded to 40 and still finishes in 1..20."""
    plist = [field(40, 0), field(20, 1)]
    probs = rk.run_monte_carlo_season(plist, [12, 10], 5, 256)
    assert probs.shape == (2, 40, 40)
    torch.testing.assert_close(probs[0].sum(1), torch.ones(40), rtol=0, atol=1e-6)
    torch.testing.assert_close(probs[1][:20, :20].sum(1), torch.ones(20), rtol=0, atol=1e-6)
    torch.testing.assert_close(probs[1][20:, 20:].sum(1), torch.ones(20), rtol=0, atol=1e-6)


def test_season_wrapper_takes_the_plain_version_for_cpu_tensors_without_counting():
    plist = [field(8, 0), field(6, 1)]
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs(plist)
    before = rk.season_counts.launches, rk.race_counts.launches
    got = rk.season_counts(pmat_s, scal_s, grid_log_s, [9, 7], 128, [3, 4])
    want = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, [9, 7], 128, [3, 4])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.dtype == torch.int64 and got.shape == (2, 8, 8)
    assert (rk.season_counts.launches, rk.race_counts.launches) == before


@pytest.mark.parametrize("bad", ["laps_length", "seeds_length", "zero_laps", "too_many_drivers",
                                 "flat_pmat", "negative_seed"])
def test_season_wrapper_rejects_bad_inputs(bad):
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs([field(8, 0), field(6, 1)])
    laps, seeds = [9, 7], [3, 4]
    if bad == "laps_length":
        laps = [9]
    elif bad == "seeds_length":
        seeds = [3, 4, 5]
    elif bad == "zero_laps":
        laps = [9, 0]
    elif bad == "too_many_drivers":
        d = rk.MAX_DRIVERS + 1
        pmat_s = torch.zeros((2, d, rk.N_PCOLS))
        grid_log_s = torch.zeros((2, d, d))
    elif bad == "flat_pmat":
        pmat_s = pmat_s[0]
    elif bad == "negative_seed":
        seeds = [3, -4]
    with pytest.raises(ValueError):
        rk.season_counts(pmat_s, scal_s, grid_log_s, laps, 64, seeds)
