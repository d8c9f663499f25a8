"""The port's race kernel (`monte_carlo_gp_torch.ops.race_kernel`) against
the JAX package.

On the CPU the port runs `race_counts_plain`, the plain PyTorch version of
the CUDA kernel. It is held
  * exactly against the Pallas kernel body, run by the Pallas TPU
    interpreter, whose PRNG returns all-zero bits: fed all-zero bits too, the
    plain version must give the same (D, D) counts in every race regime;
  * in distribution against the JAX XLA engine and the native C++ oracle,
    each on its own random stream.
The CUDA kernel itself is tested in tests/test_torch_race_kernel_gpu.py.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import race_kernel as rk
from monte_carlo_gp_torch.ops.philox import ZeroBits
from monte_carlo_gp_torch.utils.profiling import RECORDER
from monte_carlo_gp_tpu.config import make_sim_params as jax_make_sim_params

torch.set_num_threads(2)


def _gauss_grid(d, width):
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / width)
    gp = gp.astype(np.float32)
    return gp / gp.sum(1, keepdims=True)


def zero_bits_fields(d, **overrides):
    """Fast cars start at the back (base pace falls with the grid index),
    degradation spans both pit-window branches, and no event can happen
    unless a regime turns it on."""
    fields = dict(
        grid_probs=_gauss_grid(d, 6.0),
        base_pace=90.0 + 0.12 * np.arange(d)[::-1],
        tire_deg=np.linspace(0.015, 0.12, d),
        variance=np.full(d, 0.15),
        dnf_rate=np.zeros(d),
        team_dnf_rate=np.zeros(d),
        pit_loss=21.0,
        overtake_delta=0.3,
        sc_prob=0.0,
        vsc_prob=0.0,
        red_flag_prob=0.0,
    )
    fields.update(overrides)
    return fields


def _sparse(d, where, value):
    a = np.zeros(d)
    a[list(where)] = value
    return a


# With all-zero bits every uniform draw is 0: any event with a positive
# probability happens on every lap (for every car it applies to).
ZERO_BITS_REGIMES = {
    "green": {},
    "sc_every_lap": dict(sc_prob=1.0),
    "vsc_every_lap": dict(vsc_prob=1.0),
    "red_every_lap": dict(red_flag_prob=0.5),
    "per_lap_dnf": dict(dnf_rate=_sparse(8, (1, 4), 0.01)),
    "lap1_team_dnf": dict(team_dnf_rate=_sparse(8, (2, 6), 0.005)),
    "damp": dict(track_condition="damp"),
    "wet": dict(track_condition="wet"),
}

# (d, total_laps, race_laps): one Pallas compile serves every D=8 regime
ZERO_BITS_SHAPE_D8 = (8, 32, 24)
ZERO_BITS_SHAPE_D20 = (20, 24, 20)


def _pallas_zero_bits_counts(fields, total_laps, race_laps, n=128):
    from monte_carlo_gp_tpu.ops.pallas_engine import run_monte_carlo_pallas

    with pltpu.force_tpu_interpret_mode():
        probs = run_monte_carlo_pallas(
            jax_make_sim_params(**fields), jax.random.PRNGKey(0), n, total_laps,
            sims_per_tile=n, race_laps=jnp.int32(race_laps),
        )
    return np.rint(np.asarray(probs, np.float64) * n).astype(np.int64)


def _plain_zero_bits_counts(fields, race_laps, n=128):
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**fields))
    return rk.race_counts_plain(
        pmat, scal, grid_log, race_laps, n, bits=ZeroBits(n)
    ).numpy()


@pytest.mark.parametrize("regime", sorted(ZERO_BITS_REGIMES))
def test_zero_bits_counts_equal_pallas_body(regime):
    d, total_laps, race_laps = ZERO_BITS_SHAPE_D8
    fields = zero_bits_fields(d, **ZERO_BITS_REGIMES[regime])
    want = _pallas_zero_bits_counts(fields, total_laps, race_laps)
    got = _plain_zero_bits_counts(fields, race_laps)
    np.testing.assert_array_equal(got, want)


def test_zero_bits_counts_equal_pallas_body_d20_with_padding_slots():
    """20 slots, two of them inactive (padding), a shorter race than the
    Pallas compile bucket, and overtakes reshuffling the order."""
    d, total_laps, race_laps = ZERO_BITS_SHAPE_D20
    active = np.ones(d, bool)
    active[[7, 15]] = False
    fields = zero_bits_fields(d, active=active, vsc_prob=0.2)
    want = _pallas_zero_bits_counts(fields, total_laps, race_laps)
    got = _plain_zero_bits_counts(fields, race_laps)
    np.testing.assert_array_equal(got, want)
    # the padding slots finish last, and the race is not the grid order
    assert set(np.argmax(got, axis=1)[[7, 15]]) == {18, 19}
    assert not np.array_equal(np.argmax(got, axis=1), np.arange(d))


@pytest.mark.parametrize(
    "d",
    [40, pytest.param(80, marks=pytest.mark.slow)],  # D = 80: ~65 s of interpreter on a CPU
)
def test_zero_bits_counts_equal_pallas_body_wide_tiers(d):
    """The rank-key tiers of wider fields, (Q, M) = (3, 64) at D = 40 and
    (4, 128) at D = 80: two padding slots, a shorter race than the Pallas
    compile bucket, and overtakes reshuffling the order, as at D = 20."""
    total_laps, race_laps = ZERO_BITS_SHAPE_D20[1:]
    active = np.ones(d, bool)
    active[[7, d - 5]] = False
    fields = zero_bits_fields(d, active=active, vsc_prob=0.2)
    want = _pallas_zero_bits_counts(fields, total_laps, race_laps)
    got = _plain_zero_bits_counts(fields, race_laps)
    np.testing.assert_array_equal(got, want)
    assert set(np.argmax(got, axis=1)[[7, d - 5]]) == {d - 2, d - 1}
    assert not np.array_equal(np.argmax(got, axis=1), np.arange(d))


def stress_fields(d=20):
    rng = np.random.default_rng(3)
    return dict(
        grid_probs=_gauss_grid(d, 8.0),
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.0008),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )


XLA_REGIMES = {
    "nominal": {},
    "full_wet": dict(track_condition="wet", variance=np.full(20, 0.4)),
    "event_chaos": dict(
        track_condition="damp", sc_prob=0.08, vsc_prob=0.10, red_flag_prob=0.01
    ),
}


@pytest.mark.parametrize("regime", sorted(XLA_REGIMES))
def test_distribution_matches_xla_engine(regime):
    """16,384 sims per side, 20 laps (long enough for the first pit
    stops): per-driver total variation below 0.07, the bound the JAX
    package holds its Pallas kernel to against the XLA engine (Monte Carlo
    noise floor ~0.04 at this size)."""
    from monte_carlo_gp_tpu.ops.engine import run_monte_carlo

    fields = {**stress_fields(), **XLA_REGIMES[regime]}
    n, laps = 16_384, 20
    xla = np.asarray(
        run_monte_carlo(jax_make_sim_params(**fields), jax.random.PRNGKey(6), n, laps)
    )
    port = rk.run_monte_carlo_kernel(make_sim_params(**fields), 5, n, laps).numpy()
    np.testing.assert_allclose(port.sum(axis=1), 1.0, atol=1e-5)
    tv = 0.5 * np.abs(port - xla).sum(axis=1)
    assert tv.max() < 0.07, tv


def test_distribution_matches_native_oracle():
    """32,768 sims per side, 20 drivers, 30 laps: per-driver total
    variation below 0.05, about 3x the Monte Carlo noise."""
    from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle

    params = make_sim_params(**stress_fields())
    n, laps = 32_768, 30
    port = rk.run_monte_carlo_kernel(params, 11, n, laps).numpy()
    native = run_native_oracle(params, seed=42, n_sims=n, total_laps=laps)
    tv = 0.5 * np.abs(port - native).sum(axis=1)
    assert tv.max() < 0.05, tv


def test_chunks_sum_to_the_whole():
    """Counts of 2N sims equal the sum of the two N-sim chunks at sim
    offsets 0 and N: the Philox counter is the global simulation index."""
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**stress_fields()))
    n = 384
    whole = rk.race_counts_plain(pmat, scal, grid_log, 20, 2 * n, seed=9)
    first = rk.race_counts_plain(pmat, scal, grid_log, 20, n, seed=9)
    second = rk.race_counts_plain(pmat, scal, grid_log, 20, n, seed=9, sim_offset=n)
    torch.testing.assert_close(whole, first + second, rtol=0, atol=0)
    assert not torch.equal(first, second)
    assert int(whole.sum()) == 2 * n * 20


def test_wrapper_takes_the_plain_version_for_cpu_tensors_without_counting():
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**stress_fields()))
    before = rk.race_counts.launches
    got = rk.race_counts(pmat, scal, grid_log, 12, 256, seed=4)
    want = rk.race_counts_plain(pmat, scal, grid_log, 12, 256, seed=4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert rk.race_counts.launches == before


def test_plain_path_counts_no_packed_launch():
    """The CPU wrappers run the plain version at D = 20, where a card takes
    the packed instance: neither counts `race.packed`."""
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**stress_fields()))
    before = RECORDER.counters.get("race.packed", 0)
    rk.race_counts(pmat, scal, grid_log, 6, 32, seed=4)
    pair = lambda t: torch.stack([t, t])
    rk.season_counts(pair(pmat), pair(scal), pair(grid_log), [6, 5], 32, [1, 2])
    assert RECORDER.counters.get("race.packed", 0) == before


@pytest.mark.parametrize("d, tier", [
    (1, (2, 3)), (2, (2, 3)), (10, (2, 3)), (19, (2, 3)), (20, (2, 3)),
    (21, (1, 1)), (32, (1, 1)), (33, (2, 1)), (64, (2, 1)), (65, (3, 1)), (96, (3, 1)),
    (97, (4, 1)), (128, (4, 1)),
])
def test_kernel_tier_is_chosen_from_the_width(d, tier):
    """(cars per lane, simulations per warp): the packed instance at 1-20
    drivers, one simulation a warp of ceil(d / 32) cars a lane above, as
    `csrc/race_kernel.cu` dispatches."""
    assert rk.kernel_tier(d) == tier


class _Library:
    """The two instance queries of a race-kernel library, packing fields of
    up to `packed` drivers."""

    def __init__(self, packed):
        self.packed = packed

    def mcgp_cars_per_lane(self, d):
        return 2 if d <= self.packed else -(-d // 32)

    def mcgp_sims_per_warp(self, d):
        return 3 if d <= self.packed else 1


@pytest.mark.parametrize("packed, agrees", [(20, True), (19, False), (21, False), (0, False)])
def test_a_library_of_another_instance_is_refused(packed, agrees):
    """The wrapper loads the library only where it runs every width on the
    instance `kernel_tier` gives."""
    if agrees:
        rk.check_instances(_Library(packed))
    else:
        with pytest.raises(RuntimeError, match="another instance"):
            rk.check_instances(_Library(packed))


def test_a_library_from_before_the_packed_instance_runs_one_simulation_a_warp():
    """A library that reports no instance (an older source, timed against
    the current one) is launched as it was: ceil(d / 32) cars a lane, one
    simulation a warp, at every width."""
    assert [rk.library_tier(object(), d) for d in (1, 20, 21, 33, 128)] == [
        (1, 1), (1, 1), (1, 1), (2, 1), (4, 1)]
    assert rk.library_tier(_Library(20), 20) == rk.kernel_tier(20) == (2, 3)


@pytest.mark.parametrize("d, n_sims, warps_per_block, most, blocks", [
    (20, 1, 8, 1056, 1), (20, 24, 8, 1056, 1), (20, 25, 8, 1056, 2),
    (20, 3 * 8 * 5, 8, 1056, 5), (20, 3 * 8 * 5 + 1, 8, 1056, 6),
    (20, 2, 1, 1056, 1), (20, 4, 1, 1056, 2), (20, 10_000, 3, 7, 7),
    (20, 1 << 20, 8, 1056, 1056), (20, 1 << 20, 8, 10**9, 43_691),
    (21, 8, 8, 1056, 1), (21, 9, 8, 1056, 2), (21, 1 << 20, 8, 10**9, 131_072),
])
def test_grid_blocks_count_warps_of_the_tier(d, n_sims, warps_per_block, most, blocks):
    """The launches' blocks: ceil(n_sims / 3) warps at 1-20 drivers, n_sims
    above, in blocks of `warps_per_block`, at most `most`."""
    sims_per_warp = rk.kernel_tier(d)[1]
    assert rk.grid_blocks(n_sims, sims_per_warp, warps_per_block, most) == blocks


@pytest.mark.parametrize(
    "bad",
    ["float64_pmat", "noncontiguous_grid", "wrong_scal", "too_many_drivers", "zero_laps"],
)
def test_wrapper_rejects_bad_inputs(bad):
    d = 20
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**stress_fields(d)))
    laps = 12
    if bad == "float64_pmat":
        pmat = pmat.double()
    elif bad == "noncontiguous_grid":
        grid_log = grid_log.t()
    elif bad == "wrong_scal":
        scal = scal[:-1]
    elif bad == "too_many_drivers":
        d = rk.MAX_DRIVERS + 1
        pmat = torch.zeros((d, rk.N_PCOLS))
        grid_log = torch.zeros((d, d))
    elif bad == "zero_laps":
        laps = 0
    with pytest.raises(ValueError):
        rk.race_counts(pmat, scal, grid_log, laps, 64)


def test_plain_version_keeps_the_wide_field_tiers():
    """D = 40 (rank-key tier Q=3, M=64) runs in the plain version and
    every slot lands somewhere every race."""
    d = 40
    fields = zero_bits_fields(d)
    fields["grid_probs"] = _gauss_grid(d, 8.0)
    probs = rk.run_monte_carlo_kernel(make_sim_params(**fields), 3, 256, 10).numpy()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)
    np.testing.assert_allclose(probs.sum(axis=0), 1.0, atol=1e-6)


# ---- the overtake pass: what the CUDA kernel may skip ---------------------------

PLAN_FIXTURE = Path(__file__).resolve().parent / "data" / "torch_plan_bahrain2024.npz"


def _pass_inputs(d, n=256, seed=0):
    """(cum, pace, att, u, key_of, tenth) of n simulations of d cars: times a
    few seconds apart, paces that differ by up to 4 s (so live passes swap
    often), a few retired cars (NaN pace) and DRS on some cars."""
    from monte_carlo_gp_torch.ops.ranking import rank_key, rank_tier

    rng = np.random.default_rng(seed)
    cum = torch.from_numpy((5_000.0 + rng.uniform(0.0, 3.0 * d, (n, d))).astype(np.float32))
    pace = torch.from_numpy(rng.uniform(88.0, 92.0, (n, d)).astype(np.float32))
    pace[torch.from_numpy(rng.uniform(size=(n, d)) < 0.05)] = float("nan")
    att = pace - torch.from_numpy(np.where(rng.uniform(size=(n, d)) < 0.2, 0.3, 0.0).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(n, d)).astype(np.float32))
    row = torch.arange(d, dtype=torch.int32)[None, :]
    q_shift, row_mult = rank_tier(d)
    return cum, pace, att, u, (lambda c: rank_key(c, row, q_shift, row_mult)), row.float() * 0.1


@pytest.fixture(scope="module")
def live_pass_shares():
    """The share of simulation-laps in which passes 1, 2 and 3 are live, from
    the plain version on the Bahrain 2024 plan (20 drivers, 57 laps, 1,024
    simulations, seed 0): a pass is live when the one before it swapped."""
    from monte_carlo_gp_torch.config import sim_params_from_numpy

    with np.load(PLAN_FIXTURE) as f:
        fields = {k: f[k] for k in f.files}
    pmat, scal, grid_log = rk.pack_inputs(sim_params_from_numpy(fields))
    active = []
    real = rk._overtake_pass

    def spy(cum, pace, att, u, pass_active, *args):
        active.append(pass_active.float().mean().item())
        return real(cum, pace, att, u, pass_active, *args)

    rk._overtake_pass = spy
    try:
        rk.race_counts_plain(pmat, scal, grid_log, int(fields["total_laps"]), 1_024, seed=0)
    finally:
        rk._overtake_pass = real
    assert len(active) == 3 * (int(fields["total_laps"]) - 1)
    return [float(np.mean(active[k::3])) for k in range(3)]


@pytest.mark.parametrize("d", [20, 40, 80])
def test_dead_overtake_pass_leaves_times_unchanged(d, live_pass_shares):
    """A pass whose simulations are all dead (pass_active False) gives every
    car its own time back, bit for bit, and swaps nothing: the CUDA kernel
    takes only a dead pass's draw. Live, the same inputs do swap. Dead
    passes are common: on the Bahrain plan passes 2 and 3 are live in a
    share of laps below 1."""
    cum, pace, att, u, key_of, tenth = _pass_inputs(d)
    n = cum.shape[0]
    dead = torch.zeros((n, 1), dtype=torch.bool)
    out, swapped = rk._overtake_pass(cum, pace, att, u, dead, key_of, tenth, 0.6)
    assert torch.equal(out.view(torch.int32), cum.view(torch.int32))
    assert not bool(swapped.any())
    live, swapped = rk._overtake_pass(cum, pace, att, u, ~dead, key_of, tenth, 0.6)
    assert float(swapped.float().mean()) > 0.5 and not torch.equal(live, cum)

    first, second, third = live_pass_shares
    assert first == 1.0
    assert 0.0 < third <= second < 1.0


@pytest.mark.parametrize("d", [20, 40, 80])
def test_swap_free_overtake_pass_leaves_times_unchanged(d):
    """A live pass in which no car swaps (every draw at or above the swap
    probability, which is at most 0.5) also gives every car its own time
    back bit for bit: the CUDA kernel stops such a pass after its ballot."""
    cum, pace, att, _, key_of, tenth = _pass_inputs(d, seed=1)
    n = cum.shape[0]
    u = torch.full_like(cum, 0.5)
    live = torch.ones((n, 1), dtype=torch.bool)
    out, swapped = rk._overtake_pass(cum, pace, att, u, live, key_of, tenth, 0.6)
    assert not bool(swapped.any())
    assert torch.equal(out.view(torch.int32), cum.view(torch.int32))
