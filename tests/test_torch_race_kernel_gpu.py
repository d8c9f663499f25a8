"""The CUDA race kernels (`monte_carlo_gp_torch/csrc/race_kernel.cu`: K1, one
race, and K2, a season in one launch) against their plain PyTorch versions on
the same Philox stream. Every test here needs a CUDA device and skips
without one.

This file imports torch and the port only, so it also runs on a GPU machine
without jax:

    python -m pytest tests/test_torch_race_kernel_gpu.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.config import make_sim_params
from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.ops import race_kernel as rk

# only last-bit differences of log/cos between the kernel and the plain
# version may flip a decision, which moves a handful of simulations: per
# cell at most 4 simulations or 5e-4 of them, whichever is more
MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR = 4, 5e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def field(d, **overrides):
    rng = np.random.default_rng(d)
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0)
    gp = (gp / gp.sum(1, keepdims=True)).astype(np.float32)
    kw = dict(
        grid_probs=gp,
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.0008),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
    )
    kw.update(overrides)
    return kw


CASES = {
    "d20_57laps": (20, 57, 16_384, {}),
    "d5_phantom_lanes": (5, 20, 4_096, {}),
    "d32_full_warp": (32, 30, 4_096, {}),
    "d20_chaos_wet": (20, 30, 8_192, dict(
        track_condition="wet", sc_prob=0.08, vsc_prob=0.10, red_flag_prob=0.01,
    )),
    "d20_padding_slots": (20, 25, 4_096, dict(active=np.arange(20) < 17)),
    "ragged_tail_one_lap": (20, 1, 1_001, {}),
    # the wider rank-key tiers: 2, 3 and 4 cars per lane
    "d40_two_cars_per_lane": (40, 30, 8_192, {}),
    "d80_three_cars_per_lane": (80, 20, 4_096, dict(active=np.arange(80) < 77)),
    "d128_four_cars_per_lane": (128, 12, 2_048, dict(
        track_condition="wet", sc_prob=0.08, vsc_prob=0.10, red_flag_prob=0.01,
    )),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, cuda_device):
    d, laps, n, overrides = CASES[case]
    kw = field(d, **overrides)
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**kw, device=cuda_device))
    before = rk.race_counts.launches
    kernel = rk.race_counts(pmat, scal, grid_log, laps, n, seed=123)
    torch.cuda.synchronize()
    assert rk.race_counts.launches == before + 1
    assert kernel.dtype == torch.int32 and kernel.device.type == "cuda"
    plain = rk.race_counts_plain(pmat, scal, grid_log, laps, n, seed=123)
    diff = (kernel.long() - plain).abs().max().item()
    assert diff <= max(MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR * n)
    assert bool((kernel.sum(1) == n).all()) and bool((kernel.sum(0) == n).all())


@pytest.mark.gpu
def test_kernel_ignores_launch_shape_and_chunking(cuda_device):
    kw = field(20)
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**kw, device=cuda_device))
    a = rk.race_counts(pmat, scal, grid_log, 30, 5000, seed=1, warps_per_block=8)
    b = rk.race_counts(pmat, scal, grid_log, 30, 5000, seed=1, warps_per_block=3)
    c = rk.race_counts(pmat, scal, grid_log, 30, 5000, seed=1, warps_per_block=8)
    first = rk.race_counts(pmat, scal, grid_log, 30, 2500, seed=1)
    second = rk.race_counts(pmat, scal, grid_log, 30, 2500, seed=1, sim_offset=2500)
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(a, first + second)


@pytest.mark.gpu
def test_main_path_launches_the_kernel(cuda_device):
    kw = field(20)
    params = make_sim_params(**kw, device=cuda_device)
    before = rk.race_counts.launches
    probs = rk.run_monte_carlo_kernel(params, 0, 8192, 57)
    assert rk.race_counts.launches == before + 1
    assert probs.device.type == "cuda" and probs.shape == (20, 20)
    torch.testing.assert_close(
        probs.sum(1).cpu(), torch.ones(20), rtol=0, atol=1e-5
    )


@pytest.mark.gpu
@pytest.mark.parametrize("d", [20, 80])
def test_kernel_ignores_launch_shape_wide(d, cuda_device):
    """8, 4 and 3 warps per block, and any grid, give the same counts."""
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**field(d), device=cuda_device))
    runs = [rk.race_counts(pmat, scal, grid_log, 15, 3000, seed=2, warps_per_block=w)
            for w in (8, 4, 3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert torch.equal(runs[0], rk.race_counts(pmat, scal, grid_log, 15, 3000, seed=2))


@pytest.mark.gpu
def test_kernel_rejects_wide_fields(cuda_device):
    kw = field(129)
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**kw, device=cuda_device))
    with pytest.raises(ValueError, match="1..128"):
        rk.race_counts(pmat, scal, grid_log, 10, 64)


# ---- K2, the season kernel ----------------------------------------------------

SEASON_SEED = 2024


def season_inputs(device, widths=(20, 18, 6), **overrides):
    """A ragged season: fields of 20, 18 and 6 drivers (padded to 20), the
    second one wet with frequent race-control events."""
    plist = [
        make_sim_params(**field(d, **(overrides if i == 1 else {})), device=device)
        for i, d in enumerate(widths)
    ]
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs(plist)
    seeds = [philox.fold_in(SEASON_SEED, r) for r in range(len(widths))]
    return pmat_s, scal_s, grid_log_s, seeds


WET_CHAOS = dict(track_condition="wet", sc_prob=0.08, vsc_prob=0.10, red_flag_prob=0.01)


@pytest.mark.gpu
def test_season_kernel_matches_plain_version(cuda_device):
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device, **WET_CHAOS)
    laps, n = [57, 44, 78], 8_192
    before = rk.season_counts.launches, rk.race_counts.launches
    kernel = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    torch.cuda.synchronize()
    assert (rk.season_counts.launches, rk.race_counts.launches) == (before[0] + 1, before[1])
    assert kernel.dtype == torch.int32 and kernel.shape == (3, 20, 20)
    plain = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    diff = (kernel.long() - plain).abs().max().item()
    assert diff <= max(MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR * n)
    for r, d in enumerate((20, 18, 6)):
        real = kernel[r, :d, :d]
        assert bool((real.sum(1) == n).all()), r  # real drivers finish in 1..d
        assert int(kernel[r].sum()) == 20 * n


@pytest.mark.gpu
def test_season_race_equals_single_race_kernel_bitwise(cuda_device):
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device, **WET_CHAOS)
    laps, n = [57, 44, 78], 5_000
    season = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    for r in range(3):
        single = rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=seeds[r])
        assert torch.equal(season[r], single), r


@pytest.mark.gpu
def test_season_kernel_ignores_launch_shape(cuda_device):
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device)
    laps, n = [30, 25, 40], 5_000
    a = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    b = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                         warps_per_block=3, blocks_per_race=7)
    c = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                         warps_per_block=16, blocks_per_race=1)
    assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_season_kernel_rejects_wide_fields(cuda_device):
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device, widths=(20, 129))
    with pytest.raises(ValueError, match="1..128"):
        rk.season_counts(pmat_s, scal_s, grid_log_s, [10, 10], 64, seeds)


@pytest.mark.gpu
def test_wide_season_matches_plain_and_single_races(cuda_device):
    """Fields of 80, 64, 40 and 20 drivers padded to 80 (three cars per
    lane): K2 against its plain version, race r bitwise equal to K1 at
    race r's seed, and two launch shapes bitwise equal."""
    widths, laps, n = (80, 64, 40, 20), [20, 15, 25, 12], 2_048
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device, widths=widths)
    kernel = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    plain = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    assert (kernel.long() - plain).abs().max().item() <= max(MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR * n)
    for r, w in enumerate(widths):
        assert bool((kernel[r, :w, :w].sum(1) == n).all()), r
        single = rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=seeds[r])
        assert torch.equal(kernel[r], single), r
    shaped = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                              warps_per_block=3, blocks_per_race=11)
    assert torch.equal(kernel, shaped)
