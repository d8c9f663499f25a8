"""The CUDA race kernels (`monte_carlo_gp_torch/csrc/race_kernel.cu`: K1, one
race, and K2, a season in one launch) against their plain PyTorch versions on
the same Philox stream, against the golden counts of
`tests/data/torch_kernel_golden.npz` bit for bit, and their sharded launches
against one launch. Every test here needs a CUDA device and skips without one.

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
from monte_carlo_gp_torch.parallel.mesh import make_mesh
from monte_carlo_gp_torch.utils.profiling import RECORDER
from monte_carlo_gp_torch.validate import golden

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


# ---- the packed instance: three simulations a warp, fields of up to 20 ----------


def _packed_launches():
    return RECORDER.counters.get("race.packed", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 2, 4, 3 * 1_000 + 1])
@pytest.mark.parametrize("d", [1, 2, 7, 10, 11, 19, 20])
def test_packed_instance_matches_plain_version(d, n, cuda_device):
    """K1 at every width of the packed instance and at simulation counts
    that fill a warp's three segments partly: every simulation counted
    once; at 1, 2 and 4 simulations the plain version's counts exactly (a
    cell holds at most 4, so the kernel bound would pass anything) and the
    whole launch bitwise its simulations launched one at a time (segments 1
    and 2 of a warp against segment 0 of their own); at 3,001 the plain
    version's counts within the kernel bound."""
    assert rk.kernel_tier(d) == (2, 3)
    kw = field(d, **(WET_CHAOS if d in (7, 19) else {}))
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**kw, device=cuda_device))
    laps = 15
    before = _packed_launches()
    kernel = rk.race_counts(pmat, scal, grid_log, laps, n, seed=77)
    torch.cuda.synchronize()
    assert _packed_launches() == before + 1
    plain = rk.race_counts_plain(pmat, scal, grid_log, laps, n, seed=77)
    assert bool((kernel.sum(1) == n).all()) and bool((kernel.sum(0) == n).all())
    if n > 4:
        assert (kernel.long() - plain).abs().max().item() <= max(MAX_ABS_COUNT_ERR,
                                                                 MAX_ABS_PROB_ERR * n)
    else:
        assert torch.equal(kernel.long().cpu(), plain.cpu())
        alone = sum(rk.race_counts(pmat, scal, grid_log, laps, 1, seed=77, sim_offset=i)
                    for i in range(n))
        assert torch.equal(kernel, alone)


@pytest.mark.gpu
def test_packed_season_race_equals_single_race_kernel_bitwise(cuda_device):
    """K2's race r equals K1 at race r's seed bit for bit at D = 20, with a
    simulation count that leaves the last warp's third segment empty, and
    counts its races as packed."""
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device, **WET_CHAOS)
    laps, n = [57, 44, 78], 5_002
    before = _packed_launches()
    season = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    torch.cuda.synchronize()
    assert _packed_launches() == before + 3
    for r in range(3):
        single = rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=seeds[r])
        assert torch.equal(season[r], single), r


@pytest.mark.gpu
def test_packed_instance_ignores_launch_shape(cuda_device):
    """Warps per block, blocks and blocks per race do not move the packed
    instance's counts, at a simulation count that is not a multiple of 3."""
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**field(20), device=cuda_device))
    n = 4_001
    runs = [rk.race_counts(pmat, scal, grid_log, 20, n, seed=3, warps_per_block=w, n_blocks=b)
            for w, b in ((None, None), (8, None), (3, 7), (1, 1), (16, 2), (12, None))]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device)
    laps = [20, 15, 25]
    seasons = [rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds, warps_per_block=w,
                                blocks_per_race=b)
               for w, b in ((None, None), (3, 7), (16, 1), (1, 5))]
    assert all(torch.equal(seasons[0], r) for r in seasons[1:])


@pytest.mark.gpu
def test_the_library_runs_the_instance_kernel_tier_gives(cuda_device):
    rk.build()
    rk.check_instances(rk._lib)
    assert [rk._lib.mcgp_sims_per_warp(d) for d in (1, 20, 21, 32, 128)] == [3, 3, 1, 1, 1]


@pytest.mark.gpu
def test_twenty_one_drivers_take_the_wide_instance(cuda_device):
    """D = 21 runs `race_kernel<1>`, one simulation a warp, as before the
    packed instance: no packed launch is counted, and its counts match the
    plain version and do not depend on the launch shape."""
    assert rk.kernel_tier(21) == (1, 1)
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**field(21), device=cuda_device))
    n = 8_192
    before = _packed_launches()
    kernel = rk.race_counts(pmat, scal, grid_log, 30, n, seed=123)
    torch.cuda.synchronize()
    assert _packed_launches() == before
    plain = rk.race_counts_plain(pmat, scal, grid_log, 30, n, seed=123)
    assert (kernel.long() - plain).abs().max().item() <= max(MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR * n)
    assert bool((kernel.sum(1) == n).all()) and bool((kernel.sum(0) == n).all())
    shaped = rk.race_counts(pmat, scal, grid_log, 30, n, seed=123, warps_per_block=3, n_blocks=5)
    assert torch.equal(kernel, shaped)


def _kernel_counters() -> dict:
    return {k: RECORDER.counters.get(k, 0) for k in ("race.cars", "race.slots", "race.packed")}


@pytest.mark.gpu
def test_kernel_matches_plain_version_on_the_2026_grid_at_a_million_sims(cuda_device, tmp_path):
    """K1 at the shape of the cell `serve.elo.2026.1m`: the synthetic world's
    2026 Abu Dhabi fp2 plan (the entry list's 22 cars, 58 laps) at 1,048,576
    simulations on `race_kernel<1>`, one simulation a warp, against its plain
    version; the launch counts its cars and slots, 22 of every 32. Prints
    K1's time."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    n = 1 << 20
    plan = F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718),
                       device="cpu").prepare_weekend(2026, "Abu Dhabi", prediction_point="fp2")
    d, laps = len(plan.drivers), plan.total_laps
    assert (d, laps, rk.kernel_tier(d)) == (22, 58, (1, 1))
    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(cuda_device))
    rk.race_counts(pmat, scal, grid_log, laps, 1_024, seed=11)  # the library's load
    before = _kernel_counters()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    kernel = rk.race_counts(pmat, scal, grid_log, laps, n, seed=11)
    end.record()
    torch.cuda.synchronize()
    after = _kernel_counters()
    assert {k: after[k] - before[k] for k in after} == {
        "race.cars": 22 * n, "race.slots": 32 * n, "race.packed": 0}
    plain = rk.race_counts_plain(pmat, scal, grid_log, laps, n, seed=11)
    diff = (kernel.long() - plain).abs()
    print(f"K1, 2026 Abu Dhabi fp2, {d} drivers x {laps} laps x {n} sims: "
          f"{start.elapsed_time(end):.3f} ms; max |count - plain| {diff.max().item()} in "
          f"{int((diff > 0).sum())} of {diff.numel()} cells")
    assert diff.max().item() <= max(MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR * n)
    assert bool((kernel.sum(1) == n).all()) and bool((kernel.sum(0) == n).all())


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


def _check_wide_season(widths, laps, n, device, **overrides):
    """K2 on fields of `widths` drivers padded to the widest: against its
    plain version, race r bitwise equal to K1 at race r's seed, and two
    launch shapes bitwise equal."""
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(device, widths=widths, **overrides)
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


@pytest.mark.gpu
def test_wide_season_matches_plain_and_single_races(cuda_device):
    """Fields of 80, 64, 40 and 20 drivers padded to 80 (three cars per
    lane)."""
    _check_wide_season((80, 64, 40, 20), [20, 15, 25, 12], 2_048, cuda_device)


@pytest.mark.gpu
def test_season_of_up_to_32_drivers_matches_plain_and_single_races(cuda_device):
    """Fields of 32, 26, 21 and 24 drivers padded to 32: `season_kernel<1>`,
    one car a lane and one simulation a warp, the only instance that no
    field of 20 or of more than 32 drivers runs; the second race wet, with
    frequent race-control events."""
    assert rk.kernel_tier(32) == (1, 1)
    _check_wide_season((32, 26, 21, 24), [30, 44, 25, 12], 3_001, cuda_device, **WET_CHAOS)


@pytest.mark.gpu
def test_a_season_launch_counts_its_races_own_fields(cuda_device):
    """`run_monte_carlo_season` on fields of 32, 26, 24 and 21 drivers padded
    to 32: `race.cars` counts each race's own cars, `race.slots` the 32
    lanes of every simulation's warp."""
    widths, n = (32, 26, 24, 21), 3_001
    params = [make_sim_params(**field(d), device=cuda_device) for d in widths]
    before = _kernel_counters()
    rk.run_monte_carlo_season(params, [30, 44, 25, 12], SEASON_SEED, n)
    after = _kernel_counters()
    assert {k: after[k] - before[k] for k in after} == {
        "race.cars": n * sum(widths), "race.slots": len(widths) * n * 32, "race.packed": 0}


@pytest.mark.gpu
def test_season_kernel_matches_plain_version_at_a_million_sims(cuda_device):
    """K2 at the sweep's size, 20 races x 1,048,576 simulations in one
    launch (the synthetic 2024 season of the golden file, race r at
    `fold_in(42 * 1_000_003 + 2024, r)`), against its plain version; every
    real row finishes each simulation once. Prints the launch's time."""
    n = 1 << 20
    _, (pmat_s, scal_s, grid_log_s, laps, seeds) = golden.case_inputs(
        "k2_season2024", cuda_device, golden.synthetic_season(cuda_device))
    rk.season_counts(pmat_s, scal_s, grid_log_s, laps, 1_024, seeds)  # the library's load
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    kernel = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    end.record()
    torch.cuda.synchronize()
    plain = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    diff = (kernel.long() - plain).abs()
    print(f"K2, {len(laps)} races x {n} sims: {start.elapsed_time(end):.3f} ms; "
          f"max |count - plain| {diff.max().item()} in {int((diff > 0).sum())} of "
          f"{diff.numel()} cells")
    assert diff.max().item() <= max(MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR * n)
    assert bool((kernel.sum(2) == n).all()) and bool((kernel.sum(1) == n).all())


# ---- the sharded launches: shards on one card --------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [1, 2, 3, 5])
def test_sharded_kernel_equals_one_launch(shards, cuda_device):
    """K1 once per shard, each for its own range of 5,001 simulations (not
    a multiple of the shard count): bitwise one launch's int32 counts."""
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**field(20), device=cuda_device))
    one = rk.race_counts(pmat, scal, grid_log, 30, 5_001, seed=4)
    before = rk.race_counts_sharded.launches, rk.race_counts.launches
    split = rk.race_counts_sharded(pmat, scal, grid_log, 30, 5_001, seed=4,
                                   mesh=make_mesh(devices=[cuda_device] * shards))
    torch.cuda.synchronize()
    assert (rk.race_counts_sharded.launches, rk.race_counts.launches) == (
        before[0] + 1, before[1] + shards)
    assert split.dtype == torch.int32 and split.device.type == "cuda"
    assert torch.equal(split, one)


@pytest.mark.gpu
def test_season_kernel_takes_a_simulation_offset(cuda_device):
    """Race r of K2 at a simulation offset is K1 at race r's seed and the
    same range, and the plain version's counts within the kernel bound."""
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device, **WET_CHAOS)
    laps, n, offset = [20, 15, 25], 3_000, 7_777
    season = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds, sim_offset=offset)
    plain = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds, sim_offset=offset)
    assert (season.long() - plain).abs().max().item() <= max(MAX_ABS_COUNT_ERR, MAX_ABS_PROB_ERR * n)
    for r in range(3):
        single = rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=seeds[r],
                                sim_offset=offset)
        assert torch.equal(season[r], single), r
    assert not torch.equal(season, rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds))


@pytest.mark.gpu
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_season_equals_one_launch(shards, cuda_device):
    """K2 once per shard, each shard its own range of every race: bitwise
    one season launch, on a ragged season padded to 80 drivers."""
    widths, laps, n = (80, 64, 40, 20), [20, 15, 25, 12], 2_001
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device, widths=widths)
    one = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    before = rk.season_counts_sharded.launches, rk.season_counts.launches
    split = rk.season_counts_sharded(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                                     mesh=make_mesh(devices=[cuda_device] * shards))
    torch.cuda.synchronize()
    assert (rk.season_counts_sharded.launches, rk.season_counts.launches) == (
        before[0] + 1, before[1] + shards)
    assert torch.equal(split, one)


@pytest.mark.gpu
def test_sharded_entries_refuse_a_cpu_mesh_for_cuda_inputs(cuda_device):
    """CUDA inputs on a mesh with a CPU shard raise: the split never moves
    the kernel's work off the card."""
    pmat, scal, grid_log = rk.pack_inputs(make_sim_params(**field(20), device=cuda_device))
    mixed = make_mesh(devices=[cuda_device, "cpu"])
    with pytest.raises(ValueError, match="every shard must be a device of the inputs' type"):
        rk.race_counts_sharded(pmat, scal, grid_log, 10, 1_000, mesh=mixed)
    pmat_s, scal_s, grid_log_s, seeds = season_inputs(cuda_device)
    with pytest.raises(ValueError, match="every shard must be a device of the inputs' type"):
        rk.season_counts_sharded(pmat_s, scal_s, grid_log_s, [10, 10, 10], 1_000, seeds,
                                 mesh=make_mesh(devices=["cpu"]))


# ---- the golden counts ----------------------------------------------------------


@pytest.fixture(scope="module")
def golden_counts():
    return golden.load()


@pytest.mark.gpu
@pytest.mark.parametrize("case", golden.CASES)
def test_kernel_counts_equal_the_golden_file(case, cuda_device, golden_counts):
    """K1 at 20, 40, 80 and 128 drivers and K2 on the synthetic 2024 season
    and the padded wide season (65,536 sims per race) give the golden file's
    counts bit for bit: the race body may change how it computes, never
    what."""
    got = golden.run_case(case, cuda_device, golden_counts, int(golden_counts["sims"]))
    torch.cuda.synchronize()
    want = golden_counts[case]
    assert got.shape == want.shape
    differ = got.cpu().numpy() != want
    assert not differ.any(), f"{int(differ.sum())} of {want.size} cells differ"
