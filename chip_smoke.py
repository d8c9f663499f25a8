"""Smoke test of the PyTorch port on one CUDA GPU (written for an H100).

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the race kernels from `monte_carlo_gp_torch/csrc/` (K1, one race;
K2, a season in one launch) and holds each against its plain PyTorch version,
K1 also against the native C++ oracle. It drives the port's paths through
their CLI entry points and checks that each went through its kernel:

  * the single-weekend prediction (Bahrain 2024, synthetic world, 20
    drivers, 57 laps, 1,048,576 simulations) through K1;
  * the batched season backtest (synthetic 2023 and 2024 seasons, 20 races
    each, 10,000 simulations per race) through K2, one launch per season;
  * the sequential backtest of the same seasons through K1, once per race;
  * the parameter sweep (2024, a 2x2 grid plus the default) through K2;
  * wide fields: K1 at 40, 80 and 128 drivers (two to four cars per lane)
    against its plain version and, at 40, against the native oracle; K2 on
    a season of 80-, 64-, 40- and 20-driver fields padded to 80, through the
    season path; weekends of 40, 80, 128 and 150 drivers through
    `F1Predictor.simulate_plan` (K1 up to 128 drivers, the lap engine
    above); the lap engine on the card against K1 and the native oracle;
    and the two-compound rule mutation of the oracle, which K1's tolerance
    must catch.

Every phase that fails raises and the script exits non-zero, and each
prints its seconds. The last line
of standard output is one JSON object, {"ok": true, "device": {...}}; the
line before it is the card's name and power limit, and the one before that
lists the kernels, with their launches on their path, their error against
the plain version, their times and their bounds (with a `wide` list of
the same readings at each wide field). Without a CUDA device it exits
non-zero and prints no result.
"""

from __future__ import annotations

import importlib.util
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

START = time.perf_counter()
ROOT = Path(__file__).resolve().parent
SMOKE_CACHE = ROOT / "build" / "smoke_cache"
PLAN_FIXTURE = ROOT / "tests" / "data" / "torch_plan_bahrain2024.npz"

MAIN_ARGS = [
    "--race", "Bahrain", "--season", "2024", "--synthetic",
    "--simulations", "1048576", "--seed", "0", "--device", "cuda", "--timings",
    "--cache-dir", str(SMOKE_CACHE),
]
MAIN_SIMS = 1_048_576
# bounds: kernel vs plain on one Philox stream (only last-bit log/cos
# differences can flip a decision, which moves a few simulations per cell:
# 5e-4 is 32 of 65,536); kernel vs the native oracle, the bound the JAX
# package holds its Pallas kernel to at 262,144 sims
MAX_ABS_PROB_ERR = 5e-4
ORACLE_SIMS, ORACLE_TV = 262_144, 0.017
GRID_ATOL = 1e-6

# the season paths: BASELINE's "full-season backtest 2023-2024, all races x
# 10k sims" on the synthetic world, and a 2x2 sweep of 2024
SEASONS, SEASON_SIMS, SEED = ["2023", "2024"], "10000", 42
BACKTEST_ARGS = ["--synthetic", "--simulations", SEASON_SIMS, "--seed", str(SEED),
                 "--device", "cuda"]
SWEEP_ARGS = ["--synthetic", "--seasons", "2024", "--simulations", SEASON_SIMS,
              "--seed", str(SEED), "--grid", "sc_prob=0.01,0.05",
              "--grid", "variance_scale=1.0,1.2", "--device", "cuda"]
SWEEP_CONFIGS = 4
# K2 against its plain version, and the season's timing shape
SEASON_CHECK_SIMS, SEASON_TIME_SIMS = 65_536, 262_144
# the sequential backtest's win Brier differs from the batched one's only
# by Monte Carlo noise (other seeds)
WIN_BRIER_ATOL = 0.01

# wide fields: K1 against its plain version at 65,536 sims and timed
# at 262,144; K1 at 40 drivers against the native oracle in the JAX
# package's D = 40 anchor (tests/test_engine_stats.py:172-216, bound 0.025
# at 32,768 engine and 200,000 oracle sims; here 262,144 and 65,536, less
# noise on the sum); a season of these widths padded to 80
WIDE_WIDTHS, WIDE_LAPS = (40, 80, 128), 57
WIDE_CHECK_SIMS, WIDE_TIME_SIMS = 65_536, 262_144
ANCHOR_KERNEL_SIMS, ANCHOR_ORACLE_SIMS, ANCHOR_TV = 262_144, 65_536, 0.025
WIDE_SEASON_WIDTHS, WIDE_SEASON_SEED = (80, 64, 40, 20), 4242
# weekends through the predictor: K1 up to 128 drivers, the lap engine above
WEEKEND_WIDTHS, WEEKEND_SIMS, WEEKEND_LAPS = (40, 80, 128, 150), 65_536, 10
# the lap engine against K1 (262,144 sims a side: the Monte Carlo floor of
# the per-driver TV is ~0.005-0.007 at 20-40 drivers) and against the native
# oracle at 150 drivers
ENGINE_SIMS, ENGINE_TV = 262_144, 0.02
ENGINE_ORACLE_D, ENGINE_ORACLE_SIMS, ENGINE_ORACLE_TV = 150, 20_000, 0.03
# the two-compound mutation (tests/test_engine_stats.py:270-313): K1 must be
# within the tight bound of the real oracle and the mutated oracle outside
# the blown one
MUTATION_LAPS, MUTATION_KERNEL_SIMS, MUTATION_ORACLE_SIMS = 24, 1_048_576, 200_000
MUTATION_TIGHT_TV, MUTATION_BLOWN_TV = 0.012, 0.05

# The roofline bound: the larger of the bytes each kernel must move over
# the card's memory rate and its float32 operations over the card's float32
# rate outside the tensor cores (H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12


def race_flops(d: int, laps: int, n_sims: int) -> int:
    """float32 operations of `n_sims` races of `d` cars over `laps` laps,
    counted per car from `csrc/race_kernel.cu` (add, sub, mul, min, max,
    floor, sqrt, log, cos, negation; compares, selects, shuffles, integer
    and Philox work not counted):
      * grid, per slot: two 5-step warp maxima, the uniform and its clamp,
        the Gumbel -log(-log(u)) and the add: 17;
      * lap 1: the DNF draw, two normals (9 each), the clean lap time (10),
        the start model, the state update, the leader and the rank key: 49;
      * each further lap: race control (21), the DNF draw and normal (10),
        the clean lap time (10), dirty air (2), the state update (5), the
        pit window (2), pace (3), the position update (8), and three
        overtake passes of 11 plus the prefix max's steps each: ceil(log2 d)
        up to 32 cars, and above (several cars per lane) a 5-step scan
        within each slot of 32 positions and one step carried across.
    Above 32 cars the grid's two warp maxima first reduce over the lane's
    slots, which adds no operation per car."""
    scan = math.ceil(math.log2(max(d, 2))) if d <= 32 else 6
    per_lap = 61 + 3 * (11 + scan)
    return n_sims * d * (17 * d + 49 + (laps - 1) * per_lap)


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take."""
    ops_ms, bytes_ms = flops / F32_FLOPS_PER_S * 1e3, n_bytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def race_bytes(d: int) -> int:
    """One race's inputs read once and its histogram written once: pmat
    (d, 8), 24 scalars, grid_log (d, d) float32, counts (d, d) int32."""
    return 4 * (d * 8 + 24 + d * d + d * d)


def log(msg: str) -> None:
    print(msg, flush=True)


def std_params(device):
    """The JAX package's standard 20-driver validation field."""
    from monte_carlo_gp_torch.config import make_sim_params

    d = 20
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0)
    gp = (gp / gp.sum(1, keepdims=True)).astype(np.float32)
    rng = np.random.default_rng(7)
    return make_sim_params(
        grid_probs=gp,
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.0008),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
        device=device,
    )


def gauss_grid(d: int, width: float) -> np.ndarray:
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / width)
    return (gp / gp.sum(1, keepdims=True)).astype(np.float32)


def wide_field(d: int, device):
    """The field of tests/test_torch_race_kernel_gpu.py at d drivers."""
    from monte_carlo_gp_torch.profile_kernel import wide_field as field

    return field(d, device)


def oracle_scenario(d: int, seed: int, pace_step: float, device):
    """The native-oracle scenarios of tests/test_engine_stats.py: the D = 40
    anchor (seed 5, 0.06 s per grid slot) and the two-compound scenario
    (D = 10, seed 5, 0.12 s per slot)."""
    from monte_carlo_gp_torch.config import make_sim_params

    rng = np.random.default_rng(seed)
    return make_sim_params(
        grid_probs=gauss_grid(d, 6.0),
        base_pace=(90.0 + pace_step * np.arange(d) + 0.05 * rng.standard_normal(d)).astype(np.float32),
        tire_deg=np.clip(0.05 + 0.02 * rng.standard_normal(d), 0.01, 0.15).astype(np.float32),
        variance=np.full(d, 0.15, np.float32),
        dnf_rate=np.full(d, 0.001, np.float32),
        team_dnf_rate=np.full(d, 0.002, np.float32),
        pit_loss=21.0,
        overtake_delta=0.6,
        device=device,
    )


def wide_plan(d: int, device, laps: int = WEEKEND_LAPS, params=None):
    """tests/test_pallas_engine.py::_wide_field_plan: a flat grid, pace
    0.05 s apart, 10 laps."""
    from monte_carlo_gp_torch.config import make_sim_params
    from monte_carlo_gp_torch.models.predictor import WeekendPlan

    if params is None:
        params = make_sim_params(
            grid_probs=np.full((d, d), 1.0 / d, np.float32),
            base_pace=90 + 0.05 * np.arange(d),
            tire_deg=np.full(d, 0.05),
            variance=np.full(d, 0.15),
            dnf_rate=np.full(d, 0.001),
            team_dnf_rate=np.full(d, 0.002),
            pit_loss=21.0,
            overtake_delta=0.6,
            device=device,
        )
    drivers = [f"D{i:03d}" for i in range(d)]
    return WeekendPlan(params=params, total_laps=laps, drivers=drivers,
                       quali_probs={dr: [1.0 / d] * d for dr in drivers}, weather={},
                       prediction_point="fp2", grid_is_actual=False)


def tv_max(a, b) -> float:
    return float((0.5 * np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).sum(axis=1)).max())


def plain_ms_of(fn):
    """(fn's result, its wall ms), synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def max_prob_err(a: torch.Tensor, b: torch.Tensor, n: int) -> float:
    return (a.double() - b.double()).abs().max().item() / n


def time_kernel_ms(fn, repeats: int = 3) -> float:
    fn()  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def run_counted(rk, fn):
    """(fn's result, wall seconds, K1 launches, K2 launches) of one run
    driven with both launch counts set to 0 just before it."""
    rk.race_counts.launches = rk.season_counts.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, rk.race_counts.launches, rk.season_counts.launches


def season_phases(dev) -> tuple[list[int], dict]:
    """K2 against its plain version and against K1, then the season paths
    through their CLI entry points, then the timings at the season's shape.
    Returns the season's lap counts and K2's entry of the kernels line."""
    from monte_carlo_gp_torch import backtest as backtest_cli
    from monte_carlo_gp_torch import tune as tune_cli
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.ops import philox
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.utils.profiling import Phase, timed_calls
    from monte_carlo_gp_torch.validate import backtest as bt

    # ---- the synthetic 2024 season, prepared on this machine ----------------
    t0 = time.perf_counter()
    predictor = F1Predictor(cache_dir=SMOKE_CACHE / "season_plans",
                            backend=SyntheticBackend(seed=2718), device=dev)
    plans, _ = bt.prepare_season_plans(predictor, 2024, verbose=False)
    prep_s = time.perf_counter() - t0
    laps = [p.total_laps for p in plans]
    widths = [p.params.n_drivers for p in plans]
    log(f"[season inputs] synthetic 2024: {len(plans)} races, drivers {widths}, laps {laps}; "
        f"host walk-forward preparation {prep_s:.3f} s")
    if len(plans) != 20 or max(widths) > 32:
        raise AssertionError("the synthetic 2024 season is not 20 races of at most 32 drivers")
    pmat_s, scal_s, grid_log_s, d = rk.pack_season_inputs([p.params.to(dev) for p in plans])
    season_seed = SEED * 1_000_003 + 2024
    seeds = [philox.fold_in(season_seed, r) for r in range(len(plans))]

    # ---- K2 against its plain version ---------------------------------------
    n = SEASON_CHECK_SIMS
    kernel = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    torch.cuda.synchronize()
    plain_check_ms = (time.perf_counter() - t0) * 1e3
    errs = [max_prob_err(kernel[r], plain[r], n) for r in range(len(plans))]
    cells = int((kernel.long() != plain).sum())
    log(f"[season kernel vs plain] 20 races, {n} sims each: max |dprob| per race "
        f"{max(errs):.3e} (bound {MAX_ABS_PROB_ERR}); {cells} of {kernel.numel()} cells differ; "
        f"plain version {plain_check_ms:.1f} ms")
    real_rows = all(bool((kernel[r, :w, :w].sum(1) == n).all()) for r, w in enumerate(widths))
    if not max(errs) <= MAX_ABS_PROB_ERR or not real_rows:
        raise AssertionError("the season kernel disagrees with its plain version")

    # ---- season against single race, and launch shapes -----------------------
    singles = [rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=seeds[r])
               for r in range(len(plans))]
    shaped = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                              warps_per_block=4, blocks_per_race=37)
    torch.cuda.synchronize()
    same_single = [torch.equal(kernel[r], s) for r, s in enumerate(singles)]
    same_shape = torch.equal(kernel, shaped)
    log(f"[season vs single race] race r of the season launch equals K1 at fold_in(seed, r): "
        f"{sum(same_single)} of {len(plans)} races bitwise; 8 warps x default blocks vs "
        f"4 warps x 37 blocks per race: {same_shape}")
    if not all(same_single) or not same_shape:
        raise AssertionError("the season launch departs from K1 or depends on its shape")

    # ---- the batched season backtest, through its CLI --------------------------
    route = ("sklearn.calibration_curve" if importlib.util.find_spec("sklearn")
             else "NumPy fallback (scikit-learn not installed)")
    cache = ["--cache-dir", str(SMOKE_CACHE / "backtest")]
    timers = Phase()
    with timed_calls(bt, "prepare_season_plans", timers):
        batched, wall, k1, k2 = run_counted(rk, lambda: backtest_cli.run(
            [*BACKTEST_ARGS, "--seasons", *SEASONS, "--batched", *cache]))
    prep_s = timers.totals["prepare_season_plans"]
    season_launches = k2
    log(f"[batched backtest] seasons {SEASONS}, {SEASON_SIMS} sims per race: races "
        f"{batched['n_races']}; pole Brier {batched['pole_brier']:.6f}, win Brier "
        f"{batched['win_brier']:.6f}, podium accuracy {batched['podium_accuracy']:.4f}; "
        f"calibration by {route}; K2 launches {k2}, K1 launches {k1}; wall {wall:.3f} s, "
        f"host preparation {prep_s:.3f} s ({prep_s / wall:.1%} of it)")
    if (k2, k1) != (len(SEASONS), 0) or batched["n_races"] != 20 * len(SEASONS):
        raise AssertionError("the batched backtest did not run one season launch per season")
    if not all(0.0 <= batched[k] <= 1.0 for k in ("pole_brier", "win_brier", "podium_accuracy")):
        raise AssertionError("the batched backtest's metrics are out of range")

    # ---- the sequential backtest, through its CLI -------------------------------
    # a cache directory of its own: the same host work as the batched run
    seq, wall, k1, k2 = run_counted(rk, lambda: backtest_cli.run(
        [*BACKTEST_ARGS, "--seasons", *SEASONS, "--cache-dir", str(SMOKE_CACHE / "sequential")]))
    log(f"[sequential backtest] races {seq['n_races']}; pole Brier {seq['pole_brier']:.6f}, "
        f"win Brier {seq['win_brier']:.6f} (batched {batched['win_brier']:.6f}); "
        f"K1 launches {k1}, K2 launches {k2}; wall {wall:.3f} s")
    if (k1, k2) != (seq["n_races"], 0) or seq["n_races"] != batched["n_races"]:
        raise AssertionError("the sequential backtest did not launch K1 once per race")
    if seq["pole_brier"] != batched["pole_brier"] or not (
            abs(seq["win_brier"] - batched["win_brier"]) <= WIN_BRIER_ATOL):
        raise AssertionError("the sequential and batched backtests disagree")

    # ---- the sweep, through its CLI ---------------------------------------------
    one, _, _, _ = run_counted(rk, lambda: backtest_cli.run(
        [*BACKTEST_ARGS, "--seasons", "2024", "--batched", *cache]))
    sweep, wall, k1, k2 = run_counted(rk, lambda: tune_cli.run(
        [*SWEEP_ARGS, "--cache-dir", str(SMOKE_CACHE / "sweep")]))
    default = sweep["default"]
    log(f"[sweep] 2024, {SWEEP_CONFIGS} configurations + the default: K2 launches {k2}, "
        f"K1 launches {k1}; wall {wall:.3f} s; best {sweep['best']['overrides']} win Brier "
        f"{sweep['best']['win_brier']:.6f}; default win Brier {default['win_brier']:.6f} "
        f"(batched 2024 backtest {one['win_brier']:.6f})")
    if (k2, k1) != (SWEEP_CONFIGS + 1, 0):
        raise AssertionError("the sweep did not run one season launch per configuration")
    if any(default[k] != one[k] for k in ("n_races", "pole_brier", "win_brier", "podium_accuracy")):
        raise AssertionError("the sweep's default differs from the batched backtest")

    # ---- timings at the season's shape -------------------------------------------
    backtest_ms = time_kernel_ms(
        lambda: rk.season_counts(pmat_s, scal_s, grid_log_s, laps, int(SEASON_SIMS), seeds))
    log(f"[season shape] K2 at the backtest's 20 races x {SEASON_SIMS} sims: {backtest_ms:.3f} ms "
        f"per season launch")
    n = SEASON_TIME_SIMS
    season_ms = time_kernel_ms(
        lambda: rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds))
    singles_ms = time_kernel_ms(lambda: [
        rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=seeds[r])
        for r in range(len(plans))])
    kernel = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(max_prob_err(kernel[r], plain[r], n) for r in range(len(plans)))
    # the work of each race's real field; its inputs are read at the padded
    # width, with its two key words and its lap count
    bound_ms, bound_by = bound(sum(race_flops(w, lp, n) for w, lp in zip(widths, laps)),
                               len(plans) * (race_bytes(d) + 8 + 4))
    log(f"[season shape] 20 races x {n} sims: K2 {season_ms:.3f} ms, 20 K1 launches "
        f"{singles_ms:.3f} ms, plain {plain_ms:.1f} ms, max |dprob| {err:.3e} "
        f"(bound {MAX_ABS_PROB_ERR}); roofline bound {bound_ms:.3f} ms ({bound_by})")
    if not err <= MAX_ABS_PROB_ERR:
        raise AssertionError("the season kernel disagrees with its plain version at its shape")
    return laps, {
        "name": "season_counts",
        "route": "cuda",
        "source": "monte_carlo_gp_torch/csrc/race_kernel.cu",
        "replaces": "monte_carlo_gp_tpu/ops/pallas_engine.py:895",
        "launches": season_launches,
        "max_abs_err": err,
        "ms": season_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }


def wide_kernel_phases(dev) -> list[dict]:
    """K1 at 40, 80 and 128 drivers against its plain version (and
    determinism and launch shapes at 80), timed beside its bound and its
    plain version; then K1 at 40 drivers against the native oracle. Returns
    K1's wide readings."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle

    rows = []
    for d in WIDE_WIDTHS:
        t0 = time.perf_counter()
        pmat, scal, grid_log = rk.pack_inputs(wide_field(d, dev))
        n = WIDE_CHECK_SIMS
        kernel = rk.race_counts(pmat, scal, grid_log, WIDE_LAPS, n, seed=123)
        plain, check_plain_ms = plain_ms_of(
            lambda: rk.race_counts_plain(pmat, scal, grid_log, WIDE_LAPS, n, seed=123))
        err = max_prob_err(kernel, plain, n)
        rows_ok = bool((kernel.sum(1) == n).all()) and bool((kernel.sum(0) == n).all())
        shapes = ""
        if d == 80:
            runs = [rk.race_counts(pmat, scal, grid_log, WIDE_LAPS, n, seed=123, warps_per_block=w)
                    for w in (8, 4, 3)]
            same = [torch.equal(kernel, rk.race_counts(pmat, scal, grid_log, WIDE_LAPS, n, seed=123)),
                    *(torch.equal(kernel, r) for r in runs)]
            shapes = f"; same seed twice {same[0]}, warps per block 8 vs 4 vs 3: {same[1:]}"
            if not all(same):
                raise AssertionError(f"K1 counts at {d} drivers depend on the run or the launch shape")
        log(f"[wide kernel vs plain] D={d}, {WIDE_LAPS} laps, {n} sims: max |dprob| {err:.3e} "
            f"(bound {MAX_ABS_PROB_ERR}); {(kernel.long() != plain).sum().item()} of {d * d} "
            f"cells differ; rows and columns sum to n: {rows_ok}; plain {check_plain_ms:.1f} ms{shapes}")
        if not err <= MAX_ABS_PROB_ERR or not rows_ok:
            raise AssertionError(f"K1 disagrees with its plain version at {d} drivers")

        n = WIDE_TIME_SIMS
        ms = time_kernel_ms(lambda: rk.race_counts(pmat, scal, grid_log, WIDE_LAPS, n, seed=0))
        kernel = rk.race_counts(pmat, scal, grid_log, WIDE_LAPS, n, seed=0)
        plain, plain_ms = plain_ms_of(
            lambda: rk.race_counts_plain(pmat, scal, grid_log, WIDE_LAPS, n, seed=0))
        err_t = max_prob_err(kernel, plain, n)
        bound_ms, bound_by = bound(race_flops(d, WIDE_LAPS, n), race_bytes(d))
        warps, blocks = rk.launch_shape(dev, d)
        log(f"[wide kernel shape] D={d}, {WIDE_LAPS} laps, {n} sims: kernel {ms:.3f} ms "
            f"({warps} warps x {blocks} blocks, {rk.blocks_per_sm(dev.index or 0, d, warps, False)} "
            f"blocks per SM), plain {plain_ms:.1f} ms, max |dprob| {err_t:.3e}; roofline bound "
            f"{bound_ms:.3f} ms ({bound_by}); phase {time.perf_counter() - t0:.1f} s")
        if not err_t <= MAX_ABS_PROB_ERR:
            raise AssertionError(f"K1 disagrees with its plain version at {d} drivers, {n} sims")
        rows.append({"d": d, "laps": WIDE_LAPS, "sims": n, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max(err, err_t)})

    # ---- K1 at 40 drivers against the native oracle --------------------------
    t0 = time.perf_counter()
    params = oracle_scenario(40, 5, 0.06, dev)
    probs = rk.run_monte_carlo_kernel(params, 7, ANCHOR_KERNEL_SIMS, 30).cpu().numpy()
    native = run_native_oracle(params, seed=7, n_sims=ANCHOR_ORACLE_SIMS, total_laps=30)
    tv = tv_max(probs, native)
    log(f"[wide kernel vs native oracle] D=40, 30 laps, K1 {ANCHOR_KERNEL_SIMS} sims, oracle "
        f"{ANCHOR_ORACLE_SIMS}: max per-driver TV {tv:.4f} (bound {ANCHOR_TV}); phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not tv < ANCHOR_TV:
        raise AssertionError("K1 at 40 drivers departs from the native oracle")
    return rows


def wide_season_phase(dev, laps: list[int]) -> dict:
    """K2 on 20 races of the synthetic 2024 lap counts with fields of 80,
    64, 40 and 20 drivers in turn, padded to 80: through the season path
    (`simulate_season_plans`, one K2 launch), against its plain version,
    race r bitwise equal to K1 at `fold_in(seed, r)`, two launch shapes
    bitwise equal, and timed. Returns K2's wide reading."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.ops import philox
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.validate import backtest as bt

    t0 = time.perf_counter()
    widths = [WIDE_SEASON_WIDTHS[r % len(WIDE_SEASON_WIDTHS)] for r in range(len(laps))]
    plist = [wide_field(w, dev) for w in widths]
    n = WIDE_CHECK_SIMS
    predictor = F1Predictor(cache_dir=SMOKE_CACHE / "wide_season",
                            backend=SyntheticBackend(seed=2718), device=dev)
    plans = [wide_plan(w, dev, lp, params=p) for w, lp, p in zip(widths, laps, plist)]
    probs, wall, k1, k2 = run_counted(
        rk, lambda: bt.simulate_season_plans(predictor, plans, WIDE_SEASON_SEED, n))
    log(f"[wide season path] simulate_season_plans, {len(laps)} races of {sorted(set(widths))} "
        f"drivers padded to {max(widths)}, {n} sims each: K2 launches {k2}, K1 launches {k1}; "
        f"wall {wall:.3f} s")
    if (k2, k1) != (1, 0):
        raise AssertionError("the wide season did not run as one season launch")

    pmat_s, scal_s, grid_log_s, d = rk.pack_season_inputs(plist)
    seeds = [philox.fold_in(WIDE_SEASON_SEED, r) for r in range(len(laps))]
    kernel = rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds)
    plain, plain_ms = plain_ms_of(
        lambda: rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds))
    err = max(max_prob_err(kernel[r], plain[r], n) for r in range(len(laps)))
    real_rows = all(bool((kernel[r, :w, :w].sum(1) == n).all()) for r, w in enumerate(widths))
    path_equal = all(np.array_equal(probs[r], (kernel[r].float() / n).cpu().numpy())
                     for r in range(len(laps)))
    singles = [torch.equal(kernel[r], rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r],
                                                     n, seed=seeds[r]))
               for r in range(len(laps))]
    shaped = torch.equal(kernel, rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                                                  warps_per_block=4, blocks_per_race=37))
    ms = time_kernel_ms(lambda: rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds))
    bound_ms, bound_by = bound(sum(race_flops(w, lp, n) for w, lp in zip(widths, laps)),
                               len(laps) * (race_bytes(d) + 8 + 4))
    log(f"[wide season kernel] D={d}: vs plain max |dprob| {err:.3e} (bound {MAX_ABS_PROB_ERR}); "
        f"the path's result is K2's counts: {path_equal}; race r equals K1 at fold_in(seed, r): "
        f"{sum(singles)} of {len(laps)}; default vs 4 warps x 37 blocks per race: {shaped}; "
        f"K2 {ms:.3f} ms, plain {plain_ms:.1f} ms, roofline bound {bound_ms:.3f} ms ({bound_by}); "
        f"phase {time.perf_counter() - t0:.1f} s")
    if not (err <= MAX_ABS_PROB_ERR and real_rows and path_equal and all(singles) and shaped):
        raise AssertionError("the wide season launch disagrees with its plain version or K1")
    return {"d": d, "widths": widths, "laps": laps, "launches": k2, "sims_per_race": n,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err}


def wide_weekend_phase(dev) -> dict[int, int]:
    """Weekends of 40, 80, 128 and 150 drivers through
    `F1Predictor.simulate_plan` + `assemble_result` on the card: one K1
    launch up to 128 drivers; at 150 no K1 launch and one lap-engine call on
    the card. Returns the K1 launches of each width."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import predictor as predictor_mod
    from monte_carlo_gp_torch.ops import engine
    from monte_carlo_gp_torch.ops import race_kernel as rk

    predictor = predictor_mod.F1Predictor(
        cache_dir=SMOKE_CACHE / "wide_weekend", backend=SyntheticBackend(seed=2718), device=dev)
    engine_devices = []
    real_engine = predictor_mod.run_monte_carlo

    def engine_spy(params, *args, **kwargs):
        engine_devices.append(params.device.type)
        return real_engine(params, *args, **kwargs)

    predictor_mod.run_monte_carlo = engine_spy
    launches = {}
    try:
        for d in WEEKEND_WIDTHS:
            plan = wide_plan(d, dev)
            engine_devices.clear()
            engine.run_monte_carlo.calls = 0
            result, wall, k1, k2 = run_counted(rk, lambda: predictor.assemble_result(
                plan, predictor.simulate_plan(plan, WEEKEND_SIMS, seed=0)))
            calls = engine.run_monte_carlo.calls
            dist = np.array([[result["full_distributions"][dr].get(p + 1, 0.0) for p in range(d)]
                             for dr in plan.drivers])
            ok = (dist.shape == (d, d) and np.isfinite(dist).all()
                  and np.allclose(dist.sum(axis=1), 1.0, atol=1e-5)
                  and result["n_simulations_effective"] == WEEKEND_SIMS)
            log(f"[wide weekend] D={d}, {WEEKEND_LAPS} laps, {WEEKEND_SIMS} sims through "
                f"simulate_plan + assemble_result: K1 launches {k1}, K2 {k2}, lap-engine calls "
                f"{calls} on {engine_devices or 'no device'}; rows finite and summing to 1: {ok}; "
                f"wall {wall:.3f} s")
            want = (1, 0, []) if d <= rk.MAX_DRIVERS else (0, 1, [dev.type])
            if (k1, calls, engine_devices) != want or k2 != 0 or not ok:
                raise AssertionError(f"the {d}-driver weekend did not take its route")
            launches[d] = k1
    finally:
        predictor_mod.run_monte_carlo = real_engine
    return launches


def engine_phase(dev) -> None:
    """The lap engine on the card: against K1 at 20 and 40 drivers (each on
    its own stream) and against the native oracle at 150, with its times."""
    from monte_carlo_gp_torch.ops import engine
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle

    times = {}
    for d, params, laps in ((20, std_params(dev), 57), (40, oracle_scenario(40, 5, 0.06, dev), 30)):
        t0 = time.perf_counter()
        probs, eng_ms = plain_ms_of(lambda: engine.run_monte_carlo(params, 5, ENGINE_SIMS, laps))
        k1 = rk.run_monte_carlo_kernel(params, 6, ENGINE_SIMS, laps)
        tv = tv_max(probs.cpu().numpy(), k1.cpu().numpy())
        times[d] = (laps, eng_ms)
        log(f"[engine vs K1] D={d}, {laps} laps, {ENGINE_SIMS} sims a side: max per-driver TV "
            f"{tv:.4f} (bound {ENGINE_TV}); engine on {probs.device}; phase "
            f"{time.perf_counter() - t0:.1f} s")
        if probs.device.type != dev.type or not tv < ENGINE_TV:
            raise AssertionError(f"the lap engine departs from K1 at {d} drivers")

    t0 = time.perf_counter()
    d = ENGINE_ORACLE_D
    params = wide_plan(d, dev).params
    torch.cuda.reset_peak_memory_stats()
    probs, eng_ms = plain_ms_of(lambda: engine.run_monte_carlo(params, 5, ENGINE_SIMS, WEEKEND_LAPS))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    times[d] = (WEEKEND_LAPS, eng_ms)
    native = run_native_oracle(params, seed=8, n_sims=ENGINE_ORACLE_SIMS, total_laps=WEEKEND_LAPS)
    tv = tv_max(probs.cpu().numpy(), native)
    log(f"[engine vs native oracle] D={d}, {WEEKEND_LAPS} laps, engine {ENGINE_SIMS} sims, oracle "
        f"{ENGINE_ORACLE_SIMS}: max per-driver TV {tv:.4f} (bound {ENGINE_ORACLE_TV}); engine peak "
        f"memory {peak_gb:.2f} GB in blocks of {engine.DEFAULT_SIMS_PER_BLOCK}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not tv < ENGINE_ORACLE_TV:
        raise AssertionError(f"the lap engine departs from the native oracle at {d} drivers")
    log("[engine times] " + "; ".join(
        f"D={d}, {laps} laps, {ENGINE_SIMS} sims: {ms:.1f} ms" for d, (laps, ms) in times.items()))


def mutation_phase(dev) -> None:
    """The two-compound scenario: K1 within the tight bound of the real
    oracle, and the oracle without the rule outside the blown bound."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.validate.native_oracle import (
        MUT_NO_TWO_COMPOUND_RULE, run_native_oracle)

    t0 = time.perf_counter()
    params = oracle_scenario(10, 5, 0.12, dev)
    probs = rk.run_monte_carlo_kernel(params, 9, MUTATION_KERNEL_SIMS, MUTATION_LAPS).cpu().numpy()
    good = run_native_oracle(params, seed=42, n_sims=MUTATION_ORACLE_SIMS, total_laps=MUTATION_LAPS)
    bad = run_native_oracle(params, seed=42, n_sims=MUTATION_ORACLE_SIMS, total_laps=MUTATION_LAPS,
                            mutation=MUT_NO_TWO_COMPOUND_RULE)
    tv_good, tv_bad = tv_max(probs, good), tv_max(probs, bad)
    log(f"[mutation] two-compound scenario, D=10, {MUTATION_LAPS} laps, K1 {MUTATION_KERNEL_SIMS} "
        f"sims, oracle {MUTATION_ORACLE_SIMS}: max TV vs the real oracle {tv_good:.4f} (must be < "
        f"{MUTATION_TIGHT_TV}), vs the oracle without the rule {tv_bad:.4f} (must be > "
        f"{MUTATION_BLOWN_TV}); phase {time.perf_counter() - t0:.1f} s")
    if not (tv_good < MUTATION_TIGHT_TV and tv_bad > MUTATION_BLOWN_TV):
        raise AssertionError("the tolerance does not tell the real rules from the mutated ones")


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    # every run starts with no data or Elo cache, so its host times compare
    shutil.rmtree(SMOKE_CACHE, ignore_errors=True)
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"{torch.cuda.device_count()} device(s)")
    log(smi)

    from monte_carlo_gp_torch.__main__ import run as run_cli
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle

    # ---- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    how = "found built" if rk.is_built() else "compiled"
    lib = rk.build()
    log(f"[build] {lib.name} {how} in {time.perf_counter() - t0:.2f} s")
    log(lib.with_suffix(".log").read_text().strip())

    # ---- kernel vs plain on the same Philox stream ---------------------------
    params = std_params(dev)
    laps, n = 57, 65_536
    pmat, scal, grid_log = rk.pack_inputs(params)
    kernel = rk.race_counts(pmat, scal, grid_log, laps, n, seed=123)
    torch.cuda.synchronize()
    plain = rk.race_counts_plain(pmat, scal, grid_log, laps, n, seed=123)
    err = max_prob_err(kernel, plain, n)
    log(f"[kernel vs plain] D=20, {laps} laps, {n} sims: max |dprob| {err:.3e} "
        f"(bound {MAX_ABS_PROB_ERR}); {(kernel.long() != plain).sum().item()} of 400 cells differ")
    if not err <= MAX_ABS_PROB_ERR or not bool((kernel.sum(1) == n).all()):
        raise AssertionError("kernel disagrees with its plain version")

    # ---- determinism and launch-shape independence ---------------------------
    again = rk.race_counts(pmat, scal, grid_log, laps, n, seed=123)
    shapes = [rk.race_counts(pmat, scal, grid_log, laps, n, seed=123, warps_per_block=w)
              for w in (4, 3)]
    torch.cuda.synchronize()
    same = [torch.equal(kernel, c) for c in (again, *shapes)]
    log(f"[determinism] same seed twice: {same[0]}; warps per block 8 vs 4 vs 3: {same[1:]}")
    if not all(same):
        raise AssertionError("kernel counts depend on the run or the launch shape")

    # ---- kernel vs the native oracle -----------------------------------------
    t0 = time.perf_counter()
    probs = rk.run_monte_carlo_kernel(params, 1, ORACLE_SIMS, laps).cpu().numpy()
    native = run_native_oracle(params, seed=42, n_sims=ORACLE_SIMS, total_laps=laps)
    tv = 0.5 * np.abs(probs - native).sum(axis=1)
    log(f"[kernel vs native oracle] {ORACLE_SIMS} sims each: max per-driver TV "
        f"{tv.max():.4f} (bound {ORACLE_TV}) in {time.perf_counter() - t0:.1f} s")
    if not tv.max() < ORACLE_TV:
        raise AssertionError("kernel distribution departs from the native oracle")

    # ---- the host layer on this machine vs the JAX package's plan ------------
    t0 = time.perf_counter()
    predictor = F1Predictor(
        cache_dir=SMOKE_CACHE / "fixture_check", backend=SyntheticBackend(seed=2718),
        device=dev,
    )
    plan = predictor.prepare_weekend(2024, "Bahrain")
    with np.load(PLAN_FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}
    if list(fixture["drivers"]) != plan.drivers or int(fixture["total_laps"]) != plan.total_laps:
        raise AssertionError("prepare_weekend drivers/laps differ from the fixture")
    for field in plan.params.__dataclass_fields__:
        got = getattr(plan.params, field).cpu().numpy()
        atol = GRID_ATOL if field == "grid_probs" else 0.0
        if got.shape != fixture[field].shape or not np.allclose(got, fixture[field], rtol=0, atol=atol):
            raise AssertionError(f"prepare_weekend field {field} differs from the fixture")
    log(f"[host layer] prepare_weekend equals the JAX plan fixture field by field "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the main path, through the CLI entry point --------------------------
    rk.race_counts.launches = 0
    t0 = time.perf_counter()
    results, timers = run_cli(MAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rk.race_counts.launches
    dist = np.array([[results["full_distributions"][d].get(p + 1, 0.0) for p in range(20)]
                     for d in plan.drivers])
    prep_s = timers.totals["prepare (data + Elo + features)"]
    sim_s = timers.totals["simulate (Monte Carlo)"]
    log(f"[main path] launches {launches}; prepare {prep_s:.3f} s; simulate {sim_s:.3f} s "
        f"({MAIN_SIMS / sim_s:,.0f} sims/s); wall {wall:.2f} s; "
        f"n_simulations_effective {results['n_simulations_effective']}")
    if launches < 1:
        raise AssertionError("the main path did not launch the race kernel")
    if not (dist.shape == (20, 20) and np.isfinite(dist).all()
            and np.allclose(dist.sum(axis=1), 1.0, atol=1e-5)
            and results["n_simulations_effective"] == MAIN_SIMS):
        raise AssertionError("main path result is not 20 finite probability rows")

    # ---- kernel and plain times at the main path's shape ---------------------
    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(dev))
    run_kernel = lambda: rk.race_counts(pmat, scal, grid_log, plan.total_laps, MAIN_SIMS, seed=0)
    kernel_ms = time_kernel_ms(run_kernel)
    main_counts = run_kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_counts = rk.race_counts_plain(pmat, scal, grid_log, plan.total_laps, MAIN_SIMS, seed=0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    main_err = max_prob_err(main_counts, plain_counts, MAIN_SIMS)
    log(f"[main shape] D=20, {plan.total_laps} laps, {MAIN_SIMS} sims: kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, max |dprob| {main_err:.3e} (bound {MAX_ABS_PROB_ERR})")
    if not main_err <= MAX_ABS_PROB_ERR:
        raise AssertionError("kernel disagrees with its plain version at the main path's shape")
    if not np.allclose(main_counts.cpu().numpy() / MAIN_SIMS, dist, rtol=0, atol=1e-6):
        raise AssertionError("the main path's result is not the kernel's counts")

    d = plan.params.n_drivers
    bound_ms, bound_by = bound(race_flops(d, plan.total_laps, MAIN_SIMS), race_bytes(d))
    log(f"[main shape] roofline bound {bound_ms:.3f} ms ({bound_by})")
    k1 = {
        "name": "race_counts",
        "route": "cuda",
        "source": "monte_carlo_gp_torch/csrc/race_kernel.cu",
        "replaces": "monte_carlo_gp_tpu/ops/pallas_engine.py:838",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }

    t0 = time.perf_counter()
    laps, k2 = season_phases(dev)
    log(f"[phase] the season paths: {time.perf_counter() - t0:.1f} s")

    k1_wide = wide_kernel_phases(dev)
    k2["wide"] = [wide_season_phase(dev, laps)]
    launches = wide_weekend_phase(dev)
    for row in k1_wide:
        row["launches"] = launches[row["d"]]
    k1["wide"] = k1_wide
    engine_phase(dev)
    mutation_phase(dev)
    log(f"[phase] all: {time.perf_counter() - START:.1f} s")
    log(json.dumps({"kernels": [k1, k2]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
