"""Smoke test of the PyTorch port on one CUDA GPU (written for an H100).

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the package's two CUDA libraries from `monte_carlo_gp_torch/csrc/`,
one nvcc each, started together: the race kernels (K1, one race; K2, a
season in one launch) and the HMC kernel (one whole HMC transition of the
Bayesian qualifying model per launch). It holds the race kernels' counts
bitwise against the golden file (`tests/data/torch_kernel_golden.npz`: K1 at
20, 40, 80 and 128 drivers and K2 on two seasons, as the kernels gave them
before the race body's redesign; also through the sharded entries) and each
kernel against its plain PyTorch version, K1 also against the native C++
oracle. It drives the port's paths through their entry points and checks
that each went through its kernel:

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
    must catch;
  * the sharded launch on the one card: K1 at the main shape split over 1,
    2, 3 and 4 shards and K2 on the 2024 season over 2 and 4, each bitwise
    equal to one launch, and the weekend and season paths on a mesh of 4
    shards (`simulate_plan`, `simulate_season_plans`); a one-rank NCCL
    group through `initialize_distributed`; two processes on the card
    joined by gloo through `parallel/dryrun.py` at the main shape; and the
    weekend and batched backtest CLIs with `--engine xla` on the lap engine;
  * the alternative qualifying models and the server: (a) the Bayesian
    model's HMC fit of the synthetic archive (Bahrain 2024) on the card at
    its default budget, through `F1Predictor(quali_model="bayesian")`, each
    of its 2,000 transitions one launch of the HMC kernel (each warmup
    stage's starting logp one launch of its logp entry, no graph replayed),
    bitwise equal to three more kernel fits of the same seed; the kernel
    against its plain version per call (logp, gradient) and per transition
    at states recorded from a real fit; the eager fit of the same seed and
    three fits with every transition a replay of one captured CUDA graph
    (the yardstick), the graphed fit bitwise the eager fit and its peak
    reserved memory not growing; the kernel's ms per launch and the graph's
    per transition timed in turns; the kernel fit within total variation
    0.05 of a CPU fit and of the graphed fit in its pole distribution; (b)
    `python -m monte_carlo_gp_torch.serve` on the card, with the Elo and
    then the Bayesian model: the ready time, 50 requests at 10,000
    simulations and 10 at 1,048,576, their p50/p95 latency, same-seed bodies
    identical and equal to the weekend through F1Predictor in this process
    (one K1 launch); (c) the gbm model: a weekend where scikit-learn
    imports, else the CLI's error naming it;
  * the last modules of the port: (d) `python -m
    monte_carlo_gp_torch.precompile --season-races 20` in a child with a
    fresh MCGP_COMPILE_CACHE (the cold build of both libraries, one K1 and
    one K2 launch), then a weekend CLI in a second child that finds the
    libraries built, and a cold weekend with MCGP_COMPILE_CACHE=0 to
    compare it with; (e) the main path's weekend with `--trace DIR` and
    without, bitwise equal, the trace holding K1 as a device event, with the
    device's busy share and K1's device time read from it; (f) the walkthrough
    (`monte_carlo_gp_torch.examples.weekend_walkthrough`) at its default
    count: its four sections, K1 once per weekend, the season on the lap
    engine.

Every phase that fails raises and the script exits non-zero, and each
prints its seconds. The last line
of standard output is one JSON object, {"ok": true, "device": {...}}; the
line before it is the card's name and power limit, and the one before that
lists the kernels, with their launches on their path, their error against
the plain version, their times and their bounds, the golden check, their
registers (ptxas) and the warps resident on an SM at their launch shape
(with a `wide` list of the same readings at each wide field, the
sharded entry's readings at each shard count, the HMC kernel's graph time
per transition, shared memory and blocks resident, and each kernel's
launches on every path that drives it, `launches_by_path`). Without a CUDA device it
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
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
# the sharded K2 on the season's timing shape, split over shards on one card
SEASON_SHARDS = (2, 4)
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
# the sharded launch: K1 at the main shape over 1-4 shards on the card; two
# processes on the card (gloo); the CLIs with --engine xla at fewer sims
MAIN_SHARDS = (1, 2, 3, 4)
TWO_PROCESS_TIMEOUT_S = 300
XLA_WEEKEND_SIMS, XLA_SEASON_SIMS = 262_144, 2_048
# the Bayesian qualifying model's fit on the card at its default budget
# (4 chains, 1000 + 1000 iterations, 48 leapfrog steps), held to a CPU fit of
# the same seed at tests/test_torch_bayesian.py's bound between two samplers,
# and its acceptance to the JAX tests' range. Split R-hat is printed, not
# gated: on this archive the JAX fit itself reads 1.07-1.18 over seeds 42, 1
# and 2 (a slow team_sigma direction), above the small world's 1.15 gate.
BAYES_POLE_TV, BAYES_ACCEPT = 0.05, (0.6, 0.99)
# sample_posterior's leapfrog steps; the transitions of the first kernel
# fit whose inputs the per-call check runs at (both warmup stages and the
# sampling phase); launches per timing turn of the kernel and the graph, and
# calls of the eager transition timed
BAYES_LEAPFROG = 48
HMC_RECORD_AT = (0, 250, 499, 500, 999, 1000, 1500, 1999)
HMC_TIME_CALLS, HMC_PLAIN_CALLS = 200, 5
# the server: requests at its default count and at the main path's
SERVE_SIMS, SERVE_REQUESTS, SERVE_BIG_REQUESTS, SERVE_SEED = 10_000, 50, 10, 7
SERVE_TIMEOUT_S = 300

# the prebuild step (phase d): its cold build in a fresh MCGP_COMPILE_CACHE,
# then a weekend CLI in a second process that must find the library built
PREBUILD_ARGS = ["--simulations", "10000", "--season-races", "20"]
PREBUILD_WEEKEND_ARGS = ["--race", "Bahrain", "--season", "2024", "--synthetic", "--timings"]
PREBUILD_TIMEOUT_S = 600
BUILD_NOTE = "(includes the kernel build)"
# the walkthrough's sections (phase f), one "predicted" line per race of its
# six-race synthetic season
WALKTHROUGH_SECTIONS = ("=== FP2 prediction", "takes an engine penalty ===",
                        "=== post-quali (actual grid) ===", "=== season batch")
WALKTHROUGH_RACES = 6

# The roofline bound: the larger of the bytes each kernel must move over
# the card's memory rate and its float32 operations over the card's float32
# rate outside the tensor cores (H100 SXM data sheet, at 700 W).
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12


def race_flops(d: int, laps: int, n_sims: int, passes: tuple[int, int]) -> int:
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
        pit window (2), pace (3), the position update (8): 61;
      * each live overtake pass: its uniform, the pace gap and the swap
        probability: 4; and each pass in which a car swaps, the
        time-rewrite chain: 7 plus the prefix max's steps, ceil(log2 d) up
        to 32 cars, and above (several cars per lane) a 5-step scan within
        each slot of 32 positions and one step carried across.
    `passes` is (live, swapping): the simulation-passes of this run's data
    that were live and that swapped (`profile_kernel.overtake_passes` on the
    plain version). A dead pass (the one before it swapped nothing) only
    takes its draw, which is Philox work. Above 32 cars the grid's two warp
    maxima first reduce over the lane's slots, which adds no operation per
    car."""
    scan = math.ceil(math.log2(max(d, 2))) if d <= 32 else 6
    live, swapping = passes
    return n_sims * d * (17 * d + 49 + (laps - 1) * 61) + d * (4 * live + (7 + scan) * swapping)


def pass_counts(races) -> list[tuple[int, int]]:
    """(live, swapping) of each race that `profile_kernel.overtake_passes`
    counted."""
    return [(int(live), int(swapping)) for live, swapping in races]


def pass_shares(passes: tuple[int, int], laps, n_sims: int) -> str:
    """The live and swapping passes per simulation-lap over races of `laps`
    laps (one count per race), for the log."""
    per = n_sims * max(sum(lp - 1 for lp in laps), 1)
    return f"{passes[0] / per:.4f} live and {passes[1] / per:.4f} swapping passes per lap"


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
    driven with every launch count set to 0 just before it (the sharded
    entries' counts are read from `rk` after it)."""
    rk.race_counts.launches = rk.season_counts.launches = 0
    rk.race_counts_sharded.launches = rk.season_counts_sharded.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, rk.race_counts.launches, rk.season_counts.launches


def shard_mesh(dev, n_shards: int):
    """A mesh of `n_shards` shards, all on `dev`: one card holds the split."""
    from monte_carlo_gp_torch.parallel.mesh import make_mesh

    return make_mesh(devices=[dev] * n_shards)


def golden_phase(dev) -> dict[str, int]:
    """K1 and K2 on the golden file's cases, bitwise equal to its counts, and
    the sharded entries on two of them (K1 at 20 drivers over 3 shards, K2 on
    the 2024 season over 2); prints the cells that differ. Returns them by
    entry of the kernels line."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.validate import golden

    t0 = time.perf_counter()
    want = golden.load()
    n = int(want["sims"])
    diffs = golden.check(dev, want)
    _, (pmat, scal, grid_log, laps) = golden.case_inputs("k1_d20", dev, want)
    split = rk.race_counts_sharded(pmat, scal, grid_log, laps, n, seed=golden.K1_SEED,
                                   mesh=shard_mesh(dev, 3))
    diffs["k1_d20 over 3 shards"] = int((split.cpu().numpy() != want["k1_d20"]).sum())
    _, (pmat_s, scal_s, grid_log_s, laps, seeds) = golden.case_inputs("k2_season2024", dev, want)
    split = rk.season_counts_sharded(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                                     mesh=shard_mesh(dev, 2))
    diffs["k2_season2024 over 2 shards"] = int((split.cpu().numpy() != want["k2_season2024"]).sum())
    log(f"[golden] {n} sims per race, cells that differ from the golden counts: "
        + "; ".join(f"{k} {v}" for k, v in diffs.items())
        + f"; phase {time.perf_counter() - t0:.1f} s")
    if any(diffs.values()):
        raise AssertionError("the kernels' counts depart from the golden file")
    return {
        "race_counts": sum(diffs[f"k1_d{w}"] for w in golden.K1_WIDTHS),
        "season_counts": diffs["k2_season2024"] + diffs["k2_wide_season"],
        "race_counts_sharded": diffs["k1_d20 over 3 shards"] + diffs["k2_season2024 over 2 shards"],
    }


def kernel_facts(dev, d: int, season: bool) -> dict:
    """`profile_kernel.kernel_facts` of the built library: the kernel that
    runs d drivers (K1, or K2 with `season`), its registers and spills and
    the warps resident on an SM at its default launch shape."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.profile_kernel import kernel_facts as facts, ptxas_report

    return facts(dev, ptxas_report(rk.build().with_suffix(".log").read_text()), d, season)


def season_phases(dev, golden_cells: int) -> tuple[list[int], dict, dict, dict]:
    """K2 against its plain version and against K1, then the season paths
    through their CLI entry points, then the timings at the season's shape,
    then the sharded K2 at 2 and 4 shards on the card. Returns the season's
    lap counts, K2's entry of the kernels line (with `golden_cells`, the
    cells in which K2 departed from the golden counts), the sharded K2's
    readings and the batched 2024 backtest's result."""
    from monte_carlo_gp_torch import backtest as backtest_cli
    from monte_carlo_gp_torch import tune as tune_cli
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.ops import philox
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.profile_kernel import overtake_passes
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
    with overtake_passes() as races:
        plain, plain_ms = plain_ms_of(
            lambda: rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds))
    passes = pass_counts(races)
    err = max(max_prob_err(kernel[r], plain[r], n) for r in range(len(plans)))
    # the work of each race's real field; its inputs are read at the padded
    # width, with its two key words and its lap count
    bound_ms, bound_by = bound(sum(race_flops(w, lp, n, p) for w, lp, p in zip(widths, laps, passes)),
                               len(plans) * (race_bytes(d) + 8 + 4))
    season_passes = tuple(map(sum, zip(*passes)))
    log(f"[season shape] 20 races x {n} sims: K2 {season_ms:.3f} ms, 20 K1 launches "
        f"{singles_ms:.3f} ms, plain {plain_ms:.1f} ms, max |dprob| {err:.3e} "
        f"(bound {MAX_ABS_PROB_ERR}); {pass_shares(season_passes, laps, n)} (plain version, "
        f"the season's); roofline bound {bound_ms:.3f} ms ({bound_by})")
    if not err <= MAX_ABS_PROB_ERR:
        raise AssertionError("the season kernel disagrees with its plain version at its shape")

    # ---- the sharded season: K2 once per shard, each shard 1/W of every race --
    t0 = time.perf_counter()
    sharded = {"sims_per_race": n, "shards": []}
    for w in SEASON_SHARDS:
        mesh = shard_mesh(dev, w)
        run = lambda: rk.season_counts_sharded(pmat_s, scal_s, grid_log_s, laps, n, seeds, mesh=mesh)
        same = torch.equal(run(), kernel)
        ms = time_kernel_ms(run)
        sharded["shards"].append({"shards": w, "ms": ms, "equal": same})
        log(f"[sharded season] 20 races x {n} sims over {w} shards on {dev}: bitwise equal to "
            f"one K2 launch: {same}; {ms:.3f} ms (one launch {season_ms:.3f} ms)")
        if not same:
            raise AssertionError(f"the season split over {w} shards departs from one launch")
    mesh = shard_mesh(dev, SEASON_SHARDS[-1])
    single = bt.simulate_season_plans(predictor, plans, season_seed, int(SEASON_SIMS))
    split, wall, k1, k2 = run_counted(rk, lambda: bt.simulate_season_plans(
        predictor, plans, season_seed, int(SEASON_SIMS), mesh=mesh))
    launches = rk.season_counts_sharded.launches
    same = all(np.array_equal(a, b) for a, b in zip(single, split))
    log(f"[sharded season path] simulate_season_plans on {mesh.size} shards, {SEASON_SIMS} sims per "
        f"race: sharded K2 launches {launches}, K2 launches {k2}, K1 launches {k1}; equal to the "
        f"single launch's result: {same}; wall {wall:.3f} s; phase {time.perf_counter() - t0:.1f} s")
    if (launches, k2, k1) != (1, mesh.size, 0) or not same:
        raise AssertionError("the sharded season path did not take one K2 launch per shard")
    sharded["launches"] = launches
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
        "golden": golden_cells == 0,
        "golden_cells_differ": golden_cells,
        **kernel_facts(dev, d, season=True),
    }, sharded, one


def wide_kernel_phases(dev) -> list[dict]:
    """K1 at 40, 80 and 128 drivers against its plain version (and
    determinism and launch shapes at 80), timed beside its bound and its
    plain version; then K1 at 40 drivers against the native oracle. Returns
    K1's wide readings."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.profile_kernel import overtake_passes
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
        with overtake_passes() as races:
            plain, plain_ms = plain_ms_of(
                lambda: rk.race_counts_plain(pmat, scal, grid_log, WIDE_LAPS, n, seed=0))
        (passes,) = pass_counts(races)
        err_t = max_prob_err(kernel, plain, n)
        bound_ms, bound_by = bound(race_flops(d, WIDE_LAPS, n, passes), race_bytes(d))
        warps, blocks = rk.launch_shape(dev, d)
        log(f"[wide kernel shape] D={d}, {WIDE_LAPS} laps, {n} sims: kernel {ms:.3f} ms "
            f"({warps} warps x {blocks} blocks, {rk.blocks_per_sm(dev.index or 0, d, warps, False)} "
            f"blocks per SM), plain {plain_ms:.1f} ms, max |dprob| {err_t:.3e}; "
            f"{pass_shares(passes, [WIDE_LAPS], n)} (plain version); roofline bound "
            f"{bound_ms:.3f} ms ({bound_by}); phase {time.perf_counter() - t0:.1f} s")
        if not err_t <= MAX_ABS_PROB_ERR:
            raise AssertionError(f"K1 disagrees with its plain version at {d} drivers, {n} sims")
        rows.append({"d": d, "laps": WIDE_LAPS, "sims": n, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": max(err, err_t),
                     **kernel_facts(dev, d, season=False)})

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
    from monte_carlo_gp_torch.profile_kernel import overtake_passes
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
    with overtake_passes() as races:
        plain, plain_ms = plain_ms_of(
            lambda: rk.season_counts_plain(pmat_s, scal_s, grid_log_s, laps, n, seeds))
    passes = pass_counts(races)
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
    bound_ms, bound_by = bound(sum(race_flops(w, lp, n, p) for w, lp, p in zip(widths, laps, passes)),
                               len(laps) * (race_bytes(d) + 8 + 4))
    shares = pass_shares(tuple(map(sum, zip(*passes))), laps, n)
    log(f"[wide season kernel] D={d}: vs plain max |dprob| {err:.3e} (bound {MAX_ABS_PROB_ERR}); "
        f"the path's result is K2's counts: {path_equal}; race r equals K1 at fold_in(seed, r): "
        f"{sum(singles)} of {len(laps)}; default vs 4 warps x 37 blocks per race: {shaped}; "
        f"K2 {ms:.3f} ms, plain {plain_ms:.1f} ms; {shares} (plain version); roofline bound "
        f"{bound_ms:.3f} ms ({bound_by}); phase {time.perf_counter() - t0:.1f} s")
    if not (err <= MAX_ABS_PROB_ERR and real_rows and path_equal and all(singles) and shaped):
        raise AssertionError("the wide season launch disagrees with its plain version or K1")
    return {"d": d, "widths": widths, "laps": laps, "launches": k2, "sims_per_race": n,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "max_abs_err": err, **kernel_facts(dev, d, season=True)}


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
    real_engine = predictor_mod.run_monte_carlo_sharded

    def engine_spy(params, *args, **kwargs):
        engine_devices.append(params.device.type)
        return real_engine(params, *args, **kwargs)

    predictor_mod.run_monte_carlo_sharded = engine_spy
    launches = {}
    try:
        for d in WEEKEND_WIDTHS:
            plan = wide_plan(d, dev)
            engine_devices.clear()
            engine.engine_counts.calls = 0
            result, wall, k1, k2 = run_counted(rk, lambda: predictor.assemble_result(
                plan, predictor.simulate_plan(plan, WEEKEND_SIMS, seed=0)))
            calls = engine.engine_counts.calls
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
        predictor_mod.run_monte_carlo_sharded = real_engine
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


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def sharded_kernel_phase(dev, predictor, plan, main_counts, plain_counts, plain_ms, passes,
                         golden_cells: int) -> dict:
    """K1 split over 1, 2, 3 and 4 shards on the card at the main shape,
    each bitwise equal to one launch and timed beside one shard's launch;
    then the weekend through `simulate_plan` on a mesh of 4 shards. Returns
    the sharded entry of the kernels line (its bound from the main shape's
    overtake `passes`, with `golden_cells` from the golden phase)."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.parallel.mesh import shard_range

    t0 = time.perf_counter()
    laps, d = plan.total_laps, plan.params.n_drivers
    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(dev))
    rows = []
    for w in MAIN_SHARDS:
        mesh = shard_mesh(dev, w)
        run = lambda: rk.race_counts_sharded(pmat, scal, grid_log, laps, MAIN_SIMS, seed=0, mesh=mesh)
        counts = run()
        same = torch.equal(counts, main_counts)
        ms = time_kernel_ms(run)
        lo, hi = shard_range(MAIN_SIMS, w, 0)
        shard_ms = time_kernel_ms(
            lambda: rk.race_counts(pmat, scal, grid_log, laps, hi - lo, seed=0, sim_offset=lo))
        rows.append({"shards": w, "ms": ms, "shard_ms": shard_ms, "equal": same})
        log(f"[sharded kernel] D={d}, {laps} laps, {MAIN_SIMS} sims over {w} shard(s) on {dev}: "
            f"bitwise equal to one launch: {same}; {ms:.3f} ms, one shard's launch of {hi - lo} "
            f"sims {shard_ms:.3f} ms")
        if not same:
            raise AssertionError(f"K1 split over {w} shards departs from one launch")
    err = max_prob_err(counts, plain_counts, MAIN_SIMS)

    mesh = shard_mesh(dev, MAIN_SHARDS[-1])
    probs, wall, k1, k2 = run_counted(
        rk, lambda: predictor.simulate_plan(plan, MAIN_SIMS, seed=0, mesh=mesh))
    launches = rk.race_counts_sharded.launches
    same = np.array_equal(probs, (main_counts.float() / MAIN_SIMS).cpu().numpy())
    log(f"[sharded weekend path] simulate_plan on {mesh.size} shards: sharded K1 launches "
        f"{launches}, K1 launches {k1}, K2 {k2}; equal to the single launch's result: {same}; "
        f"wall {wall:.3f} s; phase {time.perf_counter() - t0:.1f} s")
    if (launches, k1, k2) != (1, mesh.size, 0) or not same:
        raise AssertionError("the sharded weekend did not take one K1 launch per shard")
    # K1's work and inputs, and one all-reduce of the (D, D) int32 counts
    bound_ms, bound_by = bound(race_flops(d, laps, MAIN_SIMS, passes), race_bytes(d) + d * d * 4)
    log(f"[sharded kernel] roofline bound {bound_ms:.3f} ms ({bound_by})")
    return {
        "name": "race_counts_sharded",
        "route": "cuda",
        "source": "monte_carlo_gp_torch/csrc/race_kernel.cu",
        "replaces": "monte_carlo_gp_tpu/ops/pallas_engine.py:1114",
        "also_replaces": "monte_carlo_gp_tpu/ops/pallas_engine.py:962-983",
        "launches": launches,
        "max_abs_err": err,
        "ms": rows[-1]["ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "golden": golden_cells == 0,
        "golden_cells_differ": golden_cells,
        **kernel_facts(dev, d, season=False),
        "shards": rows,
    }


def nccl_phase(dev, plan, main_counts) -> dict:
    """A one-rank NCCL group through `initialize_distributed`: its
    all-reduce passes the counts through, and the weekend's split path
    under the group gives the single launch's counts."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.parallel import distributed

    t0 = time.perf_counter()
    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(dev))
    if not distributed.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                                              backend="nccl", device=dev):
        raise AssertionError("initialize_distributed formed no group")
    try:
        counts = main_counts.clone()
        distributed.all_reduce_counts(counts)
        torch.cuda.synchronize()
        through = torch.equal(counts, main_counts)
        ms = time_kernel_ms(lambda: distributed.all_reduce_counts(counts), repeats=20)
        d = main_counts.shape[0]
        grouped = rk.race_counts_sharded(pmat, scal, grid_log, plan.total_laps, MAIN_SIMS,
                                         seed=0, mesh=shard_mesh(dev, 1))
        same = torch.equal(grouped, main_counts)
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    log(f"[nccl group] one rank, backend {backend}: the all-reduce passes the ({d}, {d}) int32 "
        f"counts through: {through}, {ms:.4f} ms each; the split weekend under the group equals "
        f"one launch: {same}; phase {time.perf_counter() - t0:.1f} s")
    if not (through and same and backend == "nccl"):
        raise AssertionError("the one-rank NCCL group changed the counts")
    return {"backend": backend, "ranks": 1, "allreduce_ms": ms}


def two_process_phase(dev, plan, main_counts) -> dict:
    """Two processes on the card joined by gloo through
    `parallel/dryrun.py` at the main shape: rank 0's probabilities bitwise
    equal to one launch's; the all-reduce's time on CUDA int32 counts."""
    t0 = time.perf_counter()
    work = SMOKE_CACHE / "two_process"
    work.mkdir(parents=True, exist_ok=True)
    fields = work / "main_params.npz"
    np.savez(fields, **{f: getattr(plan.params, f).cpu().numpy()
                        for f in plan.params.__dataclass_fields__})
    out = work / "probs.npy"
    addr = f"127.0.0.1:{free_port()}"
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "monte_carlo_gp_torch.parallel.dryrun", addr, "2", str(rank),
             str(out), "pallas", dev.type, "--backend", "gloo", "--sims", str(MAIN_SIMS),
             "--laps", str(plan.total_laps), "--seed", "0", "--params", str(fields)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for rank in range(2)
    ]
    try:
        outputs = [proc.communicate(timeout=TWO_PROCESS_TIMEOUT_S) for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for proc, (_, err) in zip(procs, outputs):
        if proc.returncode != 0:
            raise AssertionError(f"a dryrun rank failed ({proc.returncode}):\n{err[-3000:]}")
    report = json.loads(out.with_suffix(".json").read_text())
    same = np.array_equal(np.load(out), (main_counts.float() / MAIN_SIMS).cpu().numpy())
    log(f"[two processes] 2 ranks on the card, gloo on CUDA tensors, {MAIN_SIMS} sims: rank 0's "
        f"probabilities bitwise equal to one launch: {same}; run {report['run_s']:.3f} s; "
        f"all-reduce of the ({plan.params.n_drivers}, {plan.params.n_drivers}) int32 counts "
        f"{report['allreduce_ms']:.4f} ms; phase {time.perf_counter() - t0:.1f} s")
    if not same or report["backend"] != "gloo":
        raise AssertionError("the two-process run departs from one launch")
    return {"backend": "gloo", "ranks": 2, "tensors": "cuda int32", "run_s": report["run_s"],
            "allreduce_ms": report["allreduce_ms"]}


def xla_cli_phase(main_dist, batched_2024) -> None:
    """The weekend and the batched 2024 backtest through their CLIs with
    `--engine xla`: the lap engine, no race kernel launch, results within
    Monte Carlo tolerance of the kernel's."""
    from monte_carlo_gp_torch import backtest as backtest_cli
    from monte_carlo_gp_torch.__main__ import run as run_cli
    from monte_carlo_gp_torch.ops import engine
    from monte_carlo_gp_torch.ops import race_kernel as rk

    t0 = time.perf_counter()
    engine.engine_counts.calls = 0
    args = [*MAIN_ARGS, "--engine", "xla", "--cache-dir", str(SMOKE_CACHE / "xla_weekend")]
    args[args.index("--simulations") + 1] = str(XLA_WEEKEND_SIMS)
    (results, timers), wall, k1, k2 = run_counted(rk, lambda: run_cli(args))
    calls = engine.engine_counts.calls
    drivers = list(results["full_distributions"])
    dist = np.array([[results["full_distributions"][d].get(p + 1, 0.0) for p in range(20)]
                     for d in drivers])
    tv = tv_max(dist, main_dist)
    sim_s = timers.totals["simulate (Monte Carlo)"]
    log(f"[xla weekend] --engine xla, {XLA_WEEKEND_SIMS} sims: lap-engine calls {calls}, K1 "
        f"launches {k1}, K2 {k2}; simulate {sim_s:.3f} s ({XLA_WEEKEND_SIMS / sim_s:,.0f} sims/s); "
        f"max per-driver TV vs K1's 1,048,576-sim weekend {tv:.4f} (bound {ENGINE_TV}); "
        f"wall {wall:.3f} s")
    if (calls, k1, k2) != (1, 0, 0) or not tv < ENGINE_TV:
        raise AssertionError("the --engine xla weekend did not run on the lap engine")

    engine.engine_counts.calls = 0
    args = [*BACKTEST_ARGS, "--seasons", "2024", "--batched", "--engine", "xla",
            "--cache-dir", str(SMOKE_CACHE / "xla_backtest")]
    args[args.index("--simulations") + 1] = str(XLA_SEASON_SIMS)
    out, wall, k1, k2 = run_counted(rk, lambda: backtest_cli.run(args))
    calls = engine.engine_counts.calls
    log(f"[xla backtest] --engine xla --batched, 2024, {XLA_SEASON_SIMS} sims per race: races "
        f"{out['n_races']}; lap-engine runs {calls}, K1 launches {k1}, K2 {k2}; pole Brier "
        f"{out['pole_brier']:.6f} (K2 at {SEASON_SIMS} sims {batched_2024['pole_brier']:.6f}), "
        f"win Brier {out['win_brier']:.6f} (K2 {batched_2024['win_brier']:.6f}); wall {wall:.3f} s; "
        f"phase {time.perf_counter() - t0:.1f} s")
    if (k1, k2) != (0, 0) or calls != out["n_races"] or out["n_races"] != batched_2024["n_races"]:
        raise AssertionError("the --engine xla backtest did not run on the lap engine")
    if out["pole_brier"] != batched_2024["pole_brier"] or not (
            abs(out["win_brier"] - batched_2024["win_brier"]) <= WIN_BRIER_ATOL):
        raise AssertionError("the lap-engine backtest disagrees with the season kernel's")


def percentile_ms(seconds: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(seconds) * 1e3, q))


def cpu_fit(design_path: str, out_path: str) -> None:
    """The CPU reference fit of `bayes_phase`, in a process of its own so
    that it runs beside the card's fits: the pickled (design, seed) in, the
    pickled (posterior, seconds) out, at 2 threads (~10^5 small ops, which
    more threads only slow down)."""
    import pickle

    from monte_carlo_gp_torch.models import bayesian as B

    torch.set_num_threads(2)
    with open(design_path, "rb") as f:
        design, seed = pickle.load(f)
    t0 = time.perf_counter()
    post = B.sample_posterior(design, seed=seed, device="cpu")
    with open(out_path, "wb") as f:
        pickle.dump((post, time.perf_counter() - t0), f)


def start_cpu_fit(design, seed: int):
    """Start `cpu_fit` of (design, seed) in a child process; returns (the
    process, the path its result will be pickled to)."""
    import pickle

    work = SMOKE_CACHE / "cpu_fit"
    work.mkdir(parents=True, exist_ok=True)
    design_path, out_path = work / "design.pkl", work / "posterior.pkl"
    with open(design_path, "wb") as f:
        pickle.dump((design, seed), f)
    code = f"import chip_smoke; chip_smoke.cpu_fit({str(design_path)!r}, {str(out_path)!r})"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT,
                            env={**os.environ, "PYTHONPATH": str(ROOT)})
    return proc, out_path


def hmc_flops(n: int, k: int, chains: int, n_leapfrog: int) -> int:
    """float32 operations of one HMC transition of `chains` chains over n
    rows and k effect columns, counted from `csrc/hmc_kernel.cu` (an exp, a
    sqrt or a division as one; the warp trees' adds not counted):
      * per gradient: 5 per row (three adds, the square and its sum), 3 per
        row for its three column sums, 10 per effect column (its gradient 7,
        the next effect 3), 5 per parameter (the momentum and position
        updates) and 25 for the scalars;
      * per transition: n_leapfrog + 1 gradients, the momentum (2 per
        parameter), the two kinetic energies (3 per parameter each), logp
        (2 per effect column and 20) and the accept (10)."""
    dim = 5 + k
    per_gradient = 8 * n + 10 * k + 5 * dim + 25
    return chains * ((n_leapfrog + 1) * per_gradient + 8 * dim + 2 * k + 30)


def hmc_bytes(n: int, k: int, chains: int) -> int:
    """The design read once (16 B a row; the column lists, 4 B per entry and
    per start) and one transition's inputs read and outputs written once:
    theta, inv_mass and z in and theta' out, (chains, 5 + k) float32; lp,
    eps, u_jit and u_acc in and lp' and alpha out, (chains,)."""
    return 16 * n + 4 * (3 * n + k + 1) + 4 * chains * (4 * (5 + k) + 6)


def hmc_times(dev, kd, state: dict, n_leapfrog: int) -> dict:
    """ms per call at one recorded state, taken in turns (graph, kernel,
    kernel, graph): the kernel's launch, the captured graph's replay of the
    eager transition (its inputs copied in, as in a graphed fit); then the
    eager transition on the card, the plain version."""
    from monte_carlo_gp_torch.models import bayesian as B
    from monte_carlo_gp_torch.ops import hmc_kernel as H

    args = [state[k] for k in ("theta", "lp", "eps", "inv_mass", "z", "u_jit", "u_acc")]
    times = {"graph": [], "kernel": []}
    with torch.inference_mode():
        graphed = B.GraphedTransition(kd.logp_fn, kd.grad_fn, n_leapfrog, *args[0].shape, dev)
        try:
            calls = {"graph": lambda: graphed(*args),
                     "kernel": lambda: H.hmc_transition(kd, *args, n_leapfrog)}
            for name in ("graph", "kernel", "kernel", "graph"):
                times[name].append(time_kernel_ms(calls[name], HMC_TIME_CALLS))
        finally:
            graphed.close()
        plain = time_kernel_ms(lambda: H.hmc_transition_plain(
            *args[:4], kd.logp_fn, kd.grad_fn, n_leapfrog, *args[4:]), HMC_PLAIN_CALLS)
    return {"kernel_ms": times["kernel"], "graph_ms": times["graph"], "plain_ms": plain}


def bayes_phase(dev, design, cpu_run) -> dict:
    """(a) The Bayesian qualifying model on the card: the weekend's plan
    through `F1Predictor(quali_model="bayesian")`, whose HMC fit of the
    synthetic archive (Bahrain 2024, `design`) runs on the card at the
    default budget, every transition one launch of the HMC kernel (2,000
    launches, 2 logp launches, no graph replay); three more kernel fits of
    the same seed, bitwise equal to it, the first recording states at which
    the kernel is held to the plain version per call and per transition
    (`validate/hmc.py`); the same seed's eager fit on the card (the plain
    version) and three graphed fits (`sample_posterior_graphed`, the
    yardstick), the first bitwise the eager fit in `raw` and `accept_rate`,
    all three bitwise equal, the device memory reserved at their peak not
    growing after the first; the kernel's ms per launch and the graph's per
    transition in turns at a sampled state; the CPU fit of the same seed
    that `cpu_run` (`start_cpu_fit`) ran meanwhile; the kernel fit's pole
    distribution within total variation 0.05 of the CPU fit's and of the
    graphed fit's; then the weekend's Monte Carlo through K1 at the server's
    default count, the in-process result the Bayesian server is held to.
    Returns the readings, that result (`result`) and the kernels line's
    `hmc_transition` entry (`kernel`)."""
    import pickle
    import zlib

    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import bayesian as B
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.ops import hmc_kernel as H
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.utils.profiling import Phase, timed_calls
    from monte_carlo_gp_torch.validate import hmc

    t0 = time.perf_counter()
    predictor = F1Predictor(cache_dir=SMOKE_CACHE / "bayes", backend=SyntheticBackend(seed=2718),
                            device=dev, quali_model="bayesian")
    model = predictor._bayes_model
    iters = model.num_warmup + model.num_samples
    timers = Phase()
    with timed_calls(B, "sample_posterior", timers):
        H.hmc_transition.launches = H.hmc_logp.launches = B.transition_replays = 0
        plan, prepare_ms = plain_ms_of(lambda: predictor.prepare_weekend(2024, "Bahrain"))
        launches = (H.hmc_transition.launches, H.hmc_logp.launches, B.transition_replays)
    fit_s = timers.totals["sample_posterior"]
    post = model._posterior
    if not all(np.array_equal(getattr(post.design, f), getattr(design, f))
               for f in design.__dataclass_fields__):
        raise AssertionError("the predictor fitted another archive than the CPU reference's")

    def fit(**kw):
        return plain_ms_of(lambda: B.sample_posterior(design, seed=model.seed, device=dev, **kw))

    def equal(a, b) -> bool:
        return np.array_equal(a.raw, b.raw) and np.array_equal(a.accept_rate, b.accept_rate)

    with hmc.recorded_transitions(HMC_RECORD_AT) as states:
        again, again_ms = fit()
    again_s, same = [again_ms / 1e3], equal(post, again)
    for _ in range(2):
        again, again_ms = fit()
        again_s.append(again_ms / 1e3)
        same = same and equal(post, again)
    kd = B.kernel_design(design, dev)
    check = hmc.kernel_vs_plain(kd, states, BAYES_LEAPFROG)

    eager, eager_ms = fit(plain=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    graphed, graph_s, peaks, replays = [], [], [], []
    for _ in range(3):
        B.transition_replays = 0
        g, ms = plain_ms_of(lambda: B.sample_posterior_graphed(design, seed=model.seed, device=dev))
        graphed.append(g)
        graph_s.append(ms / 1e3)
        peaks.append(torch.cuda.max_memory_reserved(dev))
        replays.append(B.transition_replays)
    graph_is_eager = equal(graphed[0], eager)
    graphs_same = all(equal(g, graphed[0]) for g in graphed[1:])
    times = hmc_times(dev, kd, states[-1], BAYES_LEAPFROG)

    proc, out_path = cpu_run
    if proc.wait(timeout=SERVE_TIMEOUT_S) != 0:
        raise AssertionError(f"the CPU reference fit failed ({proc.returncode})")
    with open(out_path, "rb") as f:
        cpu, cpu_s = pickle.load(f)
    rhat = float(B.split_rhat(post.raw).max())
    circuit = predictor.data_loader._resolve_event(2024, "Bahrain")
    q_laps = predictor.feature_engine.laps
    teams = q_laps[q_laps["session_type"] == "Q"].groupby("Driver", sort=False)["Team"].last().to_dict()
    seed = zlib.crc32(f"2024:{circuit}".encode())

    def pole_tv(other) -> float:
        a = B.quali_position_probs(post, plan.drivers, teams, circuit, seed)
        b = B.quali_position_probs(other, plan.drivers, teams, circuit, seed)
        return 0.5 * sum(abs(a[d][0] - b[d][0]) for d in plan.drivers)

    tv, tv_graph = pole_tv(cpu), pole_tv(graphed[0])
    grid = np.array([plan.quali_probs[d] for d in plan.drivers])
    result, wall, k1, k2 = run_counted(rk, lambda: predictor.assemble_result(
        plan, predictor.simulate_plan(plan, SERVE_SIMS, seed=SERVE_SEED)))
    eager_s = eager_ms / 1e3
    kernel_ms = float(np.mean(times["kernel_ms"]))
    graph_ms = float(np.mean(times["graph_ms"]))
    n, k, chains = kd.n_rows, kd.n_cols, post.raw.shape[0]
    bound_ms, bound_by = bound(hmc_flops(n, k, chains, BAYES_LEAPFROG), hmc_bytes(n, k, chains))
    facts = H.ptxas_facts(H.build().with_suffix(".log").read_text())
    blocks = H.blocks_per_sm(dev, n, k)
    log(f"[bayes fit] synthetic archive before Bahrain 2024: {n} rows, {k} effect columns, "
        f"{post.raw.shape[2]} parameters; {chains} chains x {iters} iterations x {BAYES_LEAPFROG} "
        f"leapfrog steps on {dev}: kernel fit {fit_s:.3f} s ({fit_s / iters * 1e3:.4f} ms per "
        f"iteration; HMC kernel launches {launches[0]}, logp launches {launches[1]}, graph replays "
        f"{launches[2]}) inside the Bayesian weekend's prepare of {prepare_ms / 1e3:.3f} s; three "
        f"kernel fits again {', '.join(f'{x:.3f}' for x in again_s)} s, bitwise equal {same}")
    log(f"[bayes kernel] one launch per transition: {', '.join(f'{x:.4f}' for x in times['kernel_ms'])} "
        f"ms (kernel turns; {HMC_TIME_CALLS} launches each, CUDA events) against the graph's "
        f"{', '.join(f'{x:.4f}' for x in times['graph_ms'])} ms per transition (graph turns) and "
        f"the eager transition's {times['plain_ms']:.3f} ms, at iteration {HMC_RECORD_AT[-1]}'s "
        f"state; an iteration of the kernel fit {fit_s / iters * 1e3:.4f} ms of wall beside "
        f"{kernel_ms:.4f} ms of launch; bound {bound_ms * 1e3:.4f} us ({bound_by}); "
        f"{facts.get('registers')} registers, {facts.get('spill_stores')} B spill stores, "
        f"{H.shared_bytes(n, k)} B shared memory, {blocks} block(s) of {H.THREADS} threads "
        f"resident per SM; against the plain version at {check['states']} recorded states "
        f"({check['chains']} chain-transitions): max |dlogp| {check['logp']:.3e}, max |dgrad| "
        f"{check['grad']:.3e}, max |dtheta'| {check['theta']:.3e}, max |dlp'| {check['lp']:.3e}, "
        f"max |dalpha| {check['alpha']:.3e}, accept decisions differing {check['decisions_differ']} "
        f"({check['decisions_differ_outside_margin']} outside |u - alpha| <= {hmc.ALPHA_MARGIN}); "
        f"within rtol {hmc.RTOL}, atol {hmc.ATOL} (theta' atol {hmc.THETA_ATOL}): {check['ok']}")
    log(f"[bayes graph] the eager fit of the same seed on the card {eager_s:.3f} s "
        f"({eager_s / iters * 1e3:.3f} ms per transition); three graphed fits "
        f"{', '.join(f'{x:.3f}' for x in graph_s)} s (replays {replays}), the first bitwise the "
        f"eager fit (raw and accept_rate): {graph_is_eager}, all bitwise equal {graphs_same}, max "
        f"memory reserved after each {peaks} B; on the CPU {cpu_s:.3f} s (2 threads, in a process "
        f"beside the card's fits); acceptance {np.round(post.accept_rate, 4).tolist()}, max split "
        f"R-hat {rhat:.4f}; pole TV kernel vs CPU {tv:.4f}, kernel vs graph {tv_graph:.4f} (bound "
        f"{BAYES_POLE_TV}); the weekend's grid rows sum to 1: "
        f"{np.allclose(grid.sum(axis=1), 1.0, atol=1e-6)}; K1 launches {k1}, K2 {k2} at "
        f"{SERVE_SIMS} sims; phase {time.perf_counter() - t0:.1f} s")
    lo, hi = BAYES_ACCEPT
    if launches != (iters, 2, 0):
        raise AssertionError(f"the Bayesian weekend's fit did not run through the HMC kernel: "
                             f"(launches, logp launches, graph replays) {launches}")
    if not (same and check["ok"]):
        raise AssertionError("the HMC kernel is not reproducible or departs from its plain version")
    if not (graph_is_eager and graphs_same and replays == [iters] * 3):
        raise AssertionError("the graphed fit is not the eager fit replayed through its graph")
    if max(peaks[1:]) > peaks[0]:
        raise AssertionError(f"the device memory reserved grew over graphed fits: {peaks}")
    if not (np.isfinite(post.raw).all() and tv < BAYES_POLE_TV and tv_graph < BAYES_POLE_TV
            and np.all((post.accept_rate > lo) & (post.accept_rate < hi))
            and np.allclose(grid.sum(axis=1), 1.0, atol=1e-6) and (k1, k2) == (1, 0)):
        raise AssertionError("the Bayesian fit on the card failed a check")
    kernel = {
        "name": "hmc_transition",
        "route": "cuda",
        "source": "monte_carlo_gp_torch/csrc/hmc_kernel.cu",
        "replaces": "monte_carlo_gp_tpu/models/bayesian.py:262",
        "replaces_what": "_leapfrog (:247-259) and _hmc_transition (:262-284), computed by XLA "
                         "with no Pallas kernel",
        "launches": launches[0],
        "launches_by_path": {"bayesian weekend": launches[0], "logp entry": launches[1]},
        "max_abs_err": check["theta"],
        "max_abs_err_of": {k: check[k] for k in ("logp", "grad", "theta", "lp", "alpha")},
        "decisions_differ": check["decisions_differ"],
        "ms": kernel_ms,
        "ms_turns": times["kernel_ms"],
        "graph_ms": graph_ms,
        "graph_ms_turns": times["graph_ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
        "fit_s": fit_s,
        "ms_per_iteration": fit_s / iters * 1e3,
        **facts,
        "shared_bytes": H.shared_bytes(n, k),
        "threads_per_block": H.THREADS,
        "blocks_per_sm": blocks,
        "rows": n,
    }
    return {"rows": n, "dim": int(post.raw.shape[2]), "fit_s": fit_s,
            "s_per_iteration": fit_s / iters, "launches": list(launches),
            "prepare_s": prepare_ms / 1e3, "again_s": again_s, "eager_s": eager_s,
            "eager_s_per_transition": eager_s / iters, "graph_s": graph_s,
            "graph_replays": replays, "graphed_equals_eager": graph_is_eager,
            "max_memory_reserved": peaks, "cpu_s": cpu_s, "accept": post.accept_rate.tolist(),
            "rhat": rhat, "pole_tv_vs_cpu": tv, "pole_tv_vs_graph": tv_graph,
            "result": result, "kernel": kernel}


def _read_ready(proc, deadline: float) -> tuple[str, list[str]]:
    """The server's base URL from its readiness line, and the lines before
    it; raises when it dies or the deadline passes."""
    import select

    lines = []
    while time.monotonic() < deadline:
        ready, _, _ = select.select([proc.stdout], [], [], 1.0)
        if not ready:
            if proc.poll() is not None:
                raise AssertionError(f"the server exited ({proc.returncode}) before serving")
            continue
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"the server closed its output ({proc.poll()}) before serving")
        lines.append(line.rstrip("\n"))
        if line.startswith("Serving on "):
            return line.split("Serving on ", 1)[1].strip(), lines
    raise AssertionError("the server printed no readiness line in time")


def _http(url: str, body: dict | None = None) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _probabilities(payload: dict) -> dict:
    """A response's or a result's probabilities, position keys as JSON has
    them."""
    return {k: json.loads(json.dumps(payload[k])) for k in (
        "pole_probabilities", "win_probabilities", "podium_probabilities", "full_distributions")}


def serve_phase(dev, quali_model: str, in_process: dict) -> dict:
    """(b) `python -m monte_carlo_gp_torch.serve --synthetic --port 0 --warm
    2024:Bahrain` on the card with `quali_model`: the readiness line, /healthz
    naming the card, 50 /predict requests at the default count and 10 at the
    main path's, p50/p95 latency and the plan-cache hits; two same-seed
    bodies byte-identical but for the server's latency, and their
    probabilities equal to `in_process` (the weekend through F1Predictor on
    the card in this process); then /invalidate and GET /."""
    t0 = time.perf_counter()
    work = SMOKE_CACHE / f"serve_{quali_model}"
    work.mkdir(parents=True, exist_ok=True)
    err_path = work / "server.log"
    cmd = [sys.executable, "-m", "monte_carlo_gp_torch.serve", "--synthetic", "--port", "0",
           "--warm", "2024:Bahrain", "--cache-dir", str(work / "cache"),
           "--quali-model", quali_model, "--device", dev.type]
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT)},
                                stdout=subprocess.PIPE, stderr=err, text=True, bufsize=1)
        try:
            base, startup = _read_ready(proc, time.monotonic() + SERVE_TIMEOUT_S)
            start_s = time.perf_counter() - t0
            warm = next((l for l in startup if l.startswith("warm 2024 Bahrain")), "")
            status, body = _http(f"{base}/healthz")
            health = json.loads(body)
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
            if status != 200 or health["platform"] != dev.type or health["device_name"] != name:
                raise AssertionError(f"/healthz does not name the card: {health}")
            lat, server_lat = {}, {}
            for label, sims, count in (("default", SERVE_SIMS, SERVE_REQUESTS),
                                       ("main", MAIN_SIMS, SERVE_BIG_REQUESTS)):
                lat[label], server_lat[label] = [], []
                for i in range(count):
                    q0 = time.perf_counter()
                    status, body = _http(f"{base}/predict", {
                        "season": 2024, "race": "Bahrain", "seed": i, "n_simulations": sims})
                    lat[label].append(time.perf_counter() - q0)
                    payload = json.loads(body)
                    if status != 200 or payload["server"]["n_simulations"] != sims:
                        raise AssertionError(f"/predict failed ({status}): {payload}")
                    server_lat[label].append(payload["server"]["latency_s"])
            same_seed = [json.loads(_http(f"{base}/predict", {
                "season": 2024, "race": "Bahrain", "seed": SERVE_SEED,
                "n_simulations": SERVE_SIMS})[1]) for _ in range(2)]
            for p in same_seed:
                p["server"].pop("latency_s")
            identical = json.dumps(same_seed[0]).encode() == json.dumps(same_seed[1]).encode()
            equal = _probabilities(same_seed[0]) == _probabilities(in_process)
            stats = json.loads(_http(f"{base}/stats")[1])
            evicted = json.loads(_http(f"{base}/invalidate", {"race": "Bahrain"})[1])["evicted"]
            page_status, page = _http(f"{base}/")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    reading = {"quali_model": quali_model, "startup_s": start_s, "warm": warm,
               "plan_cache_hits": stats["plan_cache_hits"], "requests": stats["requests"]}
    for label in lat:
        reading[f"{label}_p50_ms"] = percentile_ms(lat[label], 50)
        reading[f"{label}_p95_ms"] = percentile_ms(lat[label], 95)
        reading[f"{label}_server_p50_ms"] = percentile_ms(server_lat[label], 50)
    log(f"[serve {quali_model}] {' '.join(cmd[2:])}: ready in {start_s:.1f} s ({warm}); /healthz "
        f"{health['platform']} {health['device_name']}; {SERVE_REQUESTS} requests at {SERVE_SIMS} "
        f"sims: p50 {reading['default_p50_ms']:.2f} ms, p95 {reading['default_p95_ms']:.2f} ms "
        f"(server-side p50 {reading['default_server_p50_ms']:.2f} ms); {SERVE_BIG_REQUESTS} at "
        f"{MAIN_SIMS}: p50 {reading['main_p50_ms']:.2f} ms, p95 {reading['main_p95_ms']:.2f} ms "
        f"(server-side p50 {reading['main_server_p50_ms']:.2f} ms); plan-cache hits "
        f"{stats['plan_cache_hits']} of {stats['requests']} requests; same-seed bodies identical "
        f"but for the latency: {identical}; equal to the in-process weekend on the card: {equal}; "
        f"/invalidate evicted {evicted}; GET / {page_status} ({len(page)} bytes); phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not (identical and equal and evicted == 1 and page_status == 200
            and stats["ok"] == SERVE_REQUESTS + SERVE_BIG_REQUESTS + 2 and stats["errors"] == 0):
        raise AssertionError(f"the {quali_model} server failed a check (log: {err_path})")
    return reading


def gbm_phase(dev) -> str:
    """(c) The gradient-boosting qualifying model: a weekend through the CLI
    where scikit-learn imports; otherwise the CLI must exit with an error
    naming scikit-learn. Returns which of the two happened."""
    from monte_carlo_gp_torch.__main__ import run as run_cli

    t0 = time.perf_counter()
    args = [*MAIN_ARGS, "--quali-model", "gbm", "--cache-dir", str(SMOKE_CACHE / "gbm")]
    args[args.index("--simulations") + 1] = str(SERVE_SIMS)
    if importlib.util.find_spec("sklearn") is not None:
        results, _ = run_cli(args)
        pole = sum(results["pole_probabilities"].values())
        log(f"[gbm] scikit-learn imports: the weekend ran with --quali-model gbm on {dev}; pole "
            f"probabilities sum to {pole:.6f}; phase {time.perf_counter() - t0:.1f} s")
        if abs(pole - 1.0) > 1e-6:
            raise AssertionError("the gbm weekend's pole probabilities are not a distribution")
        return "ran"
    try:
        run_cli(args)
    except SystemExit as e:
        said = str(e.code)
    else:
        raise AssertionError("--quali-model gbm ran without scikit-learn")
    log(f"[gbm] scikit-learn is not installed: --quali-model gbm exits with {said!r}; phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not (said.startswith("Error:") and "scikit-learn" in said):
        raise AssertionError("--quali-model gbm did not exit naming scikit-learn")
    return "refused"


def alt_models_and_serving_phases(dev) -> dict:
    """Phases (a)-(c): the Bayesian fit, the server with the Elo and the
    Bayesian qualifying models, the gbm model. Returns their readings."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import bayesian as B
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.ops import race_kernel as rk

    t0 = time.perf_counter()
    elo = F1Predictor(cache_dir=SMOKE_CACHE / "serve_in_process", backend=SyntheticBackend(seed=2718),
                      device=dev)
    elo_result, _, k1, k2 = run_counted(rk, lambda: elo.predict_weekend(
        2024, "Bahrain", n_simulations=SERVE_SIMS, seed=SERVE_SEED))
    if (k1, k2) != (1, 0):
        raise AssertionError("the in-process weekend did not launch K1 once")
    # the archive the Bayesian predictor fits (the same world and clock)
    design = B.build_quali_design(elo.feature_engine.laps)
    cpu_run = start_cpu_fit(design, B.BayesianQualiModel().seed)
    try:
        bayes = bayes_phase(dev, design, cpu_run)
    finally:
        if cpu_run[0].poll() is None:
            cpu_run[0].kill()
            cpu_run[0].wait()
    serving = [serve_phase(dev, "elo", elo_result), serve_phase(dev, "bayesian", bayes.pop("result"))]
    gbm = gbm_phase(dev)
    log(f"[phase] the alternative qualifying models and the server: {time.perf_counter() - t0:.1f} s")
    return {"bayes": bayes, "serve": serving, "gbm": gbm}


def _precompile_event(stderr: str) -> dict:
    """The `precompile` event a child logged with MCGP_LOG_JSON=1."""
    for line in stderr.splitlines():
        if '"event": "precompile"' in line:
            return json.loads(line[line.index("{"):])
    raise AssertionError(f"the prebuild step logged no precompile event:\n{stderr[-2000:]}")


def _child(args: list[str], cache: str, timeout: float = PREBUILD_TIMEOUT_S):
    """(the completed `python -m <args>` in a child on the card with
    MCGP_COMPILE_CACHE=`cache`, its wall seconds)."""
    env = {**os.environ, "MCGP_COMPILE_CACHE": cache, "MCGP_LOG_JSON": "1",
           "PYTHONPATH": str(ROOT)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m {' '.join(args)} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
    return proc, wall


def prebuild_phase() -> dict:
    """Phase (d): `python -m monte_carlo_gp_torch.precompile` in a child with
    a fresh MCGP_COMPILE_CACHE builds both libraries and launches K1 and K2
    once; a weekend CLI in a second child with the same cache builds
    nothing; a weekend CLI with MCGP_COMPILE_CACHE=0 (a build directory of
    its own) is the cold first weekend it is compared with. Returns the
    readings, with the launches the prebuild child logged."""
    t0 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)
    cache = tempfile.mkdtemp(prefix="prebuild-", dir=ROOT / "build")
    try:
        proc, cold_s = _child(["monte_carlo_gp_torch.precompile", *PREBUILD_ARGS], cache)
        event = _precompile_event(proc.stderr)
        libs = sorted(p.name for p in (Path(cache) / "kernels").glob("*.so"))
        log(f"[prebuild] {proc.stdout.strip()}; child wall {cold_s:.2f} s; libraries {libs}; "
            f"K1 launches {event['k1_launches']}, K2 {event['k2_launches']}")
        if (event["libraries"], event["programs"], len(libs)) != (2, 2, 2) or (
                event["k1_launches"], event["k2_launches"]) != (1, 1):
            raise AssertionError("the prebuild step did not build the race and HMC libraries "
                                 "and launch K1 and K2")
        weekend = ["monte_carlo_gp_torch", *PREBUILD_WEEKEND_ARGS,
                   "--cache-dir", str(SMOKE_CACHE / "prebuild_weekend")]
        warm, warm_s = _child(weekend, cache)
        after = sorted(p.name for p in (Path(cache) / "kernels").glob("*.so"))
        rate = [line.strip() for line in warm.stdout.splitlines() if "sims/sec" in line]
        if not rate or BUILD_NOTE in rate[0] or after != libs:
            raise AssertionError(f"the weekend after the prebuild step built the kernels: {rate}")
        weekend[weekend.index("--cache-dir") + 1] = str(SMOKE_CACHE / "cold_weekend")
        cold, cold_weekend_s = _child(weekend, "0")
        cold_rate = [line.strip() for line in cold.stdout.splitlines() if "sims/sec" in line]
        if not cold_rate or BUILD_NOTE not in cold_rate[0]:
            raise AssertionError(f"the weekend with MCGP_COMPILE_CACHE=0 did not build: {cold_rate}")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log(f"[prebuild] first weekend after the prebuild step: wall {warm_s:.2f} s ({rate[0]}); "
        f"a cold first weekend (MCGP_COMPILE_CACHE=0): wall {cold_weekend_s:.2f} s "
        f"({cold_rate[0]}); the step itself {cold_s:.2f} s; phase {time.perf_counter() - t0:.1f} s")
    return {"prebuild_s": cold_s, "warm_weekend_s": warm_s, "cold_weekend_s": cold_weekend_s,
            "k1_launches": event["k1_launches"], "k2_launches": event["k2_launches"]}


def trace_phase(dev) -> dict:
    """Phase (e): the main path's weekend through the CLI with `--trace DIR`
    and without, in this process: bitwise equal results, a trace file that
    holds K1 as a device event, the device's busy share of the weekend and
    K1's device time from the trace (`device_times_us`)."""
    from monte_carlo_gp_torch.__main__ import run as run_cli
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.utils import profiling

    t0 = time.perf_counter()
    trace_dir = SMOKE_CACHE / "trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    kept = []
    real_trace = profiling.trace

    @contextlib.contextmanager
    def keep(*args, **kwargs):
        with real_trace(*args, **kwargs) as t:
            kept.append(t)
            yield t

    def args_for(cache: str) -> list[str]:
        args = list(MAIN_ARGS)
        args[args.index("--cache-dir") + 1] = str(SMOKE_CACHE / cache)
        return args

    profiling.trace = keep
    try:
        (traced, timers), wall, k1, k2 = run_counted(
            rk, lambda: run_cli(args_for("trace_on") + ["--trace", str(trace_dir)]))
    finally:
        profiling.trace = real_trace
    (untraced, _), _, k1_off, _ = run_counted(rk, lambda: run_cli(args_for("trace_off")))
    (t,) = kept
    same = traced["full_distributions"] == untraced["full_distributions"]
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    k1_events = [e for e in events if e.get("cat") == "kernel" and "race_kernel" in e.get("name", "")]
    kernel_us, device_us = profiling.device_times_us(t.profile)
    top = ", ".join(f"{name[:40]} {us / 1e3:.3f} ms" for name, us in
                    profiling.device_time_by_name(t.profile))
    weekend_s = timers.totals["prepare (data + Elo + features)"] + timers.totals["simulate (Monte Carlo)"]
    busy = device_us / 1e6 / weekend_s
    log(f"[trace] --trace {trace_dir.name}/: {t.path.name}, {t.path.stat().st_size:,} bytes, "
        f"{t.device_events} device events, {len(k1_events)} K1 kernel event(s); K1 launches {k1} "
        f"(untraced {k1_off}), K2 {k2}; K1 device {kernel_us / 1e3:.3f} ms of {device_us / 1e3:.3f} "
        f"ms device work; the weekend (prepare + simulate) {weekend_s:.3f} s, device busy "
        f"{100 * busy:.2f}%; device time by event: {top}; traced and untraced results bitwise equal: {same}; wall {wall:.2f} s; "
        f"phase {time.perf_counter() - t0:.1f} s")
    if not same:
        raise AssertionError("the traced weekend's result differs from the untraced one")
    if (k1, k2, k1_off) != (1, 0, 1) or not k1_events or kernel_us <= 0:
        raise AssertionError("the trace does not hold K1 as a device event")
    return {"k1_launches": k1, "k1_device_ms": kernel_us / 1e3, "device_ms": device_us / 1e3,
            "busy_share": busy, "trace_bytes": t.path.stat().st_size}


def walkthrough_phase(dev) -> dict:
    """Phase (f): `python -m monte_carlo_gp_torch.examples.weekend_walkthrough`
    on the card at its default count, in this process: it returns, prints
    its four sections and a line per race, and launches K1 once for each of
    its three weekends (its season runs on the lap engine, as the JAX
    example's does)."""
    from monte_carlo_gp_torch.examples import weekend_walkthrough
    from monte_carlo_gp_torch.ops import engine
    from monte_carlo_gp_torch.ops import race_kernel as rk

    t0 = time.perf_counter()
    out = io.StringIO()
    engine.engine_counts.calls = 0
    with contextlib.redirect_stdout(out):
        _, wall, k1, k2 = run_counted(rk, lambda: weekend_walkthrough.main(
            ["--device", "cuda", "--cache-dir", str(SMOKE_CACHE / "walkthrough")]))
    text = out.getvalue()
    calls = engine.engine_counts.calls
    missing = [s for s in WALKTHROUGH_SECTIONS if s not in text]
    log(f"[walkthrough] sections missing {missing}; {text.count(' predicted ')} race lines; K1 "
        f"launches {k1}, K2 {k2}, lap-engine calls {calls}; wall {wall:.2f} s; phase "
        f"{time.perf_counter() - t0:.1f} s")
    log(text.rstrip())
    if missing or text.count(" predicted ") != WALKTHROUGH_RACES or (k1, k2) != (3, 0) or calls < 1:
        raise AssertionError("the walkthrough did not run its four steps on the card")
    return {"k1_launches": k1, "k2_launches": k2, "engine_calls": calls, "wall_s": wall}


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
    from monte_carlo_gp_torch.profile_kernel import overtake_passes
    from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle

    # ---- build: one nvcc per source, started together ------------------------
    from concurrent.futures import ThreadPoolExecutor

    from monte_carlo_gp_torch.ops import hmc_kernel

    t0 = time.perf_counter()
    how = {m.__name__: "found built" if m.is_built() else "compiled" for m in (rk, hmc_kernel)}
    with ThreadPoolExecutor(2) as pool:
        libs = {m.__name__: pool.submit(m.build) for m in (rk, hmc_kernel)}
        libs = {name: f.result() for name, f in libs.items()}
    log("[build] " + "; ".join(f"{lib.name} {how[name]}" for name, lib in libs.items())
        + f" in {time.perf_counter() - t0:.2f} s")
    for lib in libs.values():
        log(lib.with_suffix(".log").read_text().strip())

    # ---- the golden counts: bitwise what the kernels gave before -------------
    golden = golden_phase(dev)

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
    (results, timers), wall, launches, k2 = run_counted(rk, lambda: run_cli(MAIN_ARGS))
    sharded_launches = rk.race_counts_sharded.launches
    dist = np.array([[results["full_distributions"][d].get(p + 1, 0.0) for p in range(20)]
                     for d in plan.drivers])
    prep_s = timers.totals["prepare (data + Elo + features)"]
    sim_s = timers.totals["simulate (Monte Carlo)"]
    log(f"[main path] K1 launches {launches} through {sharded_launches} call(s) of the sharded "
        f"entry on the one-shard default mesh, K2 {k2}; prepare {prep_s:.3f} s; simulate "
        f"{sim_s:.3f} s ({MAIN_SIMS / sim_s:,.0f} sims/s); wall {wall:.2f} s; "
        f"n_simulations_effective {results['n_simulations_effective']}")
    if (launches, sharded_launches, k2) != (1, 1, 0):
        raise AssertionError("the main path did not launch the race kernel once")
    if not (dist.shape == (20, 20) and np.isfinite(dist).all()
            and np.allclose(dist.sum(axis=1), 1.0, atol=1e-5)
            and results["n_simulations_effective"] == MAIN_SIMS):
        raise AssertionError("main path result is not 20 finite probability rows")

    # ---- kernel and plain times at the main path's shape ---------------------
    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(dev))
    run_kernel = lambda: rk.race_counts(pmat, scal, grid_log, plan.total_laps, MAIN_SIMS, seed=0)
    kernel_ms = time_kernel_ms(run_kernel)
    main_counts = run_kernel()
    with overtake_passes() as races:
        plain_counts, plain_ms = plain_ms_of(lambda: rk.race_counts_plain(
            pmat, scal, grid_log, plan.total_laps, MAIN_SIMS, seed=0))
    (main_passes,) = pass_counts(races)
    main_err = max_prob_err(main_counts, plain_counts, MAIN_SIMS)
    log(f"[main shape] D=20, {plan.total_laps} laps, {MAIN_SIMS} sims: kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, max |dprob| {main_err:.3e} (bound {MAX_ABS_PROB_ERR})")
    if not main_err <= MAX_ABS_PROB_ERR:
        raise AssertionError("kernel disagrees with its plain version at the main path's shape")
    if not np.allclose(main_counts.cpu().numpy() / MAIN_SIMS, dist, rtol=0, atol=1e-6):
        raise AssertionError("the main path's result is not the kernel's counts")

    d = plan.params.n_drivers
    bound_ms, bound_by = bound(race_flops(d, plan.total_laps, MAIN_SIMS, main_passes), race_bytes(d))
    log(f"[main shape] {pass_shares(main_passes, [plan.total_laps], MAIN_SIMS)} (plain version); "
        f"roofline bound {bound_ms:.3f} ms ({bound_by})")
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
        "golden": golden["race_counts"] == 0,
        "golden_cells_differ": golden["race_counts"],
        **kernel_facts(dev, d, season=False),
    }

    t0 = time.perf_counter()
    laps, k2, sharded_season, batched_2024 = season_phases(dev, golden["season_counts"])
    log(f"[phase] the season paths: {time.perf_counter() - t0:.1f} s")

    sharded = sharded_kernel_phase(dev, predictor, plan, main_counts, plain_counts, plain_ms,
                                   main_passes, golden["race_counts_sharded"])
    sharded["season"] = sharded_season
    sharded["nccl"] = nccl_phase(dev, plan, main_counts)
    sharded["two_process"] = two_process_phase(dev, plan, main_counts)
    xla_cli_phase(dist, batched_2024)

    k1_wide = wide_kernel_phases(dev)
    k2["wide"] = [wide_season_phase(dev, laps)]
    launches = wide_weekend_phase(dev)
    for row in k1_wide:
        row["launches"] = launches[row["d"]]
    k1["wide"] = k1_wide
    engine_phase(dev)
    mutation_phase(dev)
    alt = alt_models_and_serving_phases(dev)
    t0 = time.perf_counter()
    prebuild = prebuild_phase()
    traced = trace_phase(dev)
    walk = walkthrough_phase(dev)
    log(f"[phase] the prebuild step, the trace and the walkthrough: {time.perf_counter() - t0:.1f} s")
    k1["launches_by_path"] = {"weekend": k1["launches"], "prebuild": prebuild["k1_launches"],
                              "trace": traced["k1_launches"], "walkthrough": walk["k1_launches"]}
    k2["launches_by_path"] = {"batched backtest": k2["launches"],
                              "prebuild": prebuild["k2_launches"], "walkthrough": walk["k2_launches"]}
    log(f"[phase] all: {time.perf_counter() - START:.1f} s")
    hmc = alt["bayes"].pop("kernel")
    log("[alternative models and serving] " + json.dumps(alt))
    log(json.dumps({"kernels": [k1, k2, sharded, hmc]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
