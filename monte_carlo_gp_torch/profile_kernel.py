"""Where the weekend's time goes on a CUDA GPU, and how the race kernel
scales with the simulation count and the launch shape.

    python -m monte_carlo_gp_torch.profile_kernel

On the Bahrain 2024 weekend of the synthetic world (20 drivers, 57 laps):

  * the weekend (`prepare_weekend` then `simulate_plan` at 1,048,576
    simulations) of a new predictor under `torch.profiler`, after a warm-up
    that builds and loads the kernel: the phase times, the kernel's device time and the
    device's busy share of the weekend;
  * the kernel's time (CUDA events, mean of 3 after a warm-up) at 65,536 to
    4,194,304 simulations;
  * the kernel's time at 1,048,576 simulations for 2 to 16 warps per block,
    with a check that the counts do not change.

And on the synthetic 2024 season (20 races, 44 to 78 laps):

  * the batched backtest of the season at 10,000 simulations per race
    (`backtest_model_batched`, a new predictor, the kernels built and
    loaded beforehand) under `torch.profiler`: its wall time, the season
    kernel's device time and the device's busy share;
  * the season kernel's time at 10,000 and 262,144 simulations per race
    for several blocks per race, taken in turns with the 20 single-race
    launches of the same races, with a check that the counts do not change.

Every line it prints carries the card's name and power limit; the last is
the whole report as one JSON object. It needs a CUDA device and exits
non-zero without one.
"""

from __future__ import annotations

import functools
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

CACHE_DIR = Path(__file__).resolve().parents[1] / "build" / "profile_cache"
SEASON, RACE, SYNTHETIC_SEED = 2024, "Bahrain", 2718
WEEKEND_SIMS = 1_048_576
SWEEP_SIMS = (65_536, 262_144, 1_048_576, 4_194_304)
# 32 warps per block would need more registers than an SM holds
SWEEP_WARPS = (2, 4, 8, 16)
# the season: the backtest's simulations per race and a larger count; the
# blocks per race of the launches compared (53 shares out one single-race
# grid of 1,056 blocks over 20 races; 1,056 is the single-race grid itself)
BACKTEST_SIMS, SEASON_SWEEP_SIMS = 10_000, (10_000, 262_144)
SEASON_BLOCKS = (53, 264, 1056)
SEASON_SEED = 42 * 1_000_003 + SEASON


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def event_ms(fn, repeats: int = 3) -> float:
    """Mean device time of `fn` over `repeats` calls, after one warm call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def device_times_us(prof, kernel_name: str = "race_kernel") -> tuple[float, float]:
    """(the named kernel, all device work) self device time in microseconds."""
    kernel = total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total += t
        if kernel_name in e.key:
            kernel += t
    return kernel, total


def new_predictor(dev, name: str):
    """A predictor of the synthetic world on a cache directory of its own,
    emptied first, so no data or Elo cache carries over between runs."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    cache_dir = CACHE_DIR / name
    shutil.rmtree(cache_dir, ignore_errors=True)
    return F1Predictor(
        cache_dir=cache_dir, backend=SyntheticBackend(seed=SYNTHETIC_SEED), device=dev
    )


def profile_weekend(dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from monte_carlo_gp_torch.utils.profiling import Phase

    # warm-up on its own predictor: the kernel build and load and the CUDA
    # context stay out of the profile; the data and Elo caches do not carry over
    warm = new_predictor(dev, "warm-up")
    warm.simulate_plan(warm.prepare_weekend(SEASON, RACE), 4096, seed=0)
    weekend = new_predictor(dev, "weekend")
    timers = Phase()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with timers("prepare"):
            plan = weekend.prepare_weekend(SEASON, RACE)
        with timers("simulate"):
            weekend.simulate_plan(plan, WEEKEND_SIMS, seed=0)
    kernel_us, device_us = device_times_us(prof)
    wall_s = timers.totals["prepare"] + timers.totals["simulate"]
    return {
        "sims": WEEKEND_SIMS,
        "prepare_s": timers.totals["prepare"],
        "simulate_s": timers.totals["simulate"],
        "kernel_device_ms": kernel_us / 1e3,
        "all_device_ms": device_us / 1e3,
        "busy_share": device_us / 1e6 / wall_s,
        "kernel_share_of_device": kernel_us / device_us if device_us else None,
        "plan": plan,
    }


def profile_season_backtest(dev) -> dict:
    """The batched backtest of one season under the profiler, after a
    small season launch that loads the season kernel."""
    from torch.profiler import ProfilerActivity, profile

    from monte_carlo_gp_torch.utils.profiling import Phase, timed_calls
    from monte_carlo_gp_torch.validate import backtest as bt

    warm = new_predictor(dev, "season-warm-up")
    plans, _ = bt.prepare_season_plans(warm, SEASON, verbose=False)
    bt.simulate_season_plans(warm, plans[:2], SEASON_SEED, 64)
    torch.cuda.synchronize()
    timers = Phase()
    with timed_calls(bt, "prepare_season_plans", timers), \
            profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = bt.backtest_model_batched(
            lambda: new_predictor(dev, "season"), [SEASON], n_simulations=BACKTEST_SIMS,
            verbose=False,
        )
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernel_us, device_us = device_times_us(prof, "season_kernel")
    return {
        "sims_per_race": BACKTEST_SIMS,
        "n_races": result["n_races"],
        "wall_s": wall_s,
        "prepare_s": timers.totals["prepare_season_plans"],
        "season_kernel_device_ms": kernel_us / 1e3,
        "all_device_ms": device_us / 1e3,
        "busy_share": device_us / 1e6 / wall_s,
        "plans": plans,
    }


def season_shapes(dev, plans, where: str) -> list[dict]:
    """The season kernel for each blocks-per-race of SEASON_BLOCKS, taken in
    turns with the 20 single-race launches of the same races (single races,
    season shapes, single races again), at each count of SEASON_SWEEP_SIMS."""
    from monte_carlo_gp_torch.ops import philox
    from monte_carlo_gp_torch.ops import race_kernel as rk

    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs([p.params.to(dev) for p in plans])
    laps = [p.total_laps for p in plans]
    seeds = [philox.fold_in(SEASON_SEED, r) for r in range(len(plans))]
    rows = []
    for n in SEASON_SWEEP_SIMS:
        def singles():
            return torch.stack([
                rk.race_counts(pmat_s[r], scal_s[r], grid_log_s[r], laps[r], n, seed=seeds[r])
                for r in range(len(plans))])

        def season(blocks):
            return rk.season_counts(pmat_s, scal_s, grid_log_s, laps, n, seeds,
                                    blocks_per_race=blocks)

        want = singles()
        runs = [(f"{len(plans)} single-race launches", None, singles)]
        runs += [(f"season, {b} blocks per race", b, functools.partial(season, b))
                 for b in SEASON_BLOCKS]
        runs += [(f"{len(plans)} single-race launches, again", None, singles)]
        for label, blocks, fn in runs:
            ms = event_ms(fn)
            same = torch.equal(fn(), want)
            rows.append({"sims_per_race": n, "launch": label, "blocks_per_race": blocks,
                         "ms": ms, "counts_equal": same})
            print(f"[season shape] {len(plans)} races x {n} sims, {label}: {ms:.3f} ms, "
                  f"counts equal: {same} ({where})", flush=True)
    if not all(r["counts_equal"] for r in rows):
        raise AssertionError("season counts depend on the launch shape")
    return rows


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_kernel: needs a CUDA device (torch.cuda.is_available() is False)")
    from monte_carlo_gp_torch.ops import race_kernel as rk

    dev = torch.device("cuda:0")
    where = card()
    print(f"[card] {where}", flush=True)

    weekend = profile_weekend(dev)
    plan = weekend.pop("plan")
    kernel_ms = weekend["kernel_device_ms"]
    print(f"[weekend] prepare {weekend['prepare_s']:.3f} s, simulate "
          f"{weekend['simulate_s']:.3f} s; race kernel {kernel_ms:.3f} ms of "
          f"{weekend['all_device_ms']:.3f} ms device time; device busy "
          f"{weekend['busy_share']:.4f} of the weekend ({where})", flush=True)

    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(dev))
    laps = plan.total_laps

    def run(n: int, warps: int = rk.DEFAULT_WARPS_PER_BLOCK):
        return rk.race_counts(pmat, scal, grid_log, laps, n, seed=0, warps_per_block=warps)

    scaling = []
    for n in SWEEP_SIMS:
        ms = event_ms(lambda: run(n))
        scaling.append({"sims": n, "ms": ms, "sims_per_s": n / ms * 1e3})
        print(f"[scaling] {n} sims: {ms:.3f} ms, {n / ms * 1e3:,.0f} sims/s ({where})",
              flush=True)

    shapes = []
    want = run(WEEKEND_SIMS)
    for warps in SWEEP_WARPS:
        ms = event_ms(lambda: run(WEEKEND_SIMS, warps))
        same = torch.equal(run(WEEKEND_SIMS, warps), want)
        shapes.append({"warps_per_block": warps, "ms": ms, "counts_equal": same})
        print(f"[launch shape] {warps} warps per block, {WEEKEND_SIMS} sims: {ms:.3f} ms, "
              f"counts equal: {same} ({where})", flush=True)
    if not all(s["counts_equal"] for s in shapes):
        raise AssertionError("kernel counts depend on the launch shape")

    season = profile_season_backtest(dev)
    plans = season.pop("plans")
    print(f"[season backtest] {season['n_races']} races x {BACKTEST_SIMS} sims: wall "
          f"{season['wall_s']:.3f} s, host preparation {season['prepare_s']:.3f} s; season "
          f"kernel {season['season_kernel_device_ms']:.3f} ms of {season['all_device_ms']:.3f} "
          f"ms device time; device busy {season['busy_share']:.5f} of the backtest ({where})",
          flush=True)
    season_rows = season_shapes(dev, plans, where)

    report = {"card": where, "weekend": weekend, "scaling": scaling, "launch_shape": shapes,
              "season_backtest": season, "season_shape": season_rows}
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
