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

And on wide fields (20, 40, 80 and 128 drivers: one to four cars per lane):

  * the race kernel's time for blocks of 8, 12 and 4 warps (those that
    fit at the width), each with the grid
    of 64 warps per SM and with 1, 2 and 4 whole waves of the blocks that
    fit on every SM at once (the occupancy calculator's count), and the
    default launch shape, with a check that the counts do not change.

And the kernels themselves: the static SASS opcode mix of every
instantiation (`cuobjdump -sass` of the built library, by class: shuffle,
shared load/store, MUFU, integer, float, vote/branch, global/constant
memory), with its registers and spills (the `ptxas -v` report kept beside
the library) and the warps that stay resident on an SM at the default
launch shape.

Every line it prints carries the card's name and power limit; the last is
the whole report as one JSON object. It needs a CUDA device and exits
non-zero without one. Two shorter runs:

    python -m monte_carlo_gp_torch.profile_kernel --mix
    python -m monte_carlo_gp_torch.profile_kernel --against OLD.cu

`--mix` prints only the kernels' mix. `--against` builds OLD.cu (another
version of `csrc/race_kernel.cu`) into a library of its own and times it
and the current kernels in turns (old, new, new, old) on K1 at 20 drivers
(the Bahrain 2024 plan, 57 laps, 1,048,576 simulations) and at 40, 80 and
128 (57 laps, 262,144), and on K2 on the golden file's synthetic 2024
season (10,000 and 262,144 simulations per race) and wide season (65,536),
with a check that both give the same counts, and the mix of both. Each
library's default launch shape comes from its own occupancy query (0 blocks
for a block shape it cannot launch).
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import re
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
# blocks per race of the launches compared (53 shares out a grid of 1,056
# blocks over 20 races; 1,056 was the single-race grid before it was sized
# in whole waves of resident blocks, ops/race_kernel.launch_shape)
BACKTEST_SIMS, SEASON_SWEEP_SIMS = 10_000, (10_000, 262_144)
SEASON_BLOCKS = (53, 264, 1056)
SEASON_SEED = 42 * 1_000_003 + SEASON
# wide fields: (drivers, simulations) at 57 laps, the block shapes and the
# whole waves of resident blocks compared
WIDE_SHAPES = ((20, 1_048_576), (40, 262_144), (80, 262_144), (128, 262_144))
WIDE_WARPS, WIDE_WAVES, WIDE_LAPS = (8, 12, 4), (1, 2, 4), 57
# a field width of each tier of cars per lane, R = 1..4
TIER_WIDTHS = (20, 40, 80, 128)
# the comparison in turns: (label, drivers, simulations) of K1 and
# (label, simulations per race) of K2
AGAINST_K1 = (("K1 D=20 main shape", 20, 1_048_576), ("K1 D=40", 40, 262_144),
              ("K1 D=80", 80, 262_144), ("K1 D=128", 128, 262_144))
AGAINST_K2 = (("K2 2024 season", "k2_season2024", 10_000),
              ("K2 2024 season", "k2_season2024", 262_144),
              ("K2 wide season", "k2_wide_season", 65_536))

# The classes of the SASS opcode mix; an opcode of none of them (and not a
# NOP) counts as integer work (IMAD, IADD3, ISETP, LOP3, SHF, LEA, SEL, MOV,
# the uniform datapath's U* and the predicate logic). The counts are static:
# instructions in the compiled kernel, not instructions executed.
SASS_CLASSES = {
    "shuffle": ("SHFL",),
    "shared load/store": ("LDS", "STS", "ATOMS", "LDSM"),
    "MUFU": ("MUFU",),
    "float": ("FADD", "FMUL", "FFMA", "FSETP", "FMNMX", "FSEL", "FRND", "FCHK", "FSET", "F2F",
              "I2F", "F2I", "FSWZADD"),
    "vote/branch": ("VOTE", "VOTEU", "BRA", "BRX", "BSSY", "BSYNC", "WARPSYNC", "EXIT", "BAR",
                    "BMOV", "BREAK", "CALL", "RET", "YIELD", "JMP"),
    "global/constant memory": ("LDG", "STG", "LDC", "ULDC", "RED", "ATOM", "ATOMG", "LD", "ST",
                               "LDL", "STL", "MEMBAR", "CCTL", "ERRBAR"),
}
_SASS_CLASS = {op: cls for cls, ops in SASS_CLASSES.items() for op in ops}
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")
_KERNEL = re.compile(r"(race_kernel|season_kernel)ILi(\d)E")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str | None:
    """`race_kernel<R>` or `season_kernel<R>` of a mangled kernel name."""
    m = _KERNEL.search(mangled)
    return f"{m[1]}<{m[2]}>" if m else None


def sass_mix(sass: str) -> dict[str, dict[str, int]]:
    """Static opcode counts by class of each race kernel in `cuobjdump
    -sass` output (NOPs, the padding after EXIT, are not counted)."""
    mix, counts = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = kernel_name(line.split("Function :", 1)[1])
            counts = mix.setdefault(name, dict.fromkeys([*SASS_CLASSES, "integer"], 0)) if name else None
            continue
        m = _SASS_OPCODE.search(line)
        if counts is not None and m and m[1] != "NOP":
            counts[_SASS_CLASS.get(m[1], "integer")] += 1
    return mix


def ptxas_report(log: str) -> dict[str, dict[str, int]]:
    """Registers, stack frame and spill bytes of each race kernel in a
    `ptxas -v` report."""
    report, cur = {}, None
    for line in log.splitlines():
        if m := re.search(r"Function properties for (\S+)", line):
            cur = report.setdefault(kernel_name(m[1]), {}) if kernel_name(m[1]) else None
        elif cur is None:
            continue
        elif m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                            r"(\d+) bytes spill loads", line):
            cur.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        elif m := re.search(r"Used (\d+) registers", line):
            cur["registers"] = int(m[1])
    return report


def kernel_facts(dev, ptxas: dict, d: int, season: bool) -> dict:
    """The instantiation that runs d drivers (K1, or K2 with `season`): its
    name, its registers and spills from a `ptxas_report`, its default block
    shape and the warps resident on an SM at that shape."""
    from monte_carlo_gp_torch.ops import race_kernel as rk

    name = f"{'season' if season else 'race'}_kernel<{-(-d // 32)}>"
    warps, _ = rk.launch_shape(dev, d, season=season)
    per_sm = rk.blocks_per_sm(dev.index or 0, d, warps, season)
    return {"kernel": name, **ptxas.get(name, {}), "drivers": d, "warps_per_block": warps,
            "blocks_per_sm": per_sm, "resident_warps_per_sm": per_sm * warps}


def kernel_mix(dev, lib_path: Path, where: str, label: str = "") -> list[dict]:
    """Each kernel instantiation of the library at `lib_path` (loaded as the
    race kernel's library): its registers and spills, the warps resident on
    an SM at the default launch shape, and its SASS opcode mix."""
    from monte_carlo_gp_torch.ops._build import find_nvcc

    cuobjdump = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    mix = sass_mix(sass)
    regs = ptxas_report(lib_path.with_suffix(".log").read_text())
    rows = []
    for d in TIER_WIDTHS:
        for season in (False, True):
            row = kernel_facts(dev, regs, d, season)
            counts = mix.get(row["kernel"], {})
            total = sum(counts.values())
            row.update(library=lib_path.name, sass=counts, sass_total=total)
            rows.append(row)
            spills = row.get("spill_stores", "?"), row.get("spill_loads", "?")
            print(f"[mix{label}] {row['kernel']} (D={d}): {row.get('registers', '?')} registers, "
                  f"spill stores/loads {spills[0]}/{spills[1]} B; {row['warps_per_block']} warps x "
                  f"{row['blocks_per_sm']} blocks = {row['resident_warps_per_sm']} resident warps "
                  f"per SM; SASS {total} instructions: "
                  + ", ".join(f"{k} {v} ({v / max(total, 1):.1%})" for k, v in counts.items())
                  + f" ({where})", flush=True)
    return rows


@contextlib.contextmanager
def using_library(lib):
    """The race kernel's wrappers launch from `lib` (a loaded library) inside
    the block; the occupancy cache is emptied on the way in and out, so the
    default launch shape is the one `lib`'s own occupancy query gives."""
    from monte_carlo_gp_torch.ops import race_kernel as rk

    saved = rk._lib
    rk._lib = lib
    rk.blocks_per_sm.cache_clear()
    try:
        yield
    finally:
        rk._lib = saved
        rk.blocks_per_sm.cache_clear()


@contextlib.contextmanager
def overtake_passes():
    """Counts the overtake passes of the plain race version while the block
    runs: one [live, swapping] pair per call of `race_counts_plain` (one per
    race of `season_counts_plain`), each the number of simulation-passes in
    which the pass was live (pass 1 always; a later pass when the one before
    it swapped) or swapped, over every pass of every lap. The sums are
    tensors on the inputs' device, read when the caller needs them."""
    from monte_carlo_gp_torch.ops import race_kernel as rk

    races = []
    real_pass, real_race = rk._overtake_pass, rk.race_counts_plain

    def count_pass(cum, pace, att, u, pass_active, *args):
        out, swapped = real_pass(cum, pace, att, u, pass_active, *args)
        live, swapping = races[-1]
        races[-1] = [live + pass_active.sum(), swapping + swapped.sum()]
        return out, swapped

    def count_race(*args, **kwargs):
        races.append([0, 0])
        return real_race(*args, **kwargs)

    rk._overtake_pass, rk.race_counts_plain = count_pass, count_race
    try:
        yield races
    finally:
        rk._overtake_pass, rk.race_counts_plain = real_pass, real_race


def compare_against(dev, against: Path, where: str) -> dict:
    """The library built from `against` and the current one, in turns (old,
    new, new, old) at each shape of AGAINST_K1 and AGAINST_K2, each at the
    default launch shape its own occupancy query gives."""
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.ops._build import build_cuda_library
    from monte_carlo_gp_torch.validate import golden

    against = against.resolve()
    old_path = build_cuda_library("race_kernel_against", [against.name], src_dir=against.parent)
    new_path = rk.build()
    libs = {"old": rk.load_library(old_path), "new": rk._lib}
    mixes = {}
    for label, path in (("old", old_path), ("new", new_path)):
        with using_library(libs[label]):
            mixes[label] = kernel_mix(dev, path, where, f" {label}")

    season = golden.load()
    runs = []
    for label, d, n in AGAINST_K1:
        launch, (pmat, scal, grid_log, laps) = golden.case_inputs(f"k1_d{d}", dev, season)
        runs.append((f"{label}, {laps} laps, {n} sims",
                     functools.partial(launch, pmat, scal, grid_log, laps, n, seed=0)))
    for label, case, n in AGAINST_K2:
        launch, (pmat_s, scal_s, grid_log_s, laps, seeds) = golden.case_inputs(case, dev, season)
        runs.append((f"{label}, {len(laps)} races x {n} sims",
                     functools.partial(launch, pmat_s, scal_s, grid_log_s, laps, n, seeds)))
    rows = []
    for shape, fn in runs:
        times, counts = {"old": [], "new": []}, {}
        for label in ("old", "new", "new", "old"):
            with using_library(libs[label]):
                times[label].append(event_ms(fn))
                counts[label] = fn()
        same = torch.equal(counts["old"], counts["new"])
        row = {"shape": shape, "old_ms": times["old"], "new_ms": times["new"], "counts_equal": same}
        rows.append(row)
        old, new = sum(times["old"]) / 2, sum(times["new"]) / 2
        print(f"[against] {shape}: old {times['old'][0]:.3f} / {times['old'][1]:.3f} ms, new "
              f"{times['new'][0]:.3f} / {times['new'][1]:.3f} ms (old, new, new, old); new / old "
              f"{new / old:.4f}; counts bitwise equal: {same} ({where})", flush=True)
    if not all(r["counts_equal"] for r in rows):
        raise AssertionError("the two libraries give different counts")
    return {"card": where, "against": str(against), "mix": mixes, "turns": rows}


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

    from monte_carlo_gp_torch.utils.profiling import Phase, device_times_us

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

    from monte_carlo_gp_torch.utils.profiling import Phase, device_times_us, timed_calls
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


def wide_field(d: int, dev):
    """The field of tests/test_torch_race_kernel_gpu.py at d drivers."""
    import numpy as np

    from monte_carlo_gp_torch.config import make_sim_params

    rng = np.random.default_rng(d)
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0)
    return make_sim_params(
        grid_probs=(gp / gp.sum(1, keepdims=True)).astype(np.float32),
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15), dnf_rate=np.full(d, 0.0008),
        team_dnf_rate=np.full(d, 0.002), pit_loss=21.0, overtake_delta=0.6, device=dev,
    )


def wide_shapes(dev, where: str) -> list[dict]:
    """K1 at each width of WIDE_SHAPES over block shapes and grids."""
    from monte_carlo_gp_torch.ops import race_kernel as rk

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for d, n in WIDE_SHAPES:
        pmat, scal, grid_log = rk.pack_inputs(wide_field(d, dev))

        def run(warps=None, blocks=None):
            return rk.race_counts(pmat, scal, grid_log, WIDE_LAPS, n, seed=0,
                                  warps_per_block=warps, n_blocks=blocks)

        want = run()
        default = rk.launch_shape(dev, d)
        shapes = [("default", *default)]
        for warps in WIDE_WARPS:
            per_sm = rk.blocks_per_sm(dev.index or 0, d, warps, False)
            if per_sm == 0:  # a block of this many warps does not fit at this width
                continue
            shapes.append(("64 warps per SM", warps, n_sm * (64 // warps)))
            shapes += [(f"{w} whole waves", warps, w * n_sm * per_sm) for w in WIDE_WAVES]
        for label, warps, blocks in shapes:
            per_sm = rk.blocks_per_sm(dev.index or 0, d, warps, False)
            ms = event_ms(lambda: run(warps, blocks))
            same = torch.equal(run(warps, blocks), want)
            rows.append({"drivers": d, "sims": n, "grid": label, "warps_per_block": warps,
                         "blocks": blocks, "blocks_per_sm": per_sm, "ms": ms,
                         "counts_equal": same})
            print(f"[wide shape] D={d}, {WIDE_LAPS} laps, {n} sims, {label}: {warps} warps x "
                  f"{blocks} blocks ({per_sm} per SM, {per_sm * warps} warps): {ms:.3f} ms, "
                  f"counts equal: {same} ({where})", flush=True)
    if not all(r["counts_equal"] for r in rows):
        raise AssertionError("kernel counts depend on the launch shape")
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Profile the race kernels on a CUDA GPU.")
    ap.add_argument("--mix", action="store_true", help="print only the kernels' mix")
    ap.add_argument("--against", type=Path, help="time another race_kernel.cu against this one")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_kernel: needs a CUDA device (torch.cuda.is_available() is False)")
    from monte_carlo_gp_torch.ops import race_kernel as rk

    dev = torch.device("cuda:0")
    where = card()
    print(f"[card] {where}", flush=True)
    lib_path = rk.build()
    if args.against:
        print(json.dumps(compare_against(dev, args.against, where)), flush=True)
        return
    mix = kernel_mix(dev, lib_path, where)
    if args.mix:
        print(json.dumps({"card": where, "mix": mix}), flush=True)
        return

    weekend = profile_weekend(dev)
    plan = weekend.pop("plan")
    kernel_ms = weekend["kernel_device_ms"]
    print(f"[weekend] prepare {weekend['prepare_s']:.3f} s, simulate "
          f"{weekend['simulate_s']:.3f} s; race kernel {kernel_ms:.3f} ms of "
          f"{weekend['all_device_ms']:.3f} ms device time; device busy "
          f"{weekend['busy_share']:.4f} of the weekend ({where})", flush=True)

    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(dev))
    laps = plan.total_laps

    def run(n: int, warps: int | None = None):
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
    wide_rows = wide_shapes(dev, where)

    report = {"card": where, "weekend": weekend, "scaling": scaling, "launch_shape": shapes,
              "season_backtest": season, "season_shape": season_rows, "wide_shape": wide_rows,
              "mix": mix}
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
