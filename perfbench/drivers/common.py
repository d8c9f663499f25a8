"""What every driver does alike: set-up of the world and the device, the
measured window, the reading of memory and the trace once it closes, and
the sample of units the check compares."""

from __future__ import annotations

import contextlib
import gc
import math
import os
import time

import torch

from perfbench import trace
from perfbench.harness import Check, Run, power_limit_w
from perfbench.world import World


def world(run: Run) -> World:
    """The run's world (its offline cache), made as set-up."""
    season = run.param("season")
    made = World(int(run.rng("world").integers(2**32)), [season - 1, season])
    run.state["world"] = made
    run.state["power_limit"] = power_limit_w()
    return made


def setup(run: Run) -> World:
    """The run's world, and the card's name."""
    if run.device == "cuda":
        run.state["device_name"] = torch.cuda.get_device_name(0)
    return world(run)


def warm_frames(world: World) -> int:
    """Every session frame of the world's offline cache read once through
    the program's disk backend, so that its process-wide frame cache holds
    them all and no unit of the window reads parquet; returns the count."""
    from monte_carlo_gp_torch.data.loader import F1DataLoader

    disk, n = F1DataLoader(cache_dir=world.cache_dir, offline=True).cache, 0
    for path in sorted(disk.root.glob("*/*/*.parquet")):
        kind, session = path.stem.split("_", 1)
        load = disk.load_laps if kind == "laps" else disk.load_results
        n += load(int(path.parent.parent.name), path.parent.name, session) is not None
    return n


def program_predictor(run: Run, world: World):
    """A factory of fresh program predictors on the world's offline cache,
    as the configuration runs them."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    def make():
        return F1Predictor(cache_dir=world.cache_dir, offline=True, device=run.device,
                           quali_model=run.param("quali_model"), engine=run.param("engine"))

    return make


def ready(run: Run, sync: bool = True) -> None:
    """Set-up is over: `setup_s` is the time from the process's start
    (`sync`: after the card has finished its work)."""
    if sync and run.device == "cuda":
        torch.cuda.synchronize()
    run.e2e["setup_s"] = time.perf_counter() - run.t0


class Window:
    def __init__(self, seconds: float):
        self.seconds = seconds
        self.start = time.perf_counter()
        self.elapsed = 0.0

    def done(self) -> bool:
        """Whether the window's seconds are up (the unit under way ends
        first)."""
        return time.perf_counter() - self.start >= self.seconds


@contextlib.contextmanager
def window(run: Run):
    """The measured window, a `trace.WINDOW` range in a trace; its
    `elapsed` seconds run to the end of its last unit and its device
    work."""
    load, cpu = os.getloadavg(), time.process_time()
    with torch.profiler.record_function(trace.WINDOW):
        w = Window(run.seconds)
        yield w
        if run.device == "cuda":
            torch.cuda.synchronize()
        w.elapsed = time.perf_counter() - w.start
    # a slow run tells here whether its process got less of the cores (CPU
    # seconds under the wall's) or slower ones (CPU seconds grown with it)
    run.stderr.append(f"window: {w.elapsed:.3f} s, process CPU {time.process_time() - cpu:.3f} s, "
                      f"load average {load[0]:.2f} -> {os.getloadavg()[0]:.2f}, "
                      f"{torch.get_num_threads()} torch threads, {os.cpu_count()} cores")


def finish(run: Run, prof, span_names: set[str]) -> None:
    """Once the window has closed: the memory peak, the trace, and the
    program's state freed before the reference runs."""
    units = run.samples.get("unit_s", [])
    if units:
        run.stderr.append(f"units: {len(units)}, seconds each {[round(t, 4) for t in units]}")
    if run.device == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
    if prof is not None:
        run.device_trace = trace.from_profile(prof, span_names, run.device == "cuda")
    gc.collect()
    if run.device == "cuda":
        torch.cuda.empty_cache()


def sample(run: Run, units: list, cover: list[list[int]] = ()) -> list:
    """The units the check runs in full: `check_units` of them drawn from
    the seed, the first of them one from each group of `cover` (lists of
    unit indices) that no earlier pick is in, where the window reached it."""
    rng = run.rng("check")
    picks: list[int] = []
    for group in cover:
        if group and not set(picks) & set(group):
            picks.append(int(rng.choice(group)))
    rest = [i for i in range(len(units)) if i not in picks]
    k = min(max(int(run.param("check_units")) - len(picks), 0), len(rest))
    picks += [rest[i] for i in rng.choice(len(rest), size=k, replace=False)]
    return [units[i] for i in sorted(picks)]


def worst(gaps: dict, **values: float) -> None:
    """Each gap the worse of the two; a gap that is not a number is
    infinite."""
    for name, value in values.items():
        gaps[name] = max(gaps[name], math.inf if math.isnan(value) else value)


def checks(run: Run, gaps: dict) -> list[Check]:
    return [Check(name, float(value), float(run.cell.limits[name])) for name, value in gaps.items()]
