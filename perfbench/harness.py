"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window produced against the plain reference, and the result line.

The traffic kind (`weekend`, `serve`, `season`) names a driver in
`drivers/`, which measures (`measure(run)`) and then checks
(`check(run)`); a per-layer metric is read by its own file in `metrics/`.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import time
import zlib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from perfbench import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "monte_carlo_gp_tpu")
ROOT = spec.HERE.parent
# the program's kernel builds, at a fixed path inside the checkout, so that
# only a checkout's first run builds
BUILD_DIR = spec.HERE / ".build"


def forbidden_modules(modules=None) -> list[str]:
    """The loaded modules whose top-level name (before the first dot,
    compared whole) is JAX's or the JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def process_start() -> float:
    """The `time.perf_counter()` reading at this process's start, from
    /proc (to 10 ms); the reading now where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def derive(seed: int, *tags) -> np.random.Generator:
    """A generator for one purpose (`tags`) of the run seeded `seed`."""
    words = [seed % 2**64] + [zlib.crc32(str(t).encode()) for t in tags]
    return np.random.default_rng(np.random.SeedSequence(words))


class Spans:
    """Harness spans around the calls into each layer: wall seconds per
    name, and a `torch.profiler.record_function` range each, so a trace
    labels the host's time by them."""

    def __init__(self):
        self.times: dict[str, list[float]] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        import torch

        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)


@dataclass
class Check:
    """One number compared with the reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Run:
    """Everything one run knows: the cell, its arguments, and what the
    window measured. `overrides` replaces traffic or configuration values
    (the CPU tests' small sizes); a run of the command has none."""

    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    t0: float
    device: str = "cuda"
    overrides: dict = field(default_factory=dict)
    spans: Spans = field(default_factory=Spans)
    samples: dict[str, list[float]] = field(default_factory=dict)
    work: dict = field(default_factory=dict)
    units: list = field(default_factory=list)
    e2e: dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    device_trace: object = None
    state: dict = field(default_factory=dict)
    stderr: list[str] = field(default_factory=list)

    def param(self, key: str):
        """A traffic value, else a configuration value, unless overridden."""
        if key in self.overrides:
            return self.overrides[key]
        if key in self.cell.traffic:
            return self.cell.traffic[key]
        return self.cell.config[key]

    def rng(self, *tags) -> np.random.Generator:
        return derive(self.seed, *tags)


def driver(kind: str):
    return importlib.import_module(f"perfbench.drivers.{spec.check_name(kind, 'traffic kind')}")


def program_env() -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout."""
    os.environ["MCGP_COMPILE_CACHE"] = str(BUILD_DIR)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD_DIR / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD_DIR / "triton")


def check_program_here() -> None:
    """The program imported is the checkout's own."""
    import monte_carlo_gp_torch

    where = Path(monte_carlo_gp_torch.__file__).resolve()
    if ROOT not in where.parents:
        raise RuntimeError(f"the program was imported from {where}, outside the checkout {ROOT}")


def power_limit_w() -> str:
    """The card's power limit as `nvidia-smi` reads it, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _start(workload, seed, seconds, trace, root, device, overrides, t0):
    """A new run of `workload` and its traffic kind's driver."""
    cell = spec.find_cell(root, workload)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
              t0=time.perf_counter() if t0 is None else t0, device=device,
              overrides=dict(overrides or {}))
    program_env()
    return run, driver(cell.traffic["kind"])


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, root: Path = ROOT,
             device: str = "cuda", overrides: dict | None = None,
             t0: float | None = None) -> tuple[dict, list[Check], Run]:
    """Measure and check one run of `workload`; returns (the result line,
    the checks, the run)."""
    run, kind = _start(workload, seed, seconds, trace, root, device, overrides, t0)
    try:
        kind.measure(run)
        checks = kind.check(run)
    finally:
        close(run)
    return result_line(run, checks), checks, run


def calibrate(workload: str, seed: int, seconds: float, *, control: bool, root: Path = ROOT,
              device: str = "cuda", overrides: dict | None = None) -> dict:
    """One short run of `workload` for the correctness limits: the
    program's gaps from the reference (the lower readings) and, with
    `control`, the control's (the upper readings), on the same units."""
    run, kind = _start(workload, seed, seconds, False, root, device, overrides, None)
    try:
        kind.measure(run)
        t = time.perf_counter()
        checks = kind.check(run)
        out = {"seed": seed, "units": len(run.units), "check_s": time.perf_counter() - t,
               "program": {c.name: c.value for c in checks}, "e2e": run.e2e}
        if control:
            out["control"] = kind.control(run)
    finally:
        close(run)
    return out


def close(run: Run) -> None:
    """Remove the run's world and stop what it started."""
    for key in ("server", "world"):
        if key in run.state:
            run.state.pop(key).close()


def result_line(run: Run, checks: list[Check]) -> dict:
    """The run's last line: `correct`, `attempted`, `failed`, `metrics`,
    `device`, with `--trace 1` `breakdown`, and the compared numbers last."""
    cell = run.cell
    if run.trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if run.device == "cuda" else run.device,
           "kind": run.state.get("device_name", "unknown"),
           "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": bool(checks) and all(c.ok for c in checks) and run.failed == 0,
            "attempted": run.attempted, "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace and run.device_trace is not None:
        dev["busy_s"] = run.device_trace.busy_s
        dev["window_s"] = run.device_trace.window_s
        line["breakdown"] = {"device_ops": run.device_trace.device_ops,
                             "idle_gaps": run.device_trace.idle_gaps}
    line["card"] = {"power_limit": run.state.get("power_limit", "unknown")}
    # a value that is not finite (a structure that does not match) reads null
    line["checks"] = {c.name: {"value": c.value if math.isfinite(c.value) else None,
                               "limit": c.limit} for c in checks}
    return line


def check_lines(checks: list[Check]) -> list[str]:
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}"
            for c in checks]


def dumps(line: dict) -> str:
    return json.dumps(line, allow_nan=False)
