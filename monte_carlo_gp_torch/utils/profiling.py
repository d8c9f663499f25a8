"""Per-phase wall-clock counters the CLI prints with `--timings`, a sims/sec
helper, and the opt-in profiler trace of `--trace DIR` (the JAX package's
`utils/profiling.py`, with `torch.profiler` in place of `jax.profiler`).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch


@dataclass
class Phase:
    """Accumulating named wall-clock timers. Each phase is also a
    `torch.profiler.record_function` range, so it shows by name in a trace.

    >>> timers = Phase()
    >>> with timers("elo"):
    ...     build_elo()
    >>> print(phase_report(timers))
    """

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1


@contextlib.contextmanager
def timed_calls(owner, name: str, timers: Phase):
    """Within the block, every call of `owner.<name>` (a module's function,
    say, that other code of the module calls by name) adds its wall time to
    `timers` under `name`."""
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        with timers(name):
            return fn(*args, **kwargs)

    setattr(owner, name, timed)
    try:
        yield
    finally:
        setattr(owner, name, fn)


def phase_report(timers: Phase) -> str:
    lines = ["phase timings:"]
    for name, total in sorted(timers.totals.items(), key=lambda kv: -kv[1]):
        n = timers.counts[name]
        lines.append(f"  {name:<24} {total:8.3f}s  ({n}x)")
    return "\n".join(lines)


def sims_per_second(n_sims: int, seconds: float, n_chips: int = 1) -> float:
    return n_sims / seconds / max(1, n_chips)


def _device_work(e) -> bool:
    """Whether a profiler event (or average) is work the device did: a
    kernel, copy or memset. A CPU operator, and a `record_function` range's
    copy on the device's timeline (`gpu_user_annotation`), also carry the
    device time of the kernels inside them, and are not."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def device_times_us(prof, kernel_name: str = "race_kernel") -> tuple[float, float]:
    """(the named kernel, all device work) self device time in microseconds
    of a finished `torch.profiler.profile`, summed over the device's work
    alone, so no kernel counts twice."""
    kernel = total = 0.0
    for e in prof.key_averages():
        if not _device_work(e):
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        total += t
        if kernel_name in e.key:
            kernel += t
    return kernel, total


def device_events(prof) -> int:
    """How many events of a finished `torch.profiler.profile` are work a
    CUDA device did (kernels, copies, memsets)."""
    return sum(_device_work(e) for e in prof.events())


def device_time_by_name(prof, top: int = 5) -> list[tuple[str, float]]:
    """The `top` kinds of device work of a finished profile by self device
    time: (name, microseconds), largest first."""
    rows = [(e.key, e.self_device_time_total) for e in prof.key_averages() if _device_work(e)]
    return sorted(rows, key=lambda kv: -kv[1])[:top]


class TraceError(RuntimeError):
    """A CUDA trace recorded no device event."""


@dataclass
class Trace:
    """What `trace` wrote: the trace file (None until the block ends without
    an exception), its count of device events, and the profile itself for
    `device_times_us`."""

    log_dir: Path
    path: Path | None = None
    device_events: int = 0
    profile: object = None


@contextlib.contextmanager
def trace(log_dir: str | None, device: str | torch.device | None = None):
    """Optional profiler trace: `with trace('/tmp/trace', device) as t: run()`.

    A falsy `log_dir` does nothing and yields None. Otherwise the block runs
    under `torch.profiler.profile` with CPU activity, plus CUDA activity
    when `device` is a CUDA device, and the trace is written into `log_dir`
    by `torch.profiler.tensorboard_trace_handler` (`*.pt.trace.json`, which
    TensorBoard's profile plugin and Perfetto read). Yields a `Trace`,
    filled in when the block ends. A block that raises writes no trace. A
    CUDA trace that recorded no device event raises TraceError and writes
    nothing: it would look like a whole trace of a run that went unseen."""
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    on_cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
    out = Trace(log_dir=Path(log_dir))
    with profile(activities=activities) as prof:
        yield out
    out.profile = prof
    out.device_events = device_events(prof)
    if on_cuda and out.device_events == 0:
        raise TraceError(
            "the profiler recorded no device event of a CUDA run (is CUPTI "
            f"available?); no trace was written to {log_dir}"
        )
    before = set(out.log_dir.glob("*.pt.trace.json"))
    tensorboard_trace_handler(str(out.log_dir))(prof)
    (out.path,) = set(out.log_dir.glob("*.pt.trace.json")) - before
