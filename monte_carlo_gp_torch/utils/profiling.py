"""The port's span and counter recorder, a sims/sec helper, and the opt-in
profiler trace of `--trace DIR` (the JAX package's `utils/profiling.py`,
with `torch.profiler` in place of `jax.profiler`).

`RECORDER` is the process's recorder; the program opens its spans with
`span(name)` at phase boundaries (never inside a per-driver, per-lap or
per-chain loop) and counts with `count(name)`:

    with span("weekend.prepare"):
        with span("weekend.elo"):
            build_elo()
    count("frames.read")

Always on: each span name's count and seconds, each path of names from the
outermost span down (count, total and self time: the span's time less its
children's), and each counter's total, a few dictionary updates a span.
While a `torch.profiler` profile records on the span's thread
(`torch.autograd._profiler_enabled`, which is per thread), a span is also a
`record_function` range of its name, on the profile's own timeline beside
the kernels, and every span and counter increment goes into
`RECORDER.events` (bounded) for a reader of the profiled window. With no
profile recording no range is opened: an empty one costs ~14 µs.

Readers: `--timings` prints `phase_report(...)` (the span tree and the
counters), `--trace DIR` writes the ranges into its Chrome trace, the
server's `/stats` serves `tree(...)` of its `serve.*` spans and the frame
counters, and `perfbench/metrics/` read `events` of the traced window.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import NamedTuple

import torch

MAX_EVENTS = 1 << 18  # ~30 spans a weekend; a 51 s season window holds a few thousand


class Event(NamedTuple):
    """One span recorded while a profile recorded: its name, its start and
    end (`time.perf_counter_ns`), its parent's name and the request it
    served (the server's sequence number, None elsewhere). A counter's
    increment is an event with `start_ns == end_ns` and `n` the increment."""

    name: str
    start_ns: int
    end_ns: int
    parent: str | None = None
    request: int | None = None
    n: int = 1


class _Span:
    """One open span of a `Phase` (its context manager)."""

    __slots__ = ("rec", "name", "new_request", "parent", "path", "request", "range", "t0",
                 "children_ns")

    def __init__(self, rec: "Phase", name: str, new_request: bool):
        self.rec, self.name, self.new_request = rec, name, new_request

    def __enter__(self):
        stack = self.rec._stack()
        parent = self.parent = stack[-1] if stack else None
        self.path = (*parent.path, self.name) if parent else (self.name,)
        if self.new_request:
            self.request = next(self.rec._requests)
        else:
            self.request = parent.request if parent else None
        self.range = None
        if torch.autograd._profiler_enabled():
            args = None if self.request is None else f"request={self.request}"
            self.range = torch.profiler.record_function(self.name, args)
            self.range.__enter__()
        self.children_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.rec._stack().pop()
        dt = t1 - self.t0
        if self.parent is not None:
            self.parent.children_ns += dt
        self.rec._close(self, t1, dt)
        return False


@dataclass
class Phase:
    """Named spans and counters: a process has one, `RECORDER`, and a
    caller may keep its own.

    `paths`: per path of names from the outermost span, [count, total ns,
    self ns] in the order first seen (`totals` and `counts` sum them per
    name); `counters`: each counter's total; `events`: what was recorded
    while a profile recorded (at most `MAX_EVENTS`, then `dropped` counts
    the rest).

    >>> timers = Phase()
    >>> with timers("elo"):
    ...     build_elo()
    >>> print(phase_report(timers))
    """

    paths: dict[tuple[str, ...], list[int]] = field(default_factory=dict)
    counters: dict[str, int] = field(default_factory=dict)
    events: list[Event] = field(default_factory=list)
    dropped: int = 0

    def __post_init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._requests = itertools.count(1)

    @property
    def totals(self) -> dict[str, float]:
        """Seconds per span name."""
        out: dict[str, float] = {}
        for path, (_, total, _) in self.paths.items():
            out[path[-1]] = out.get(path[-1], 0.0) + total * 1e-9
        return out

    @property
    def counts(self) -> dict[str, int]:
        """Spans closed per name."""
        out: dict[str, int] = {}
        for path, (n, _, _) in self.paths.items():
            out[path[-1]] = out.get(path[-1], 0) + n
        return out

    def __call__(self, name: str, request: bool = False) -> _Span:
        """A span named `name` (a context manager); `request`: it opens a
        request, so it and every span inside it carry a new request id."""
        return _Span(self, name, request)

    def count(self, name: str, n: int = 1) -> None:
        """Add `n` to the counter `name`."""
        event = None
        if torch.autograd._profiler_enabled():
            stack = self._stack()
            top = stack[-1] if stack else None
            t = time.perf_counter_ns()
            event = Event(name, t, t, top and top.name, top and top.request, n)
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if event is not None:
                self._append(event)

    def _stack(self) -> list[_Span]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _append(self, event: Event) -> None:
        if len(self.events) < MAX_EVENTS:
            self.events.append(event)
        else:
            self.dropped += 1

    def _close(self, s: _Span, t1: int, dt: int) -> None:
        with self._lock:
            agg = self.paths.get(s.path)
            if agg is None:
                agg = self.paths[s.path] = [0, 0, 0]
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - s.children_ns
            if s.range is not None:
                self._append(Event(s.name, s.t0, t1, s.parent and s.parent.name, s.request))

    def copy(self) -> "Phase":
        """The aggregates as they stand now (no events)."""
        with self._lock:
            return Phase({k: list(v) for k, v in self.paths.items()}, dict(self.counters))

    def since(self, before: "Phase") -> "Phase":
        """The aggregates added after `before` (a `copy()`), without events."""
        now = self.copy()
        paths = {}
        for k, v in now.paths.items():
            old = before.paths.get(k, [0, 0, 0])
            if v[0] != old[0]:
                paths[k] = [a - b for a, b in zip(v, old)]
        counters = {k: v - before.counters.get(k, 0) for k, v in now.counters.items()
                    if v != before.counters.get(k, 0)}
        return Phase(paths, counters)

    def tree(self, prefix: str = "") -> dict:
        """The span tree of the paths whose outermost name starts with
        `prefix`: {name: {"count", "total_s", "self_s", "children": {...}}}."""
        out: dict = {}
        for path, (n, total, own) in self.copy().paths.items():
            if not path[0].startswith(prefix):
                continue
            level = out
            for name in path[:-1]:
                level = level.setdefault(name, {"children": {}})["children"]
            node = level.setdefault(path[-1], {"children": {}})
            node.update(count=n, total_s=total * 1e-9, self_s=own * 1e-9)
        return out


RECORDER = Phase()


def span(name: str, request: bool = False) -> _Span:
    """A span of the process's recorder (`Phase.__call__`)."""
    return RECORDER(name, request)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the process recorder's counter `name`."""
    RECORDER.count(name, n)


def phase_report(timers: Phase) -> str:
    """The span tree (count, total and self seconds, children indented under
    their parent, in the order first seen) and the counters."""
    first = {path: i for i, path in enumerate(timers.paths)}  # a child closes before its parent

    def place(path):
        return tuple(first[path[:i + 1]] for i in range(len(path)))

    lines = ["span timings (total, self):"]
    for path in sorted(timers.paths, key=place):
        n, total, own = timers.paths[path]
        name = "  " * len(path) + path[-1]
        lines.append(f"{name:<34} {total * 1e-9:8.3f}s  self {own * 1e-9:8.3f}s  ({n}x)")
    for name, n in timers.counters.items():
        lines.append(f"  counter {name:<24} {n}")
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
