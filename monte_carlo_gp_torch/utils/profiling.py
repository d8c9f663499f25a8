"""Per-phase wall-clock counters the CLI prints with `--timings`."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class Phase:
    """Accumulating named wall-clock timers.

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
