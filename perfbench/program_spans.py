"""The program's own spans and counters in a traced run: the events its
recorder (`monte_carlo_gp_torch.utils.profiling.RECORDER`) kept while a
profile recorded, from the run's start (`Run.t0`) on. The drivers of the
`weekend` and `season` kinds profile the window alone, so these are the
window's. A program without such a recorder gives nothing, and a reader
then returns None.
"""

from __future__ import annotations


def events(run) -> list | None:
    """The recorder's events of this run; None where the program keeps none,
    kept none, or dropped some (its list is bounded)."""
    try:
        from monte_carlo_gp_torch.utils.profiling import RECORDER

        recorded, dropped = list(RECORDER.events), RECORDER.dropped
    except (ImportError, AttributeError):
        return None
    since = run.t0 * 1e9  # `time.perf_counter` and `perf_counter_ns` share a clock
    kept = [e for e in recorded if e.start_ns >= since]
    return kept if kept and not dropped else None


def span_seconds(run, names: tuple[str, ...]) -> list[float] | None:
    """The seconds of each span of this run named one of `names`; None
    where there is none."""
    found = events(run)
    times = [(e.end_ns - e.start_ns) * 1e-9 for e in found or () if e.name in names]
    return times or None


def per_unit(run, names: tuple[str, ...]) -> float | None:
    """The seconds of the spans named one of `names`, summed, per unit of
    the window."""
    times = span_seconds(run, names)
    return sum(times) / len(run.units) if times and run.units else None


def counted_per_unit(run, name: str) -> float | None:
    """The counter `name`'s increments in this run, per unit of the window
    (0 where the program recorded spans but never counted it)."""
    found = events(run)
    if not found or not run.units:
        return None
    return sum(e.n for e in found if e.name == name) / len(run.units)
