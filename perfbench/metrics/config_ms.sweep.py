"""A configuration of the sweep, milliseconds: the mean of the program's
`tune.config` spans (one configuration over its seasons: the overrides,
the season launch and the host's wait for it, the scoring) in the traced
window. Nothing is read where the program has no such span."""

from perfbench import program_spans


def read(run):
    times = program_spans.span_seconds(run, ("tune.config",))
    return 1e3 * sum(times) / len(times) if times else None
