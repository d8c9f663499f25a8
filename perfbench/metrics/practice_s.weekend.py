"""Host prepare's practice work, seconds per weekend: the program's
`weekend.session` (the session fallback chain, the weather),
`weekend.practice` (pace, tyre degradation, compound deltas, race
features, variance, DNF rates) and `weekend.params` (`SimParams`) spans in
the traced window, over its weekends."""

from perfbench import program_spans


def read(run):
    return program_spans.per_unit(run, ("weekend.session", "weekend.practice", "weekend.params"))
