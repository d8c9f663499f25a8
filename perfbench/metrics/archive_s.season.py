"""Host prepare's feature-archive builds, seconds per season: the program's
`weekend.archive` spans (one per race, the loader's clock moving with the
walk-forward) in the traced window, over its seasons."""

from perfbench import program_spans


def read(run):
    return program_spans.per_unit(run, ("weekend.archive",))
