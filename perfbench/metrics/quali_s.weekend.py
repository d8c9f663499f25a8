"""Host prepare's qualifying model, seconds per weekend: the program's
`weekend.quali` spans (the Elo features and the qualifying grid, the
penalties) in the traced window, over its weekends."""

from perfbench import program_spans


def read(run):
    return program_spans.per_unit(run, ("weekend.quali",))
