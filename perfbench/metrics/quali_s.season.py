"""Host prepare's qualifying model, seconds per season: the program's
`weekend.quali` spans in the traced window (with the Bayesian model, each
race's fit inside), over its seasons."""

from perfbench import program_spans


def read(run):
    return program_spans.per_unit(run, ("weekend.quali",))
