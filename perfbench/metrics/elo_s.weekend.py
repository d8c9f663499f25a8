"""Host prepare's Elo build, seconds per weekend: the program's
`weekend.elo` spans (the seasons' loads and the Elo updates of
`prepare_weekend`) in the traced window, over its weekends."""

from perfbench import program_spans


def read(run):
    return program_spans.per_unit(run, ("weekend.elo",))
