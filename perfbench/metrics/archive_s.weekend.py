"""Host prepare's feature-archive build, seconds per weekend: the program's
`weekend.archive` spans (`feature_engine.load_historical_data`) in the
traced window, over its weekends."""

from perfbench import program_spans


def read(run):
    return program_spans.per_unit(run, ("weekend.archive",))
