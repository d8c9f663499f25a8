"""Host prepare's Elo work, seconds per season: the program's `weekend.elo`
spans (each race's Elo build) and `backtest.actuals` spans (each race's
actual results and their Elo updates) in the traced window, over its
seasons."""

from perfbench import program_spans


def read(run):
    return program_spans.per_unit(run, ("weekend.elo", "backtest.actuals"))
