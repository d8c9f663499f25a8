"""The Bayesian fit's batching, fits per season: the program's `fit.batched`
counter (raised by the number of fits in each schedule that fits several
designs together) in the traced window, over its seasons. Nothing is read
where the program never counted it (a program that fits race by race)."""

from perfbench import program_spans


def read(run):
    found = program_spans.events(run)
    if not found or not any(e.name == "fit.batched" for e in found):
        return None
    return program_spans.counted_per_unit(run, "fit.batched")
