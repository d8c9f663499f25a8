"""The Bayesian fit's milliseconds: the mean of the program's `fit` spans
(`BayesianQualiModel.fit`: the design, the chains on the card, the
posterior) in the traced window. Nothing is read where no fit ran."""

from perfbench import program_spans


def read(run):
    times = program_spans.span_seconds(run, ("fit",))
    return 1e3 * sum(times) / len(times) if times else None
