"""Host prepare's seconds per season: the mean of the harness span around
`prepare_season_plans` (with the Bayesian model, its 20 fits) in the
traced window."""


def read(run):
    times = run.spans.times.get("season.prepare")
    return sum(times) / len(times) if times else None
