"""Host prepare's seconds per weekend: the mean of the harness span around
`F1Predictor` construction and `prepare_weekend` in the traced window."""


def read(run):
    times = run.spans.times.get("prepare")
    return sum(times) / len(times) if times else None
