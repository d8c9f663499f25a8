"""The Monte Carlo wrappers' milliseconds per weekend: the mean of the
harness span around `simulate_plan` (it returns host arrays, so the span
ends after the copy back) in the traced window."""


def read(run):
    times = run.spans.times.get("simulate")
    return 1e3 * sum(times) / len(times) if times else None
