"""The server's milliseconds per request: the mean of the `server.latency_s`
the program writes into each response body (`PredictionService.predict`,
from validation to the assembled result), over the traced window's
requests."""


def read(run):
    times = run.samples.get("server_latency_s")
    return 1e3 * sum(times) / len(times) if times else None
