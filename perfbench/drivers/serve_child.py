"""The server of a `serve` cell, run as a child process so that the client's
threads do not share its interpreter lock: the program's
`PredictionService` behind the program's HTTP handler (`serve.make_handler`)
in the `HTTPServer` that `serve.py` builds (its accept backlog of 5
included), on a free port of 127.0.0.1, warmed (`PredictionService.warmup`)
for the traffic's one weekend at the cell's simulations.

    python -m perfbench.drivers.serve_child --cache DIR --config FILE
        --traffic FILE --trace 0|1 --out FILE

It prints `ready <port>` when it serves. Commands on standard input:
`start` opens the measured window (with `--trace 1`, a `torch.profiler`
profile; it answers `started`), `stop` closes it, writes what it measured
(memory peak, requests served, the trace) as JSON to `--out`, and exits.
Requests and commands are handled by one thread, the serving thread.
"""

from __future__ import annotations

import argparse
import json
import selectors
import sys
from http.server import HTTPServer


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--cache", required=True)
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    on_card = args.device == "cuda"
    config = json.loads(open(args.config).read())
    traffic = json.loads(open(args.traffic).read())

    from perfbench import harness, trace

    harness.program_env()
    import torch

    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.serve import PredictionService, make_handler

    predictor = F1Predictor(cache_dir=args.cache, offline=True, device=args.device,
                            quali_model=config["quali_model"], engine=config["engine"])
    service = PredictionService(predictor, default_simulations=traffic["n_simulations"])
    service.warmup(traffic["season"], traffic["race"], traffic["prediction_point"])
    predict = service.predict

    def traced_predict(request):
        with torch.profiler.record_function("request"):
            return predict(request)

    service.predict = traced_predict
    server = HTTPServer(("127.0.0.1", 0), make_handler(service))  # as serve.py builds it
    print(f"ready {server.server_address[1]}", flush=True)

    sel = selectors.DefaultSelector()
    sel.register(server.socket, selectors.EVENT_READ, "http")
    sel.register(sys.stdin, selectors.EVENT_READ, "command")
    prof = window = None
    served = 0
    try:
        while True:
            for key, _ in sel.select():
                if key.data == "http":
                    server.handle_request()
                    continue
                command = sys.stdin.readline().strip()
                if command == "start":
                    if args.trace:
                        prof = trace.profiled(True, on_card)
                        profile = prof.__enter__()
                        window = torch.profiler.record_function(trace.WINDOW)
                        window.__enter__()
                    served = service.stats["requests"]
                    print("started", flush=True)
                elif command in ("stop", ""):
                    if on_card:
                        torch.cuda.synchronize()
                    served = service.stats["requests"] - served
                    summary = None
                    if prof is not None:
                        window.__exit__(None, None, None)
                        prof.__exit__(None, None, None)
                        summary = trace.from_profile(profile, {"request"}, on_card).as_dict()
                    out = {
                        "memory_peak_bytes": torch.cuda.max_memory_allocated() if on_card else 0,
                        "device_name": torch.cuda.get_device_name(0) if on_card else args.device,
                        "requests": served,
                        "stats": dict(service.stats),
                        "trace": summary,
                        "forbidden": harness.forbidden_modules(),
                    }
                    with open(args.out, "w") as f:
                        json.dump(out, f)
                    return 0
    finally:
        server.server_close()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
