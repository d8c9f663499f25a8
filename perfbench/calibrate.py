"""The readings the correctness limits are set from: for each seed, one
short run of a cell, the worst gap of each compared number between the
program and the reference (the lower readings) and, with `--control`,
between the control and the reference (the upper readings). One JSON line
per seed.

    python -m perfbench.calibrate --workload <name> --seeds 1,2,3 --seconds 8 [--control]
"""

from __future__ import annotations

import argparse
import json
import sys

from perfbench import harness


def main(argv: list[str]) -> int:
    p = argparse.ArgumentParser(prog="python -m perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.calibrate(args.workload, seed, args.seconds, control=args.control)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
