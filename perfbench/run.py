"""The benchmark's command: one run of one cell on this machine's cards.

    python -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and the numbers compared with the reference under `checks`, last), and the
compared numbers with their limits as the last lines of standard error. It
exits 1 without a result where the cell's cards are missing, where the
program cannot be imported from the checkout, or where JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import sys

from perfbench import harness, spec


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m perfbench", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    return 1


def main(argv: list[str], t0: float) -> int:
    args = parse(argv)
    try:
        cell = spec.find_cell(harness.ROOT, args.workload)
    except (spec.SpecError, KeyError) as e:
        return fail(str(e))
    try:
        harness.check_program_here()
    except (ImportError, RuntimeError) as e:
        return fail(f"the program cannot be run from this checkout: {e}")
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, this machine has "
                    f"{torch.cuda.device_count()}")
    line, checks, run = harness.run_cell(args.workload, args.seed, args.seconds,
                                         bool(args.trace), t0=t0)
    found = harness.forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}")
    print(harness.dumps(line), flush=True)
    print(f"card: {run.state.get('device_name')}, power limit {run.state.get('power_limit')}",
          file=sys.stderr)
    for text in run.stderr + harness.check_lines(checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0
