"""Tune event-model parameters against historical results with the PyTorch
port: sweep simulation scalars (safety-car rate, DRS delta, variance
scale, ...) over a grid and rank configurations by backtest metric.

The flags and the table are those of the JAX package's `tune.py`, with
`--device` added (`cuda`, the default, runs the season kernel and exits
non-zero without a CUDA device; `cpu` runs its plain PyTorch version);
`--engine xla` runs the lap engine instead. The host preparation runs once
and every configuration reuses it under common random numbers (see
monte_carlo_gp_torch/validate/tune.py).

    python -m monte_carlo_gp_torch.tune --seasons 2024 --synthetic \
        --grid sc_prob=0.005,0.01,0.02 --grid variance_scale=0.8,1.0,1.25

The sweep records the spans `tune.sweep` (the whole call), `tune.prepare`
(each season's walk-forward preparation), `tune.config` (one configuration
over its seasons) with `tune.overrides`, `backtest.simulate` and
`tune.score` inside it, and `tune.rank` (the sort), and the counter
`tune.configs` (one per configuration evaluated, the default included), in
the process's recorder (`utils/profiling.py`).
"""

from __future__ import annotations

import argparse
import sys


def parse_grid(specs: list[str]) -> dict[str, list[float]]:
    grid: dict[str, list[float]] = {}
    for spec in specs:
        key, _, values = spec.partition("=")
        if not values:
            raise SystemExit(
                f"--grid expects KEY=V1,V2,... (got {spec!r})"
            )
        key = key.strip()
        try:
            parsed = [float(v) for v in values.split(",") if v.strip()]
        except ValueError:
            raise SystemExit(f"--grid {spec!r}: values must be numbers")
        if not parsed:
            raise SystemExit(f"--grid {spec!r}: no values")
        # A repeated axis extends it (dedup, order-preserving) rather than
        # silently replacing the earlier values.
        merged = list(dict.fromkeys(grid.get(key, []) + parsed))
        grid[key] = merged
    return grid


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m monte_carlo_gp_torch.tune",
        description="Sweep simulation parameters against backtest metrics",
    )
    parser.add_argument("--seasons", type=int, nargs="+", default=[2024])
    parser.add_argument(
        "--grid", action="append", default=[], metavar="KEY=V1,V2,...",
        help="Sweep axis (repeatable; configs are the Cartesian product). "
             "Keys: SimParams scalars (sc_prob, vsc_prob, red_flag_prob, "
             "drs_delta, overtake_delta, pit_loss, dirty_air_threshold, "
             "dirty_air_penalty) or *_scale multipliers (variance_scale, "
             "tire_deg_scale, dnf_scale, team_dnf_scale)",
    )
    parser.add_argument(
        # pole_brier is not offered: race-sim scalars cannot affect quali
        # probabilities, so it is identical across configs (sweep_backtest
        # rejects it; it is still reported on every record).
        "--metric", choices=["win_brier", "podium_accuracy"],
        default="win_brier",
    )
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--simulations", type=int, default=10000)
    parser.add_argument("--offline", action="store_true",
                        help="Serve everything from the local cache")
    parser.add_argument("--cache-dir", type=str, default="./cache")
    parser.add_argument("--synthetic", action="store_true",
                        help="Use the deterministic synthetic data backend")
    parser.add_argument("--synthetic-seed", type=int, default=2718)
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where the season Monte Carlo runs: the CUDA kernel (cuda) or "
             "its plain PyTorch version (cpu)",
    )
    parser.add_argument(
        "--engine", choices=["auto", "xla", "pallas"], default="auto",
        help="Simulation backend: the race kernels (pallas; CUDA on --device "
             "cuda, their plain PyTorch versions on cpu) or the lap engine "
             "(xla); auto = pallas. Every visible CUDA device takes a share "
             "of the simulations",
    )
    return parser


def run(argv: list[str] | None = None) -> dict:
    """Run the CLI on `argv`; returns the sweep's result dict."""
    args = build_parser().parse_args(argv)
    if not args.grid:
        raise SystemExit("at least one --grid KEY=V1,V2,... is required")
    grid = parse_grid(args.grid)

    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.validate.tune import sweep_backtest

    def predictor_factory():
        backend = None
        if args.synthetic:
            from monte_carlo_gp_torch.data.synthetic import SyntheticBackend

            backend = SyntheticBackend(seed=args.synthetic_seed)
        return F1Predictor(
            cache_dir=args.cache_dir, offline=args.offline, backend=backend,
            device=args.device, engine=args.engine,
        )

    try:
        # refuses --device cuda without a CUDA device, before any work
        predictor_factory()
    except RuntimeError as e:
        sys.exit(f"Error: {e}")

    n_configs = 1
    for vals in grid.values():
        n_configs *= len(vals)
    print(f"\n{'='*60}")
    print("Parameter sweep")
    print(f"Seasons: {args.seasons} | configs: {n_configs} | "
          f"metric: {args.metric}")
    print(f"{'='*60}\n")

    out = sweep_backtest(
        predictor_factory,
        args.seasons,
        grid,
        seed=args.seed,
        n_simulations=args.simulations,
        metric=args.metric,
    )

    keys = list(grid)
    header = " | ".join(f"{k:>18}" for k in keys)
    print(f"{header} | {'win_brier':>9} | {'pole_brier':>10} | {'podium':>6}")
    print("-" * (21 * len(keys) + 32))
    for rec in out["results"]:
        cells = " | ".join(f"{rec['overrides'][k]:>18g}" for k in keys)
        print(f"{cells} | {rec['win_brier']:>9.4f} | "
              f"{rec['pole_brier']:>10.4f} | {rec['podium_accuracy']:>6.1%}")

    best = out["best"]
    print(f"\nBest by {args.metric}: {best['overrides']} "
          f"-> {best[args.metric]:.4f}")
    if out["default"] is not None:
        d = out["default"]
        print(f"Default (no overrides):{'':<15} -> {d[args.metric]:.4f}")
        delta = best[args.metric] - d[args.metric]
        sign = "improves" if (
            delta < 0 if args.metric != "podium_accuracy" else delta > 0
        ) else "does not improve"
        print(f"Best config {sign} on the default by {abs(delta):.4f}")
    print(f"\n{'='*60}")
    print("Sweep complete!")
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
