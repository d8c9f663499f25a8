"""Run F1 race predictions with the PyTorch port.

The flags and printed sections are those of the JAX package's `main.py`,
with `--device` added. The race Monte Carlo runs the CUDA kernel on
`--device cuda` (the default; it exits non-zero when no CUDA device is
present) and its plain PyTorch version on `--device cpu`; `--engine xla`
runs the lap engine instead. On several CUDA devices each takes a share of
the simulations, and the result is bitwise that of one device.

Examples:
    python -m monte_carlo_gp_torch --race Bahrain --season 2024 --synthetic
    python -m monte_carlo_gp_torch --race Bahrain --season 2024 --synthetic --device cpu
    python -m monte_carlo_gp_torch --race Bahrain --season 2024 --synthetic --engine xla
    python -m monte_carlo_gp_torch --race Monaco --prediction-point fp3 --simulations 100000
    python -m monte_carlo_gp_torch --race Bahrain --season 2024 --synthetic --trace traces/
    python -m monte_carlo_gp_torch --build-cache --seasons 2023 2024
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m monte_carlo_gp_torch", description="F1 Race Prediction"
    )
    parser.add_argument("--season", type=int, default=2025, help="Season year")
    parser.add_argument("--race", type=str, help='Race name (e.g., "Abu Dhabi")')
    parser.add_argument(
        "--prediction-point",
        type=str,
        default="fp2",
        choices=["fp1", "fp2", "fp3", "quali", "sprint"],
        help="When to predict from (default: fp2)",
    )
    parser.add_argument(
        "--simulations",
        type=int,
        default=10000,
        help="Number of Monte Carlo simulations (default: 10000)",
    )
    parser.add_argument("--seed", type=int, default=None, help="Simulation seed")
    parser.add_argument(
        "--offline", action="store_true",
        help="Serve everything from the local cache; never touch the network",
    )
    parser.add_argument(
        "--build-cache", action="store_true",
        help="Download and persist session data for --seasons, then exit",
    )
    parser.add_argument(
        "--seasons", type=int, nargs="+", default=None,
        help="Seasons for --build-cache",
    )
    parser.add_argument("--cache-dir", type=str, default="./cache")
    parser.add_argument(
        "--elo-cache", type=str, default=None,
        help="External Elo ratings cache (highest priority)",
    )
    parser.add_argument(
        "--use-elo-cache", action="store_true",
        help="Load/persist Elo ratings from the local cache",
    )
    parser.add_argument(
        "--synthetic", action="store_true",
        help="Use the deterministic synthetic data backend (demo, no network)",
    )
    parser.add_argument("--synthetic-seed", type=int, default=2718)
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where the race Monte Carlo runs: the CUDA kernel (cuda) or its "
             "plain PyTorch version (cpu)",
    )
    parser.add_argument(
        "--engine", choices=["auto", "xla", "pallas"], default="auto",
        help="Simulation backend: the race kernels (pallas; CUDA on --device "
             "cuda, their plain PyTorch versions on cpu) or the lap engine "
             "(xla); auto = pallas. Every visible CUDA device takes a share "
             "of the simulations",
    )
    parser.add_argument(
        "--quali-model", choices=["elo", "bayesian", "gbm"], default="elo",
        help="Qualifying model: Elo, the Bayesian hierarchical model (HMC on "
             "--device) or gradient boosting (needs scikit-learn)",
    )
    parser.add_argument(
        "--rookie-prior", action="store_true",
        help="Seed unrated (rookie) drivers from a teammate-average Elo "
             "prior instead of the flat initial rating",
    )
    parser.add_argument(
        "--safe", action="store_true",
        help="Degrade to uniform fallback predictions when the weekend has "
             "no usable data instead of exiting with an error",
    )
    parser.add_argument(
        "--trace", type=str, default=None, metavar="DIR",
        help="Write a profiler trace of the prediction to DIR (torch.profiler; "
             "TensorBoard's profile plugin and Perfetto open it)",
    )
    parser.add_argument(
        "--timings", action="store_true",
        help="Print the span tree (count, total and self seconds) and the frame counters",
    )
    return parser


def build_predictor(args):
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    backend = None
    if args.synthetic:
        from monte_carlo_gp_torch.data.synthetic import SyntheticBackend

        backend = SyntheticBackend(seed=args.synthetic_seed)
    return F1Predictor(
        cache_dir=args.cache_dir,
        offline=args.offline,
        backend=backend,
        external_elo_cache=args.elo_cache,
        use_elo_cache=args.use_elo_cache or args.offline,
        device=args.device,
        rookie_prior=args.rookie_prior,
        quali_model=args.quali_model,
        engine=args.engine,
    )


def run(argv: list[str] | None = None):
    """Run the CLI on `argv`; returns (result dict, the spans and counters
    this run added to the process's recorder), the result being None for
    --build-cache."""
    from monte_carlo_gp_torch.utils.profiling import RECORDER, TraceError, phase_report, trace

    before = RECORDER.copy()
    parser = build_parser()
    args = parser.parse_args(argv)

    if not args.race and not args.build_cache:
        parser.error("--race is required unless --build-cache is given")
    try:
        # refuses --device cuda without a CUDA device, and gbm without
        # scikit-learn
        predictor = build_predictor(args)
    except (RuntimeError, ImportError) as e:
        sys.exit(f"Error: {e}")

    if args.build_cache:
        seasons = args.seasons or [args.season - 1, args.season]
        n = predictor.data_loader.build_cache(seasons)
        print(f"Cached {n} session artifacts for seasons {seasons} "
              f"under {args.cache_dir}")
        return None, RECORDER.since(before)

    print(f"\n{'='*60}")
    print(f"F1 Race Prediction: {args.season} {args.race}")
    print(f"Prediction point: {args.prediction_point}")
    print(f"{'='*60}\n")

    print("Loading data and running simulations...")
    builds_kernel = False
    if args.device == "cuda" and predictor.engine == "pallas":
        from monte_carlo_gp_torch.ops import race_kernel

        builds_kernel = not race_kernel.is_built()
    try:
        with trace(args.trace, predictor.device) as traced:
            plan = predictor.prepare_weekend(
                season=args.season,
                race=args.race,
                prediction_point=args.prediction_point,
            )
            probs = predictor.simulate_plan(plan, args.simulations, args.seed)
            results = predictor.assemble_result(plan, probs)
    except ValueError as e:
        from monte_carlo_gp_torch.models.safety import (
            InsufficientDataError,
            generate_fallback_predictions,
        )

        if args.safe and isinstance(e, InsufficientDataError):
            from monte_carlo_gp_torch.utils.logging import log_event

            print(f"Warning: {e}, using fallback predictions")
            log_event(
                "prediction_fallback",
                season=args.season, race=args.race, reason=str(e),
            )
            results = generate_fallback_predictions(
                args.season, args.race, args.prediction_point
            )
        else:
            print(f"Error: {e}")
            sys.exit(1)
    except TraceError as e:
        sys.exit(f"Error: {e}")
    if traced is not None and traced.path is not None:
        print(f"Trace: {traced.path} ({traced.device_events} device events)")
    timers = RECORDER.since(before)
    if args.timings:
        print()
        print(phase_report(timers))
        sim_t = timers.totals.get("weekend.simulate", 0.0)
        if sim_t > 0.0:  # absent when --safe degraded before simulating
            sims_per_s = args.simulations / sim_t
            note = " (includes the kernel build)" if builds_kernel else ""
            print(f"  {sims_per_s:,.0f} sims/sec on {args.device}{note}")

    print(f"\nWeather: {'Wet' if results['weather'].get('rainfall') else 'Dry'}")
    print(f"Track temp: {results['weather'].get('track_temp', 'N/A')}C")
    print(f"Confidence: {results['confidence']}\n")

    for title, key in (
        ("POLE POSITION PROBABILITIES", "pole_probabilities"),
        ("RACE WINNER PROBABILITIES", "win_probabilities"),
        ("PODIUM PROBABILITIES", "podium_probabilities"),
    ):
        print(title)
        print("-" * 40)
        ranked = sorted(results[key].items(), key=lambda kv: kv[1], reverse=True)
        for i, (driver, prob) in enumerate(ranked[:10], 1):
            bar = "#" * int(prob * 30)
            print(f"{i:2}. {driver:4} {prob:6.1%} {bar}")
        print()

    print(f"{'='*60}")
    print("Prediction complete!")
    return results, timers


def main() -> None:
    run()


if __name__ == "__main__":
    main()
