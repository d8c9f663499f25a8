"""Backtest the F1 prediction model against historical results with the
PyTorch port.

The flags and printed sections are those of the JAX package's
`backtest.py`, with `--device` added: the race Monte Carlo runs the CUDA
kernels on `--device cuda` (the default; it exits non-zero when no CUDA
device is present) and their plain PyTorch versions on `--device cpu`;
`--engine xla` runs the lap engine instead. `--batched` runs each season's
races in one launch of the season kernel (one per CUDA device when there
are several, each with a share of every race's simulations).

Examples:
    python -m monte_carlo_gp_torch.backtest --synthetic --seasons 2024 --batched
    python -m monte_carlo_gp_torch.backtest --synthetic --seasons 2024 --batched --engine xla
    python -m monte_carlo_gp_torch.backtest --synthetic --seasons 2024 --device cpu \
        --simulations 2048 --checkpoint progress.jsonl
"""

from __future__ import annotations

import argparse
import sys


def interpret_brier(score: float) -> str:
    if score < 0.1:
        return "Excellent"
    if score < 0.15:
        return "Good"
    if score < 0.2:
        return "Fair"
    if score < 0.25:
        return "Poor"
    return "Bad"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m monte_carlo_gp_torch.backtest",
        description="Backtest F1 Predictions",
    )
    parser.add_argument(
        "--seasons", type=int, nargs="+", default=[2024],
        help="Seasons to backtest (e.g., --seasons 2023 2024)",
    )
    parser.add_argument(
        "--seed", type=int, default=42, help="Random seed for reproducibility"
    )
    parser.add_argument(
        "--simulations", type=int, default=10000,
        help="Monte Carlo simulations per race (default: 10000)",
    )
    parser.add_argument("--offline", action="store_true",
                        help="Serve everything from the local cache")
    parser.add_argument("--cache-dir", type=str, default="./cache")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="JSONL progress file; resumes if it exists")
    parser.add_argument("--synthetic", action="store_true",
                        help="Use the deterministic synthetic data backend")
    parser.add_argument("--synthetic-seed", type=int, default=2718)
    parser.add_argument(
        "--batched", action="store_true",
        help="Simulate every race of a season in one launch of the season kernel",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="Where the race Monte Carlo runs: the CUDA kernels (cuda) or "
             "their plain PyTorch versions (cpu)",
    )
    parser.add_argument(
        "--engine", choices=["auto", "xla", "pallas"], default="auto",
        help="Simulation backend: the race kernels (pallas; CUDA on --device "
             "cuda, their plain PyTorch versions on cpu) or the lap engine "
             "(xla); auto = pallas. Every visible CUDA device takes a share "
             "of the simulations",
    )
    parser.add_argument(
        "--reference-compat-elo-noop", action="store_true",
        help="Reproduce the reference defect where actual-result Elo updates "
             "silently no-op (SURVEY.md §3.2), for A/B comparison",
    )
    parser.add_argument(
        "--rookie-prior", action="store_true",
        help="Seed unrated (rookie) drivers from a teammate-average Elo "
             "prior instead of the flat initial rating",
    )
    parser.add_argument(
        "--quali-model", choices=["elo", "bayesian", "gbm"], default="elo",
        help="Qualifying model; only 'elo' is ported so far",
    )
    return parser


def predictor_factory_for(args):
    """A zero-argument factory of fresh predictors configured by `args`."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    def predictor_factory():
        backend = None
        if args.synthetic:
            from monte_carlo_gp_torch.data.synthetic import SyntheticBackend

            backend = SyntheticBackend(seed=args.synthetic_seed)
        return F1Predictor(
            cache_dir=args.cache_dir, offline=args.offline, backend=backend,
            device=args.device, rookie_prior=args.rookie_prior,
            quali_model=args.quali_model, engine=args.engine,
        )

    return predictor_factory


def run(argv: list[str] | None = None) -> dict:
    """Run the CLI on `argv`; returns the backtest's result dict."""
    parser = build_parser()
    args = parser.parse_args(argv)

    from monte_carlo_gp_torch.validate.backtest import (
        backtest_model,
        backtest_model_batched,
    )
    from monte_carlo_gp_torch.validate.metrics import RANDOM_BRIER_BASELINE

    predictor_factory = predictor_factory_for(args)
    try:
        # refuses --device cuda without a CUDA device, and the quali models
        # not yet ported, before any work
        predictor_factory()
    except (RuntimeError, NotImplementedError) as e:
        sys.exit(f"Error: {e}")

    print(f"\n{'='*60}")
    print("Backtesting F1 Prediction Model")
    print(f"Seasons: {args.seasons}")
    print(f"{'='*60}\n")

    print("Running backtest (this may take several minutes)...")
    print("Loading historical data and simulating predictions...\n")

    if args.batched and args.checkpoint:
        parser.error(
            "--checkpoint is not supported with --batched (the single-"
            "launch season path has no per-race progress to record); "
            "drop --batched to get resumable checkpoints"
        )
    if args.batched:
        results = backtest_model_batched(
            predictor_factory,
            args.seasons,
            seed=args.seed,
            n_simulations=args.simulations,
            reference_compat_elo_noop=args.reference_compat_elo_noop,
        )
    else:
        results = backtest_model(
            predictor_factory,
            args.seasons,
            seed=args.seed,
            n_simulations=args.simulations,
            checkpoint_path=args.checkpoint,
            reference_compat_elo_noop=args.reference_compat_elo_noop,
        )

    print(f"{'='*60}")
    print("BACKTEST RESULTS")
    print(f"{'='*60}\n")
    print(f"Races analyzed: {results['n_races']}")
    print()

    print("BRIER SCORES (lower = better, 0 = perfect)")
    print("-" * 40)
    pole_brier = results["pole_brier"]
    win_brier = results["win_brier"]
    print(f"  Pole position: {pole_brier:.4f} ({interpret_brier(pole_brier)})")
    print(f"  Race winner:   {win_brier:.4f} ({interpret_brier(win_brier)})")
    print()

    random_brier = RANDOM_BRIER_BASELINE
    print(f"  (Random baseline: {random_brier:.4f})")
    print(f"  Pole improvement vs random: "
          f"{(random_brier - pole_brier) / random_brier * 100:.1f}%")
    print(f"  Win improvement vs random:  "
          f"{(random_brier - win_brier) / random_brier * 100:.1f}%")
    print()

    print("PODIUM ACCURACY")
    print("-" * 40)
    print(f"  Correct podium picks: {results['podium_accuracy']:.1%}")
    print("  (Random baseline: ~15%)")
    print()

    calibration = results["calibration_curve"]
    if calibration["prob_true"] and calibration["prob_pred"]:
        print("CALIBRATION (predicted vs actual probability)")
        print("-" * 40)
        for pred, actual in zip(calibration["prob_pred"], calibration["prob_true"]):
            print(f"  Pred {pred:.0%}: {'#' * int(pred * 50)}")
            print(f"  True {actual:.0%}: {'*' * int(actual * 50)}")
            print()
    else:
        print("(Not enough data for calibration analysis)")

    print(f"{'='*60}")
    print("Backtest complete!")
    print()
    print("Interpretation:")
    print("- Brier < 0.15: Model adds value over random guessing")
    print("- Podium > 33%: Model predicts podium better than chance")
    print("- Good calibration: Predicted % matches actual win rate")
    return results


def main() -> None:
    run()


if __name__ == "__main__":
    main()
