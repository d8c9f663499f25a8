"""Build the race kernels ahead of the first run: the deployment step of the
PyTorch port (the JAX package's `precompile.py`).

The first CUDA run of a fresh checkout otherwise pays the nvcc builds of
`csrc/race_kernel.cu` (the race kernels) and `csrc/hmc_kernel.cu` (the
Bayesian fit's HMC transition) inside its first weekend, backtest or server
warmup. This step builds both libraries into the directory the kernels are
loaded from (`ops/_build.build_dir`: `build/kernels/` in the checkout, or
under `MCGP_COMPILE_CACHE`), so later processes on this machine only load
them:

    python -m monte_carlo_gp_torch.precompile
    python -m monte_carlo_gp_torch.precompile --season-races 20
    MCGP_COMPILE_CACHE=/srv/mcgp python -m monte_carlo_gp_torch.precompile

One library holds K1 (one race) and K2 (a season) for every field tier of
1 to 4 cars per lane, so one build serves every calendar race, field size
and simulation count. The step then launches K1 once on a dummy plan of
`--drivers` drivers through `F1Predictor.simulate_plan`, the path real
predictions take, and with `--season-races N` K2 once through
`simulate_season_plans`: a fault in the library shows here, not in the first
prediction.

The JAX package compiles one program per lap bucket (`bucket_specs`); the
port has no lap buckets (the lap count is a kernel argument), so there is
nothing to enumerate and no counterpart of `bucket_specs`. `--jobs` is
kept for the same command line: one nvcc build of one source has nothing
to split. `--engine xla` (the lap engine, plain PyTorch) builds nothing.
"""

from __future__ import annotations

import argparse
import sys
import time
from types import SimpleNamespace

from monte_carlo_gp_torch import config as cfg
from monte_carlo_gp_torch.utils.logging import log_event

# the dummy plan's race: a calendar circuit (any lap count runs the same kernel)
DUMMY_LAPS = int(cfg.CIRCUITS["Bahrain"]["laps"])


def _dummy_plan(n_drivers: int, total_laps: int):
    """A plan-shaped object with production shapes; its values are
    irrelevant (`monte_carlo_gp_tpu/precompile.py::_dummy_plan`)."""
    import numpy as np

    d = n_drivers
    params = cfg.make_sim_params(
        grid_probs=np.full((d, d), 1.0 / d, np.float32),
        base_pace=90.0 + 0.05 * np.arange(d),
        tire_deg=np.full(d, 0.05),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.001),
        team_dnf_rate=np.full(d, 0.002),
    )
    return SimpleNamespace(params=params, total_laps=int(total_laps))


def _bare_predictor(engine: str, device):
    """An F1Predictor with only what `simulate_plan` reads: no data loader."""
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    predictor = F1Predictor.__new__(F1Predictor)
    predictor.device = device
    predictor.engine = engine
    predictor.mesh = None
    predictor.last_effective_sims = None
    return predictor


def compile_one(
    total_laps: int, n_simulations: int, engine: str, n_drivers: int, device="cuda"
) -> float:
    """Run one weekend's Monte Carlo of a dummy plan through
    `F1Predictor.simulate_plan` on `device`. Returns its wall seconds."""
    from monte_carlo_gp_torch.models.predictor import resolve_device

    predictor = _bare_predictor(engine, resolve_device(device))
    t0 = time.perf_counter()
    predictor.simulate_plan(_dummy_plan(n_drivers, total_laps), n_simulations, seed=0)
    return time.perf_counter() - t0


def compile_season(
    n_races: int, n_simulations: int, engine: str, n_drivers: int, device="cuda"
) -> float:
    """Run a season of `n_races` dummy plans (the calendar's lap counts)
    through `simulate_season_plans`, the `backtest --batched` path: one K2
    launch. Returns its wall seconds."""
    from monte_carlo_gp_torch.models.predictor import resolve_device
    from monte_carlo_gp_torch.validate.backtest import simulate_season_plans

    laps = [int(i["laps"]) for i in cfg.CIRCUITS.values()]
    laps = (laps * (1 + n_races // len(laps)))[:n_races]
    plans = [_dummy_plan(n_drivers, lp) for lp in laps]
    predictor = _bare_predictor(engine, resolve_device(device))
    t0 = time.perf_counter()
    simulate_season_plans(predictor, plans, 0, n_simulations, engine=engine)
    return time.perf_counter() - t0


def precompile(
    n_simulations: int = 10_000,
    engine: str = "auto",
    n_drivers: int = 20,
    jobs: int = 3,
    season_races: int = 0,
    device: str = "cuda",
) -> int:
    """Build the race-kernel and HMC-kernel libraries (on a CUDA device)
    and run the race kernel programs once: K1 at `n_drivers`, and K2 for a
    season of `season_races` races when that is > 0. Returns the number of programs
    run (0 for the lap engine, which builds nothing). Raises without a CUDA
    device when `device` is "cuda", and when the build fails."""
    from monte_carlo_gp_torch.models.predictor import resolve_device, resolve_engine
    from monte_carlo_gp_torch.ops import hmc_kernel
    from monte_carlo_gp_torch.ops import race_kernel as rk

    dev = resolve_device(device)
    engine = resolve_engine(engine)
    if engine == "xla":
        log_event("precompile", programs=0, engine=engine, libraries=0, jobs=jobs)
        print("precompiled 0 kernel programs (xla: the lap engine is plain PyTorch, "
              "nothing to build)", flush=True)
        return 0
    t0 = time.perf_counter()
    libraries = 0
    if dev.type == "cuda":
        for lib in (rk, hmc_kernel):
            libraries += 0 if lib.is_built() else 1
            lib.build()
    k1, k2 = rk.race_counts.launches, rk.season_counts.launches
    compile_one(DUMMY_LAPS, n_simulations, engine, n_drivers, dev)
    n_programs = 1
    if season_races > 0:
        compile_season(season_races, n_simulations, engine, n_drivers, dev)
        n_programs += 1
    dt = time.perf_counter() - t0
    log_event(
        "precompile", programs=n_programs, engine=engine, device=dev.type,
        n_simulations=n_simulations, libraries=libraries, seconds=round(dt, 1), jobs=jobs,
        k1_launches=rk.race_counts.launches - k1, k2_launches=rk.season_counts.launches - k2,
    )
    print(
        f"precompiled {n_programs} kernel programs "
        f"({engine} on {dev.type}, {n_simulations} sims, {n_drivers} drivers; "
        f"{libraries} {'library' if libraries == 1 else 'libraries'} built) in {dt:.1f}s",
        flush=True,
    )
    return n_programs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m monte_carlo_gp_torch.precompile",
        description="Build the race kernels ahead of the first run and launch "
        "each once",
    )
    parser.add_argument("--simulations", type=int, default=10_000)
    parser.add_argument("--engine", choices=["auto", "xla", "pallas"], default="auto")
    parser.add_argument("--drivers", type=int, default=20)
    parser.add_argument(
        "--jobs", type=int, default=3,
        help="kept for the JAX package's command line; one nvcc build of one "
             "source has nothing to split",
    )
    parser.add_argument(
        "--season-races", type=int, default=0, metavar="N",
        help="also launch the season kernel on an N-race season (the "
             "`backtest --batched` path)",
    )
    parser.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="cuda builds the library and launches the kernels; cpu runs "
             "their plain PyTorch versions and builds nothing",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return precompile(
            n_simulations=args.simulations, engine=args.engine, n_drivers=args.drivers,
            jobs=args.jobs, season_races=args.season_races, device=args.device,
        )
    except RuntimeError as e:  # no CUDA device, or the build failed
        sys.exit(f"Error: {e}")


if __name__ == "__main__":
    main()
