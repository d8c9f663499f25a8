"""Golden counts of the race kernels: K1 and K2 on fixed inputs, bit for bit.

`tests/data/torch_kernel_golden.npz` holds the int32 (D, D) and (R, D, D)
histograms that the CUDA kernels gave at 65,536 simulations per race on six
cases, with the one input that takes the host layer to make (the synthetic
2024 season, packed):

  * K1, 57 laps, seed 123: D = 20, the Bahrain 2024 plan
    (`tests/data/torch_plan_bahrain2024.npz`); D = 40, 80 and 128, the wide
    field of `profile_kernel.wide_field`;
  * K2: the synthetic 2024 season (20 races of 20 drivers, 44 to 78 laps),
    race r at `fold_in(42 * 1_000_003 + 2024, r)`; and the wide season of
    `chip_smoke.py`: the same lap counts with fields of 80, 64, 40 and 20
    drivers in turn, padded to 80, race r at `fold_in(4242, r)`.

A change to the race body that keeps its arithmetic (the draws, every float32
operation in its order) gives these counts exactly, whatever it does to the
schedule. On a CUDA card:

    python -m monte_carlo_gp_torch.validate.golden          # check, exit 1 on a difference
    python -m monte_carlo_gp_torch.validate.golden --write PATH

`--device cpu` runs the plain version instead (at a few simulations, with
`--sims`, to rehearse the script: its counts are not the file's).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from monte_carlo_gp_torch.config import sim_params_from_numpy
from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.ops import race_kernel as rk

ROOT = Path(__file__).resolve().parents[2]
GOLDEN = ROOT / "tests" / "data" / "torch_kernel_golden.npz"
PLAN_FIXTURE = ROOT / "tests" / "data" / "torch_plan_bahrain2024.npz"

SIMS, LAPS, K1_SEED = 65_536, 57, 123
K1_WIDTHS = (20, 40, 80, 128)
SEASON, SYNTHETIC_SEED = 2024, 2718
SEASON_SEED = 42 * 1_000_003 + SEASON
WIDE_SEASON_WIDTHS, WIDE_SEASON_SEED = (80, 64, 40, 20), 4242
CASES = (*(f"k1_d{d}" for d in K1_WIDTHS), "k2_season2024", "k2_wide_season")


def plan_fixture_params(device):
    """The Bahrain 2024 plan's SimParams (20 drivers) and its lap count."""
    with np.load(PLAN_FIXTURE) as f:
        fields = {k: f[k] for k in f.files}
    return sim_params_from_numpy(fields, device), int(fields["total_laps"])


def wide_field(d: int, device):
    from monte_carlo_gp_torch.profile_kernel import wide_field as field

    return field(d, device)


def synthetic_season(device) -> dict[str, np.ndarray]:
    """The synthetic 2024 season's packed inputs, lap counts and seeds,
    prepared walk-forward by the host layer."""
    import tempfile

    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.validate import backtest as bt

    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as cache:
        predictor = F1Predictor(cache_dir=cache, backend=SyntheticBackend(seed=SYNTHETIC_SEED),
                                device=device)
        plans, _ = bt.prepare_season_plans(predictor, SEASON, verbose=False)
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs([p.params for p in plans])
    return {
        "season2024_pmat": pmat_s.cpu().numpy(),
        "season2024_scal": scal_s.cpu().numpy(),
        "season2024_grid_log": grid_log_s.cpu().numpy(),
        "season2024_laps": np.array([p.total_laps for p in plans], np.int32),
    }


def case_inputs(name: str, device, season: dict[str, np.ndarray]):
    """(launch, its arguments but the simulation count) of one case:
    K1 `race_counts` or K2 `season_counts` on `device`."""
    laps = [int(x) for x in season["season2024_laps"]]
    if name.startswith("k1_d"):
        d = int(name[4:])
        params, n_laps = plan_fixture_params(device) if d == 20 else (wide_field(d, device), LAPS)
        return rk.race_counts, (*rk.pack_inputs(params), n_laps)
    if name == "k2_season2024":
        inputs = [torch.from_numpy(season[f"season2024_{k}"]).to(device)
                  for k in ("pmat", "scal", "grid_log")]
        seeds = [philox.fold_in(SEASON_SEED, r) for r in range(len(laps))]
        return rk.season_counts, (*inputs, laps, seeds)
    if name == "k2_wide_season":
        return rk.season_counts, padded_season(WIDE_SEASON_WIDTHS, laps, device)
    raise ValueError(f"no golden case {name!r}; the cases are {CASES}")


def padded_season(widths, laps: list[int], device, seed: int = WIDE_SEASON_SEED):
    """K2's arguments but the simulation count for a season of `laps` with
    wide fields of `widths` drivers in turn, padded to the widest, race r
    at `fold_in(seed, r)`."""
    fields = [wide_field(widths[r % len(widths)], device) for r in range(len(laps))]
    pmat_s, scal_s, grid_log_s, _ = rk.pack_season_inputs(fields)
    seeds = [philox.fold_in(seed, r) for r in range(len(laps))]
    return pmat_s, scal_s, grid_log_s, laps, seeds


def run_case(name: str, device, season: dict[str, np.ndarray], n_sims: int) -> torch.Tensor:
    """The case's counts at `n_sims` simulations per race."""
    launch, args = case_inputs(name, device, season)
    if launch is rk.race_counts:
        pmat, scal, grid_log, laps = args
        return launch(pmat, scal, grid_log, laps, n_sims, seed=K1_SEED)
    pmat_s, scal_s, grid_log_s, laps, seeds = args
    return launch(pmat_s, scal_s, grid_log_s, laps, n_sims, seeds)


def load(path: Path = GOLDEN) -> dict[str, np.ndarray]:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def check(device, golden: dict[str, np.ndarray]) -> dict[str, int]:
    """The number of cells in which each case's counts differ from the
    golden ones (0 for every case when the kernels reproduce them)."""
    diffs = {}
    for name in CASES:
        got = run_case(name, device, golden, int(golden["sims"])).cpu().numpy()
        want = golden[name]
        diffs[name] = int((got != want).sum()) if got.shape == want.shape else want.size
    return diffs


def write(path: Path, device, n_sims: int) -> dict[str, np.ndarray]:
    season = synthetic_season(device)
    out = {**season, "sims": np.array(n_sims, np.int64)}
    for name in CASES:
        out[name] = run_case(name, device, season, n_sims).cpu().numpy().astype(np.int32)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **out)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--write", type=Path, help="write the golden file here instead of checking")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sims", type=int, default=SIMS, help="simulations per race (with --write)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("golden: needs a CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if args.write:
        out = write(args.write, device, args.sims)
        print(f"wrote {args.write}: {', '.join(f'{k} {out[k].shape}' for k in CASES)}; "
              f"{args.sims} sims per race on {device}")
        return 0
    diffs = check(device, load())
    for name, n in diffs.items():
        print(f"[golden] {name}: {n} cells differ")
    return 0 if not any(diffs.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
