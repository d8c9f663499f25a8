"""Smoke test of the PyTorch port on one CUDA GPU (written for an H100).

Run from the root of a checkout:

    python3 chip_smoke.py

It builds the race kernel from `monte_carlo_gp_torch/csrc/`, holds it
against its plain PyTorch version and the native C++ oracle, drives the
single-weekend prediction (Bahrain 2024, synthetic world, 20 drivers, 57
laps, 1,048,576 simulations) through the port's CLI entry point, and checks
that the run went through the kernel. Every phase that fails raises and the
script exits non-zero. The last line of standard output is one JSON object,
{"ok": true, "device": {...}}; the line before it lists the kernels, with
their launches on the main path, their error against the plain version and
their times. Without a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SMOKE_CACHE = ROOT / "build" / "smoke_cache"
PLAN_FIXTURE = ROOT / "tests" / "data" / "torch_plan_bahrain2024.npz"

MAIN_ARGS = [
    "--race", "Bahrain", "--season", "2024", "--synthetic",
    "--simulations", "1048576", "--seed", "0", "--device", "cuda", "--timings",
    "--cache-dir", str(SMOKE_CACHE),
]
MAIN_SIMS = 1_048_576
# bounds: kernel vs plain on one Philox stream (only last-bit log/cos
# differences can flip a decision, which moves a few simulations per cell:
# 5e-4 is 32 of 65,536); kernel vs the native oracle, the bound the JAX
# package holds its Pallas kernel to at 262,144 sims
MAX_ABS_PROB_ERR = 5e-4
ORACLE_SIMS, ORACLE_TV = 262_144, 0.017
GRID_ATOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def std_params(device):
    """The JAX package's standard 20-driver validation field."""
    from monte_carlo_gp_torch.config import make_sim_params

    d = 20
    gp = np.exp(-((np.arange(d)[None, :] - np.arange(d)[:, None]) ** 2) / 8.0)
    gp = (gp / gp.sum(1, keepdims=True)).astype(np.float32)
    rng = np.random.default_rng(7)
    return make_sim_params(
        grid_probs=gp,
        base_pace=90.0 + 0.06 * np.arange(d),
        tire_deg=np.clip(0.05 + 0.015 * rng.standard_normal(d), 0.01, 0.15),
        variance=np.full(d, 0.15),
        dnf_rate=np.full(d, 0.0008),
        team_dnf_rate=np.full(d, 0.002),
        pit_loss=21.0,
        overtake_delta=0.6,
        device=device,
    )


def max_prob_err(a: torch.Tensor, b: torch.Tensor, n: int) -> float:
    return (a.double() - b.double()).abs().max().item() / n


def time_kernel_ms(fn, repeats: int = 3) -> float:
    fn()  # warm
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU")
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    log(f"[device] {name}; torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"{torch.cuda.device_count()} device(s)")
    log(smi)

    from monte_carlo_gp_torch.__main__ import run as run_cli
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.ops import race_kernel as rk
    from monte_carlo_gp_torch.validate.native_oracle import run_native_oracle

    # ---- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    how = "found built" if rk.is_built() else "compiled"
    lib = rk.build()
    log(f"[build] {lib.name} {how} in {time.perf_counter() - t0:.2f} s")
    log(lib.with_suffix(".log").read_text().strip())

    # ---- kernel vs plain on the same Philox stream ---------------------------
    params = std_params(dev)
    laps, n = 57, 65_536
    pmat, scal, grid_log = rk.pack_inputs(params)
    kernel = rk.race_counts(pmat, scal, grid_log, laps, n, seed=123)
    torch.cuda.synchronize()
    plain = rk.race_counts_plain(pmat, scal, grid_log, laps, n, seed=123)
    err = max_prob_err(kernel, plain, n)
    log(f"[kernel vs plain] D=20, {laps} laps, {n} sims: max |dprob| {err:.3e} "
        f"(bound {MAX_ABS_PROB_ERR}); {(kernel.long() != plain).sum().item()} of 400 cells differ")
    if not err <= MAX_ABS_PROB_ERR or not bool((kernel.sum(1) == n).all()):
        raise AssertionError("kernel disagrees with its plain version")

    # ---- determinism and launch-shape independence ---------------------------
    again = rk.race_counts(pmat, scal, grid_log, laps, n, seed=123)
    shapes = [rk.race_counts(pmat, scal, grid_log, laps, n, seed=123, warps_per_block=w)
              for w in (4, 3)]
    torch.cuda.synchronize()
    same = [torch.equal(kernel, c) for c in (again, *shapes)]
    log(f"[determinism] same seed twice: {same[0]}; warps per block 8 vs 4 vs 3: {same[1:]}")
    if not all(same):
        raise AssertionError("kernel counts depend on the run or the launch shape")

    # ---- kernel vs the native oracle -----------------------------------------
    t0 = time.perf_counter()
    probs = rk.run_monte_carlo_kernel(params, 1, ORACLE_SIMS, laps).cpu().numpy()
    native = run_native_oracle(params, seed=42, n_sims=ORACLE_SIMS, total_laps=laps)
    tv = 0.5 * np.abs(probs - native).sum(axis=1)
    log(f"[kernel vs native oracle] {ORACLE_SIMS} sims each: max per-driver TV "
        f"{tv.max():.4f} (bound {ORACLE_TV}) in {time.perf_counter() - t0:.1f} s")
    if not tv.max() < ORACLE_TV:
        raise AssertionError("kernel distribution departs from the native oracle")

    # ---- the host layer on this machine vs the JAX package's plan ------------
    t0 = time.perf_counter()
    predictor = F1Predictor(
        cache_dir=SMOKE_CACHE / "fixture_check", backend=SyntheticBackend(seed=2718),
        device=dev,
    )
    plan = predictor.prepare_weekend(2024, "Bahrain")
    with np.load(PLAN_FIXTURE) as f:
        fixture = {k: f[k] for k in f.files}
    if list(fixture["drivers"]) != plan.drivers or int(fixture["total_laps"]) != plan.total_laps:
        raise AssertionError("prepare_weekend drivers/laps differ from the fixture")
    for field in plan.params.__dataclass_fields__:
        got = getattr(plan.params, field).cpu().numpy()
        atol = GRID_ATOL if field == "grid_probs" else 0.0
        if got.shape != fixture[field].shape or not np.allclose(got, fixture[field], rtol=0, atol=atol):
            raise AssertionError(f"prepare_weekend field {field} differs from the fixture")
    log(f"[host layer] prepare_weekend equals the JAX plan fixture field by field "
        f"({time.perf_counter() - t0:.1f} s)")

    # ---- the main path, through the CLI entry point --------------------------
    rk.race_counts.launches = 0
    t0 = time.perf_counter()
    results, timers = run_cli(MAIN_ARGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rk.race_counts.launches
    dist = np.array([[results["full_distributions"][d].get(p + 1, 0.0) for p in range(20)]
                     for d in plan.drivers])
    prep_s = timers.totals["prepare (data + Elo + features)"]
    sim_s = timers.totals["simulate (Monte Carlo)"]
    log(f"[main path] launches {launches}; prepare {prep_s:.3f} s; simulate {sim_s:.3f} s "
        f"({MAIN_SIMS / sim_s:,.0f} sims/s); wall {wall:.2f} s; "
        f"n_simulations_effective {results['n_simulations_effective']}")
    if launches < 1:
        raise AssertionError("the main path did not launch the race kernel")
    if not (dist.shape == (20, 20) and np.isfinite(dist).all()
            and np.allclose(dist.sum(axis=1), 1.0, atol=1e-5)
            and results["n_simulations_effective"] == MAIN_SIMS):
        raise AssertionError("main path result is not 20 finite probability rows")

    # ---- kernel and plain times at the main path's shape ---------------------
    pmat, scal, grid_log = rk.pack_inputs(plan.params.to(dev))
    run_kernel = lambda: rk.race_counts(pmat, scal, grid_log, plan.total_laps, MAIN_SIMS, seed=0)
    kernel_ms = time_kernel_ms(run_kernel)
    main_counts = run_kernel()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_counts = rk.race_counts_plain(pmat, scal, grid_log, plan.total_laps, MAIN_SIMS, seed=0)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    main_err = max_prob_err(main_counts, plain_counts, MAIN_SIMS)
    log(f"[main shape] D=20, {plan.total_laps} laps, {MAIN_SIMS} sims: kernel {kernel_ms:.3f} ms, "
        f"plain {plain_ms:.1f} ms, max |dprob| {main_err:.3e} (bound {MAX_ABS_PROB_ERR})")
    if not main_err <= MAX_ABS_PROB_ERR:
        raise AssertionError("kernel disagrees with its plain version at the main path's shape")
    if not np.allclose(main_counts.cpu().numpy() / MAIN_SIMS, dist, rtol=0, atol=1e-6):
        raise AssertionError("the main path's result is not the kernel's counts")

    log(json.dumps({"kernels": [{
        "name": "race_counts",
        "route": "cuda",
        "source": "monte_carlo_gp_torch/csrc/race_kernel.cu",
        "replaces": "monte_carlo_gp_tpu/ops/pallas_engine.py:111",
        "launches": launches,
        "max_abs_err": main_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
