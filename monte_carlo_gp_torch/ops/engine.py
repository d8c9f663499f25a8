"""Monte Carlo driver of the lap engine: grid sampling -> lap 1 -> laps ->
classification -> finish-position histogram. The PyTorch port of
`monte_carlo_gp_tpu/ops/engine.py`.

This replaces the reference's serial loop `RaceSimulator.run_monte_carlo`
(reference simulation.py:59-100): all simulations of a block advance
together through a Python loop over laps, carrying a (n_sims, D) state of
tensors on the params' device. Blocks of `sims_per_block` simulations bound
the device memory. It is plain PyTorch, not a kernel: the JAX package runs
the same engine outside Pallas. It serves fields of more than 128 drivers,
which the race kernel's rank keys cannot pack (`ops/race_kernel.py`), and it
is the port's second, independent implementation of the race, which the
kernel is held against in distribution.

Reproducibility: every draw is Philox keyed by the seed with the global
simulation index in its counter (`ops/lap_engine.LapDraws`), so the counts
do not depend on `sims_per_block`.

Not ported: the JAX package's int8 carry narrowing (an HBM trick for the XLA
scan) and the `lax.while_loop` lap bucketing: the lap count is a plain loop
bound here.
"""

from __future__ import annotations

import dataclasses

import torch

from monte_carlo_gp_torch.config import SimParams
from monte_carlo_gp_torch.ops.grid_sampling import sample_grid
from monte_carlo_gp_torch.ops.lap_engine import (
    STREAM_GRID,
    Cars,
    LapDraws,
    classify,
    init_cars,
    lap_step,
    simulate_lap_1,
)

# Simulations per block. A block of D = 150 drivers holds some thirty
# (n, D) state and scratch tensors of 4-8 bytes per car at a time (~40 MB
# each at 65,536 sims), a few GB at peak: far inside the card's memory.
DEFAULT_SIMS_PER_BLOCK = 65_536


def simulate_races_state(
    params: SimParams, seed: int, n_sims: int, race_laps: int, sim_offset: int = 0
) -> tuple[torch.Tensor, Cars]:
    """Simulate races [sim_offset, sim_offset + n_sims) of the stream of
    `seed` over `race_laps` laps on the params' device; return ((n_sims, D)
    1-indexed finish positions, final `Cars` state). The state return is for
    tests. One grid sample + race per simulation (reference
    simulation.py:83-94)."""
    d = params.n_drivers
    rng = LapDraws(seed, sim_offset, n_sims, d, params.device)
    start_pos = sample_grid(
        lambda slot: rng.uniform(slot, STREAM_GRID), params.grid_probs, n_sims, params.active
    )
    cars = init_cars(params, start_pos)
    # Padding slots beyond the real entry list are retired before the start
    # so they classify last and never interact with live cars.
    cars = dataclasses.replace(cars, dnf=cars.dnf | ~params.active[None, :])
    cars, rank = simulate_lap_1(params, cars, start_pos, rng)
    drs_until = torch.zeros((n_sims,), dtype=torch.int32, device=params.device)
    for lap in range(2, race_laps + 1):
        cars, drs_until, rank = lap_step(
            params, race_laps, cars, drs_until, lap, rng, prev_rank=rank
        )
    return classify(cars), cars


def simulate_races(
    params: SimParams, seed: int, n_sims: int, race_laps: int, sim_offset: int = 0
) -> torch.Tensor:
    """(n_sims, D) 1-indexed finish positions of simulations [sim_offset,
    sim_offset + n_sims)."""
    return simulate_races_state(params, seed, n_sims, race_laps, sim_offset)[0]


def run_monte_carlo(
    params: SimParams,
    seed: int,
    n_sims: int,
    race_laps: int,
    sims_per_block: int | None = None,
) -> torch.Tensor:
    """(D, D) float32 [driver, position] finish probabilities of `n_sims`
    simulated races on the params' device: probs[driver, p] = P(driver
    finishes in position p + 1). Blocks of `sims_per_block` simulations
    (default DEFAULT_SIMS_PER_BLOCK; the last block may be shorter) run one
    after another; the result does not depend on the block size. Counts its
    calls in `run_monte_carlo.calls`."""
    if n_sims < 1:
        raise ValueError(f"n_sims must be >= 1, got {n_sims}")
    if race_laps < 1:
        raise ValueError(f"race_laps must be >= 1, got {race_laps}")
    block = DEFAULT_SIMS_PER_BLOCK if sims_per_block is None else int(sims_per_block)
    if block < 1:
        raise ValueError(f"sims_per_block must be >= 1, got {block}")
    d = params.n_drivers
    dev = params.device
    counts = torch.zeros(d * d, dtype=torch.int64, device=dev)
    row = torch.arange(d, device=dev)[None, :]
    for lo in range(0, n_sims, block):
        positions = simulate_races(params, seed, min(block, n_sims - lo), race_laps, lo)
        counts += torch.bincount((row * d + positions - 1).flatten(), minlength=d * d)
    run_monte_carlo.calls += 1
    return (counts.to(torch.float32) / n_sims).view(d, d)


run_monte_carlo.calls = 0
