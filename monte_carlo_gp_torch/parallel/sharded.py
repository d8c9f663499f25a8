"""Season-scale sharded simulation on the lap engine: the counterpart of
`monte_carlo_gp_tpu/parallel/sharded.py` (the JAX package's `engine="xla"`
season path).

Per-race `SimParams` are padded to the widest field (`config.pad_params`,
which the season kernel's packing uses too), the races run one after
another (the JAX package's `lax.map`), race r at seed
`philox.fold_in(seed, r)`, and every race's simulations are split over the
mesh (`parallel/mesh.py`), with one all-reduce of the (R, D, D) counts for
the whole season.
"""

from __future__ import annotations

import dataclasses

import torch

from monte_carlo_gp_torch.config import SimParams, pad_params
from monte_carlo_gp_torch.ops import philox
from monte_carlo_gp_torch.parallel.mesh import Mesh, resolve_mesh, sharded_engine_counts


def stack_params(params_list: list[SimParams]) -> tuple[SimParams, int]:
    """(race-batched SimParams, widest field D): every field of every race,
    padded to D drivers by `pad_params`, stacked on a leading race axis."""
    if not params_list:
        raise ValueError("a season needs at least one race")
    d_max = max(p.n_drivers for p in params_list)
    padded = [pad_params(p, d_max) for p in params_list]
    stacked = SimParams(**{
        f.name: torch.stack([getattr(p, f.name) for p in padded])
        for f in dataclasses.fields(SimParams)
    })
    return stacked, d_max


def simulate_season_sharded(
    params_list: list[SimParams],
    laps_list: list[int],
    seed: int,
    n_sims: int,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """(R, D, D) float32 finish probabilities of a season on the lap
    engine, on the first race's device, D the widest field (narrower fields
    are padded; their real drivers finish in positions 1..d). Race r is
    seeded with `philox.fold_in(seed, r)`, so it equals
    `ops.engine.run_monte_carlo` of race r's padded params at that seed bit
    for bit, for any mesh (default: that of the first race's device, see
    `parallel.mesh.resolve_mesh`)."""
    if len(laps_list) != len(params_list):
        raise ValueError("laps_list must match params_list")
    if n_sims < 1:
        raise ValueError(f"n_sims must be >= 1, got {n_sims}")
    mesh = resolve_mesh(mesh, params_list[0].device)
    d_max = max(p.n_drivers for p in params_list)
    padded = [pad_params(p, d_max) for p in params_list]
    seeds = [philox.fold_in(seed, r) for r in range(len(params_list))]
    counts = sharded_engine_counts(padded, seeds, n_sims, [int(x) for x in laps_list], mesh)
    return counts.to(torch.float32) / n_sims
