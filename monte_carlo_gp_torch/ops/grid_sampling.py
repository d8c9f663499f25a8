"""Starting-grid sampling for the lap engine: the PyTorch port of
`monte_carlo_gp_tpu/ops/grid_sampling.py`.

Reproduces the reference's sequential without-replacement draw
(simulation.py:102-145): for each grid slot in order, sample a driver from
the slot's probability column restricted to drivers not yet placed,
renormalizing; fall back to uniform over remaining drivers when the masked
column sums to zero.

Each slot is a masked Gumbel-max categorical over drivers, batched over the
simulations: equal in distribution to renormalize-then-`np.random.choice`,
with no renormalization needed (Gumbel-max is scale invariant).
"""

from __future__ import annotations

from collections.abc import Callable

import torch

NEG_INF = -1e30


def grid_log_probs(grid_probs: torch.Tensor) -> torch.Tensor:
    """(D, D) log-probabilities; negative values count as zero, and zeros
    become -1e30."""
    safe = grid_probs.clamp_min(0.0)
    return torch.where(safe > 0, torch.log(safe.clamp_min(1e-38)), NEG_INF)


def sample_grid(
    uniform: Callable[[int], torch.Tensor],
    grid_probs: torch.Tensor,
    n_sims: int,
    active: torch.Tensor | None = None,
) -> torch.Tensor:
    """Sample starting positions for every driver in every simulation.

    Args:
      uniform: `uniform(slot)` gives grid slot `slot`'s (n_sims, D) float32
        uniforms in [0, 1), one per driver.
      grid_probs: (D, D) [driver, position] probabilities. Columns need not
        be normalized; negative values are treated as zero.
      n_sims: number of independent grids to draw.
      active: optional (D,) bool mask; inactive drivers are never placed.

    Returns:
      (n_sims, D) int32: 0-indexed starting position of each driver.
      Inactive drivers keep the out-of-range sentinel D.
    """
    d = grid_probs.shape[0]
    dev = grid_probs.device
    if active is None:
        active = torch.ones((d,), dtype=torch.bool, device=dev)
    log_probs = grid_log_probs(grid_probs)
    iota = torch.arange(d, device=dev)
    remaining = active[None, :].expand(n_sims, d).clone()
    start_pos = torch.full((n_sims, d), d, dtype=torch.int32, device=dev)
    for pos in range(d):
        masked = torch.where(remaining, log_probs[None, :, pos], NEG_INF)
        # uniform fallback when every remaining driver has zero probability
        # in this column (reference simulation.py:125-130)
        col_empty = masked.amax(-1, keepdim=True) <= NEG_INF / 2
        logits = torch.where(col_empty & remaining, 0.0, masked)
        u = uniform(pos).clamp_min(5.9604645e-8)
        gumbel = -torch.log(-torch.log(u))
        # argmax takes the first maximum, the least driver index
        winner = torch.argmax(logits + gumbel, dim=-1, keepdim=True)
        onehot = (iota[None, :] == winner) & remaining.any(-1, keepdim=True)
        start_pos = torch.where(onehot, pos, start_pos)
        remaining = remaining & ~onehot
    return start_pos
