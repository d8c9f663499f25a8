"""Rank and permutation primitives over the driver axis, for the lap engine
(`ops/lap_engine.py`): the PyTorch port of `monte_carlo_gp_tpu/ops/ranking.py`.

The reference engine calls Python `sorted()` on car lists several times per
lap (simulation.py:179, :506, :549). Here every sort is a rank:

  * `rank_by`        — ranks with ties broken by index, matching Python's
                       stable sort over list order;
  * `rank_by_unique` — the same ranks for non-negative time keys, through
                       strictly unique int32 keys (the race kernel's keys);
  * `scatter_by_rank` / `gather_at_rank` — move values between car-indexed
                       and position-indexed layouts.

The JAX package counts ranks with O(D^2) pairwise compares, which suit the
TPU; a stable `torch.argsort` gives the same ranks exactly without the
(..., D, D) intermediate, and the permutations are one `scatter`/`gather`.
"""

from __future__ import annotations

import torch

_IKEY_BASE = 0x3E800000  # the int32 view of 0.25f
_IKEY_FLOOR = 0.25  # keys clamp here first: sub-floor values tie -> index
_DNF_KEY_BASE = 2_100_000_000
_INF = 1e30


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation of `order` along the last axis: rank[c] = p
    where order[p] = c (int64, as `order`)."""
    iota = torch.arange(order.shape[-1], device=order.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, iota)


def rank_tier(d: int) -> tuple[int, int]:
    """(Q, M) of the unique keys for a field of d <= 128 rows: time
    quantized to 2**Q units in the last place, room for M rows. (2, 32) up
    to 32 rows, (3, 64) for 33..64, (4, 128) for 65..128 (the Pallas
    kernel's tiers); every tier scales quantized keys by M >> Q = 8, so the
    int32 headroom is the same."""
    return (2, 32) if d <= 32 else ((3, 64) if d <= 64 else (4, 128))


def rank_key(cum, row, q_shift, row_mult, dnf=None):
    """Unique int32 keys ordered by (float32 time quantized to 2**Q ULP,
    row): exact cumulative-time ties are real and must break by row index.
    DNF cars (`dnf`) sort last with distinct sentinels. The race kernel's
    keys (csrc/race_kernel.cu `rank_key`)."""
    ikey = cum.clamp_min(_IKEY_FLOOR).view(torch.int32)
    ikey = ((ikey - _IKEY_BASE) >> q_shift) * row_mult + row
    if dnf is None:
        return ikey
    return torch.where(dnf, _DNF_KEY_BASE + row, ikey)


def rank_by_unique(keys: torch.Tensor, dnf: torch.Tensor | None = None) -> torch.Tensor:
    """`rank_by` for non-negative float32 time keys, through strictly unique
    int32 keys ((bits(max(k, 0.25)) - bits(0.25)) >> Q) * M + index.

    Exact float32 ties, pairs within 2**Q ULP and values below 0.25 s
    arbitrate by index, as `rank_by` arbitrates exact ties. Exact-ordering
    domain: [0.25, ~5e8) s (`make_sim_params` caps lap pace at 15,000 s).
    `dnf` marks cars that sort last (distinct keys). Above 128 rows the
    packing is no longer injective, so wider fields take the exact
    lexicographic `rank_by` with DNF keys at 1e30."""
    d = keys.shape[-1]
    if d > 128:
        masked = keys if dnf is None else torch.where(dnf, _INF, keys)
        return rank_by(masked)
    idx = torch.arange(d, dtype=torch.int32, device=keys.device)
    ikey = rank_key(keys.to(torch.float32), idx, *rank_tier(d), dnf)
    # unique keys: any sort gives the pairwise-count ranks
    return inverse_permutation(torch.argsort(ikey, dim=-1)).to(torch.int32)


def rank_by(keys: torch.Tensor) -> torch.Tensor:
    """Ranks of `keys` along the last axis, ascending, ties broken by index:

        rank_i = #{ j : k_j < k_i  or  (k_j == k_i and j < i) }

    which reproduces Python's stable `sorted()` over a list held in index
    order. int32, a permutation of 0..D-1 for keys without NaN."""
    return inverse_permutation(torch.argsort(keys, dim=-1, stable=True)).to(torch.int32)


def scatter_by_rank(values: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Car-indexed `values` in position order: out[..., p] = values of the
    car whose rank is p. `rank` must be a permutation."""
    return torch.empty_like(values).scatter_(-1, rank.long(), values)


def gather_at_rank(sorted_values: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Inverse of `scatter_by_rank`: out[..., c] = sorted_values[..., rank[c]]."""
    return sorted_values.gather(-1, rank.long())


def value_of_car_ahead(
    values: torch.Tensor, rank: torch.Tensor, fill: float = 0.0
) -> torch.Tensor:
    """For each car, the `values` entry of the car one rank ahead of it; the
    leader (rank 0) gets `fill`. The reference's car-ahead lookups: dirty
    air at simulation.py:179-183, the DRS gap at :556-559, overtake pairs at
    :508-512."""
    by_pos = scatter_by_rank(values, rank)
    ahead = torch.cat(
        [torch.full_like(by_pos[..., :1], fill), by_pos[..., :-1]], dim=-1
    )
    return gather_at_rank(ahead, rank)
