"""Philox4x32-10 (Salmon et al., SC'11 "Parallel random numbers: as easy
as 1, 2, 3") in plain torch integer arithmetic, and the counter stream the
race kernel draws from.

The stream: the k-th uniform draw of simulation n, for row r (a car, or a
grid position, or one of the 8 race-control rows), reads word `k & 3` of

    philox4x32_10(counter=(n, k >> 2, r, 0), key=(seed & 0xffffffff, seed >> 32))

so one Philox call serves four consecutive draws of one row. It depends on
nothing but (seed, n, k, r): not on the launch shape, the block size or how
the simulations are split into chunks. `csrc/race_kernel.cu` computes the
same words, so the kernel and `race_counts_plain` see identical bits.

uint32 values are held in int64 tensors. A 32x32-bit product can exceed
the int64 range; torch's int64 multiply wraps modulo 2**64 on the CPU and on
CUDA, which leaves all 64 bits of the unsigned product in place, so the high
word is `(p >> 32) & 0xffffffff` whatever the sign of `p`
(tests/test_torch_philox.py holds the Random123 known-answer vectors).
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of the 64-bit product m * x, for a constant
    m < 2**32 and x holding uint32 values in int64."""
    p = x * m
    return (p >> 32) & _MASK32, p & _MASK32


def philox4x32_10(
    counter: tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
    key: tuple[int, int],
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Four uint32 output words (as int64 tensors) for broadcastable counter
    words c0..c3 (uint32 values in int64) and a key of two uint32 ints.
    Counter words that are all Python ints give Python ints."""
    c0, c1, c2, c3 = counter
    k0, k1 = key[0] & _MASK32, key[1] & _MASK32
    for i in range(ROUNDS):
        if i:
            k0 = (k0 + _W0) & _MASK32
            k1 = (k1 + _W1) & _MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def seed_key(seed: int) -> tuple[int, int]:
    """The Philox key: the seed's low and high 32-bit words."""
    seed = int(seed)
    if not 0 <= seed < 2**64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return seed & _MASK32, (seed >> 32) & _MASK32


# The last counter word of a fold. Every draw of the race stream has 0 there
# (counter (sim, draw / 4, row, 0)), so a fold never reads a draw's words.
_FOLD_DOMAIN = 0x464F4C44  # "FOLD"


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed derived from (seed, data), the counterpart of
    `jax.random.fold_in`: one Philox4x32-10 evaluation under `seed_key(seed)`
    at counter (data low word, data high word, 0, "FOLD"); its first two
    output words are the new seed's low and high words. Race r of a season
    is seeded with `fold_in(season_seed, r)`."""
    data = int(data)
    if not 0 <= data < 2**64:
        raise ValueError(f"data must be in [0, 2**64), got {data}")
    # Python ints: the products stay exact, and _mulhilo's masks apply as is
    w0, w1, _, _ = philox4x32_10(
        (data & _MASK32, data >> 32, 0, _FOLD_DOMAIN), seed_key(seed)
    )
    return w0 | (w1 << 32)


class PhiloxBits:
    """The race kernel's bit source for simulations [sim_offset,
    sim_offset + n_sims): `bits(k, rows)` is draw k's (n_sims, rows) words.

    Draws must be asked for in order (k = 0, 1, 2, ...), as the kernel
    makes them; each group of four shares one Philox evaluation, cached
    here for `max_rows` rows."""

    def __init__(
        self, seed: int, sim_offset: int, n_sims: int, max_rows: int,
        device: str | torch.device = "cpu",
    ):
        self.key = seed_key(seed)
        sims = torch.arange(
            sim_offset, sim_offset + n_sims, dtype=torch.int64, device=device
        )
        if n_sims and int(sims[-1]) > _MASK32:
            raise ValueError("global simulation index exceeds 32 bits")
        self._sims = sims[:, None]
        self._rows = torch.arange(max_rows, dtype=torch.int64, device=device)[None, :]
        self._block = -1
        self._words = None

    def __call__(self, k: int, rows: int) -> torch.Tensor:
        block = k >> 2
        if block != self._block:
            zero = torch.zeros((), dtype=torch.int64, device=self._sims.device)
            self._words = philox4x32_10(
                (self._sims, zero + block, self._rows, zero), self.key
            )
            self._block = block
        return self._words[k & 3][:, :rows]


class ZeroBits:
    """All-zero bits: the Pallas TPU interpreter's PRNG, which makes every
    simulation the same deterministic race (used to hold the port's
    arithmetic against the Pallas kernel body exactly)."""

    def __init__(self, n_sims: int, device: str | torch.device = "cpu"):
        self.n_sims = n_sims
        self.device = device

    def __call__(self, k: int, rows: int) -> torch.Tensor:
        return torch.zeros((self.n_sims, rows), dtype=torch.int64, device=self.device)
