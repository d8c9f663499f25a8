"""The port's Philox4x32-10 (`monte_carlo_gp_torch.ops.philox`): the
Random123 known-answer vectors, and the properties of the counter stream the
race kernel draws from."""

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.ops import philox

torch.set_num_threads(2)

# (counter, key, expected output), from Random123's kat_vectors for philox4x32-10
KNOWN_ANSWERS = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    (
        (0xFFFFFFFF,) * 4,
        (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD),
    ),
    (
        (0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1),
    ),
]


@pytest.mark.parametrize("counter, key, expected", KNOWN_ANSWERS, ids=["zero", "ones", "pi"])
def test_known_answer_vectors(counter, key, expected):
    words = philox.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key
    )
    assert tuple(int(w[0]) for w in words) == expected


def test_stream_words_do_not_depend_on_offset_or_rows():
    """Draw k of sim n, row r is a function of (seed, n, k, r) alone."""
    whole = philox.PhiloxBits(seed=77, sim_offset=0, n_sims=40, max_rows=20)
    tail = philox.PhiloxBits(seed=77, sim_offset=25, n_sims=15, max_rows=8)
    for k in range(9):
        a = whole(k, 8)[25:]
        b = tail(k, 8)
        assert torch.equal(a, b)


def test_stream_words_are_uint32_and_spread():
    bits = philox.PhiloxBits(seed=2**40 + 3, sim_offset=0, n_sims=4096, max_rows=8)
    words = torch.cat([bits(k, 8).flatten() for k in range(8)])
    assert int(words.min()) >= 0 and int(words.max()) <= 0xFFFFFFFF
    u = (words >> 8).double().numpy() / 2**24
    # 262,144 uniforms: mean 0.5 +- 5 sigma, every decile populated evenly
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / u.size)
    hist = np.histogram(u, bins=10, range=(0, 1))[0] / u.size
    assert np.abs(hist - 0.1).max() < 0.005


def test_seeds_key_distinct_streams_and_are_validated():
    a = philox.PhiloxBits(seed=1, sim_offset=0, n_sims=64, max_rows=8)(0, 8)
    b = philox.PhiloxBits(seed=2**32 + 1, sim_offset=0, n_sims=64, max_rows=8)(0, 8)
    assert not torch.equal(a, b)
    assert philox.seed_key(2**32 + 1) == (1, 1)
    with pytest.raises(ValueError):
        philox.seed_key(-1)
    with pytest.raises(ValueError):
        philox.PhiloxBits(seed=0, sim_offset=2**32 - 2, n_sims=4, max_rows=8)


# fold_in(seed, data) values the season seeding depends on; a change to the
# fold moves every batched backtest's numbers
FOLD_IN_PINNED = [
    ((0, 0), 0x474747C87FE143BF),
    ((42 * 1_000_003 + 2024, 3), 0x6171620ED57C9982),
]


@pytest.mark.parametrize("args, expected", FOLD_IN_PINNED, ids=["zero", "season_race3"])
def test_fold_in_pinned_values(args, expected):
    assert philox.fold_in(*args) == expected


def test_fold_in_is_deterministic_and_distinct():
    seed = 42 * 1_000_003 + 2024
    seeds = [philox.fold_in(seed, r) for r in range(1000)]
    assert seeds == [philox.fold_in(seed, r) for r in range(1000)]
    assert len(set(seeds)) == 1000 and seed not in seeds
    assert all(0 <= s < 2**64 for s in seeds)
    # another season seed gives other race seeds
    assert not set(seeds) & {philox.fold_in(seed + 1, r) for r in range(1000)}
    # the fold's counter is never a draw's: its last word is the domain tag
    words = philox.philox4x32_10(
        tuple(torch.tensor([c], dtype=torch.int64) for c in (3, 0, 0, philox._FOLD_DOMAIN)),
        philox.seed_key(seed),
    )
    assert int(words[0][0]) | (int(words[1][0]) << 32) == seeds[3]
    with pytest.raises(ValueError):
        philox.fold_in(seed, -1)
    with pytest.raises(ValueError):
        philox.fold_in(2**64, 0)
