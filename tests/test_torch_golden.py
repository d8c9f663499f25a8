"""The golden counts of the race kernels (`tests/data/torch_kernel_golden.npz`,
`monte_carlo_gp_torch/validate/golden.py`) on the CPU: every case is a whole
histogram, every case's inputs run through the plain version, and the plain
version draws the golden K1 distribution at 20 drivers. The bitwise check of
the CUDA kernels against the file is in tests/test_torch_race_kernel_gpu.py.
"""

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.validate import golden

torch.set_num_threads(2)

CPU = torch.device("cpu")
# per-driver total variation between the plain version at 8,192 sims and the
# golden 65,536: Monte Carlo noise alone reads 0.022 at 20 drivers
MAX_TV = 0.04


@pytest.fixture(scope="module")
def counts():
    return golden.load()


def _whole(hist, n):
    """Each driver takes one position and each position one driver per sim."""
    return bool((hist.sum(-1) == n).all() and (hist.sum(-2) == n).all())


@pytest.mark.parametrize("case", golden.CASES)
def test_golden_counts_are_whole_histograms(case, counts):
    hist = counts[case]
    assert hist.dtype == np.int32
    if case.startswith("k1_d"):
        assert hist.shape == (int(case[4:]),) * 2
    else:
        assert hist.shape[0] == len(counts["season2024_laps"]) and hist.shape[1] == hist.shape[2]
    assert _whole(hist, int(counts["sims"]))


@pytest.mark.parametrize("case", golden.CASES)
def test_golden_case_runs_on_the_plain_version(case, counts):
    got = golden.run_case(case, CPU, counts, 32).numpy()
    assert got.shape == counts[case].shape
    assert _whole(got, 32)


def test_plain_version_draws_the_golden_distribution(counts):
    got = golden.run_case("k1_d20", CPU, counts, 8_192).numpy() / 8_192
    want = counts["k1_d20"] / int(counts["sims"])
    assert 0.5 * np.abs(got - want).sum(1).max() < MAX_TV
