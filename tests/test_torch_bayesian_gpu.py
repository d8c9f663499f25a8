"""The Bayesian qualifying model's HMC fit on a CUDA device: the same seed
twice gives bitwise the same posterior, a CUDA fit agrees with a CPU fit of
the same seed at the statistical tolerances the CPU tests hold the port to
against the JAX package (tests/test_torch_bayesian.py), and the Bayesian leg
of the walk-forward pole-Brier gate runs on the card. Every test here needs
a CUDA device and skips without one.

This file imports torch and the port only, so it also runs on a GPU machine
without jax:

    python -m pytest tests/test_torch_bayesian_gpu.py -m gpu -q --noconftest
"""

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from torch_quali_world import (
    DRIVERS,
    GATE_ABS,
    GATE_REL,
    TEAM_OF,
    alt_quali_pole_briers,
    total_pace,
    world,
)

# tests/test_torch_bayesian.py's tolerances between two samplers at
# 1000 + 1000 iterations
TOTAL_ATOL, SIGMA_RTOL, POLE_TV = 0.03, 0.10, 0.05


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def pole_tv(a, b, drivers, teams, circuit, seed=3) -> float:
    """Total variation between two posteriors' pole distributions."""
    pa = B.quali_position_probs(a, drivers, teams, circuit, seed=seed)
    pb = B.quali_position_probs(b, drivers, teams, circuit, seed=seed)
    return 0.5 * float(sum(abs(pa[d][0] - pb[d][0]) for d in drivers))


@pytest.mark.gpu
def test_cuda_fit_is_bitwise_reproducible(cuda_device):
    design = B.build_quali_design(world()[0])
    a, b, c = (B.sample_posterior(design, num_warmup=200, num_samples=100, seed=s,
                                  device=cuda_device) for s in (7, 7, 8))
    assert np.array_equal(a.raw, b.raw)
    assert not np.array_equal(a.raw, c.raw)


@pytest.mark.gpu
def test_cuda_fit_agrees_with_cpu_fit(cuda_device):
    design = B.build_quali_design(world()[0])
    gpu = B.sample_posterior(design, num_warmup=1000, num_samples=1000, seed=1, device=cuda_device)
    cpu = B.sample_posterior(design, num_warmup=1000, num_samples=1000, seed=1, device="cpu")
    np.testing.assert_allclose(total_pace(gpu), total_pace(cpu), rtol=0, atol=TOTAL_ATOL)
    assert abs(gpu.sigma.mean() / cpu.sigma.mean() - 1.0) < SIGMA_RTOL
    assert pole_tv(gpu, cpu, DRIVERS, TEAM_OF, "C0") < POLE_TV
    assert float(B.split_rhat(gpu.raw).max()) < 1.15
    assert np.all((gpu.accept_rate > 0.6) & (gpu.accept_rate < 0.99))


@pytest.mark.gpu
def test_bayesian_pole_brier_gate_on_the_card(cuda_device, tmp_path):
    """The Bayesian leg of the walk-forward gate at 300 + 300 iterations,
    fitted on the card: pole Brier under 0.02 and under half Elo's."""
    briers = alt_quali_pole_briers(tmp_path, ("elo", "bayesian"), cuda_device,
                                   bayes_budget=dict(num_warmup=300, num_samples=300))
    print(f"pole Brier on {torch.cuda.get_device_name(cuda_device)}: {briers}")
    assert briers["bayesian"] < GATE_ABS, briers
    assert briers["bayesian"] < GATE_REL * briers["elo"], briers
