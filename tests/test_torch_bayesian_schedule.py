"""The Bayesian fit's schedule on the CPU: the fit is held bitwise to
tests/data/torch_bayes_golden_cpu.npz, a fit recorded with the code of the
eager transition before the HMC kernel existed (seeds 3 and 11, 2 chains, 20
+ 20 transitions, 8 leapfrog steps, on tests/torch_quali_world.py's
archive), and the default fit, whose stages go through the kernel's wrapper
(the plain version on the CPU), equals the `plain=True` fit, one eager
transition per iteration on its own iteration's draws.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from torch_quali_world import world

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "data" / "torch_bayes_golden_cpu.npz"


@pytest.fixture(scope="module")
def design():
    return B.build_quali_design(world()[0])


@pytest.mark.parametrize("seed", [3, 11])
def test_cpu_fit_equals_golden(design, seed):
    post = B.sample_posterior(design, num_chains=2, num_warmup=20, num_samples=20,
                              num_leapfrog=8, seed=seed, device="cpu")
    with np.load(GOLDEN) as g:
        np.testing.assert_array_equal(post.raw, g[f"raw_seed{seed}"])
        np.testing.assert_array_equal(post.accept_rate, g[f"accept_rate_seed{seed}"])


def test_cpu_fit_is_the_plain_schedule(design, monkeypatch):
    """On the CPU the fit equals `plain=True`; the schedule runs one
    transition per iteration (20 + 20 warmup, 10 sampling), each on its own
    iteration's draws, in order."""
    seen = []
    transition = B._hmc_transition

    def spy(theta, lp, eps, inv_mass, logp_fn, grad_fn, n_leapfrog, z, u_jit, u_acc):
        seen.append(z.clone())
        return transition(theta, lp, eps, inv_mass, logp_fn, grad_fn, n_leapfrog, z, u_jit, u_acc)

    kw = dict(num_chains=2, num_warmup=40, num_samples=10, num_leapfrog=4, seed=5, device="cpu")
    a = B.sample_posterior(design, **kw)
    monkeypatch.setattr(B, "_hmc_transition", spy)
    b = B.sample_posterior(design, plain=True, **kw)
    np.testing.assert_array_equal(a.raw, b.raw)
    np.testing.assert_array_equal(a.accept_rate, b.accept_rate)
    _, (z, _, _) = B.chain_draws(5, 2, B._param_dim(design), 50)
    assert len(seen) == 50
    assert all(torch.equal(s, z[i]) for i, s in enumerate(seen))
