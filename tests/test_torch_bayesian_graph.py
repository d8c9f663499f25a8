"""The Bayesian fit's transition as the CUDA graph records it
(`monte_carlo_gp_torch.models.bayesian._transition_into` on
`TransitionBuffers`), run eagerly on the CPU: bitwise `_hmc_transition`,
and every buffer keeps its storage, so the graph's replays read and write
the addresses it captured. The CPU fit is held bitwise to
tests/data/torch_bayes_golden_cpu.npz, a fit recorded with the code before
the graph existed (seeds 3 and 11, 2 chains, 20 + 20 transitions, 8
leapfrog steps, on tests/torch_quali_world.py's archive). The graph itself
runs only on a card: tests/test_torch_bayesian_gpu.py holds it bitwise to
the eager fit there.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from torch_quali_world import world

torch.set_num_threads(2)

GOLDEN = Path(__file__).parent / "data" / "torch_bayes_golden_cpu.npz"
CHAINS, N_LEAPFROG = 4, 48


@pytest.fixture(scope="module")
def design():
    return B.build_quali_design(world()[0])


def _draw(rng, chains, dim):
    """One transition's (z, u_jit, u_acc) as float32 tensors from numpy."""
    z = rng.standard_normal((chains, dim)).astype(np.float32)
    u = rng.uniform(size=(2, chains)).astype(np.float32)
    return torch.from_numpy(z), torch.from_numpy(u[0]), torch.from_numpy(u[1])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_recorded_transition_equals_hmc_transition(design, seed):
    """Six chained transitions from a numpy-seeded state, at step sizes
    that both accept and reject: the buffers after each equal
    `_hmc_transition`'s (theta, lp, alpha) bitwise, and no buffer moves."""
    logp, grad, _ = B.make_log_posterior(design, "cpu")
    dim = B._param_dim(design)
    rng = np.random.default_rng(seed)
    theta = 0.1 * rng.standard_normal((CHAINS, dim)).astype(np.float32)
    theta[:, 1:B._N_SCALAR] += np.log(np.array(B._PRIOR_SCALES, np.float32) / 2)
    theta = torch.from_numpy(theta)
    inv_mass = torch.from_numpy(rng.uniform(0.5, 1.5, (CHAINS, dim)).astype(np.float32))
    eps = torch.tensor([5e-4, 2e-3, 3e-3, 5e-3])
    with torch.inference_mode():
        lp = logp(theta)
        buf = B.TransitionBuffers.zeros(CHAINS, dim, "cpu")
        fields = B.TransitionBuffers.__dataclass_fields__
        ptrs = {f: getattr(buf, f).data_ptr() for f in fields}
        accepts = []
        for i in range(6):
            z, u_jit, u_acc = _draw(rng, CHAINS, dim)
            want = B._hmc_transition(theta, lp, eps, inv_mass, logp, grad, N_LEAPFROG, z, u_jit, u_acc)
            # after the first transition the chain state is the buffers' own
            # last outputs, as in the graphed schedule
            state = (theta, lp) if i == 0 else (buf.theta, buf.lp)
            buf.load(*state, eps, inv_mass, z, u_jit, u_acc)
            B._transition_into(buf, logp, grad, N_LEAPFROG)
            for got, exp in zip((buf.theta, buf.lp, buf.alpha), want):
                assert torch.equal(got, exp)
            assert {f: getattr(buf, f).data_ptr() for f in fields} == ptrs
            theta, lp, alpha = want
            accepts.append(u_acc < alpha)
    accepts = torch.cat(accepts)
    assert accepts.any() and not accepts.all()  # both branches of the accept ran


def test_buffers_load_copies_and_keeps_storage():
    buf = B.TransitionBuffers.zeros(2, 3, "cpu")
    theta, lp = buf.theta, buf.lp
    src = [torch.arange(6.0).reshape(2, 3), torch.tensor([1.0, 2.0]), torch.tensor([0.5, 0.25]),
           torch.full((2, 3), 2.0), torch.ones(2, 3), torch.tensor([0.1, 0.2]),
           torch.tensor([0.3, 0.4])]
    ptr = buf.theta.data_ptr()
    buf.load(*src)
    assert buf.theta is theta and buf.lp is lp and buf.theta.data_ptr() == ptr
    for f, s in zip(("theta", "lp", "eps", "inv_mass", "z", "u_jit", "u_acc"), src):
        assert torch.equal(getattr(buf, f), s)
    buf.load(buf.theta, buf.lp, *src[2:])  # its own outputs as inputs: left as they are
    assert torch.equal(buf.theta, src[0]) and torch.equal(buf.lp, src[1])


@pytest.mark.parametrize("seed", [3, 11])
def test_cpu_fit_equals_golden(design, seed):
    post = B.sample_posterior(design, num_chains=2, num_warmup=20, num_samples=20,
                              num_leapfrog=8, seed=seed, device="cpu")
    with np.load(GOLDEN) as g:
        np.testing.assert_array_equal(post.raw, g[f"raw_seed{seed}"])
        np.testing.assert_array_equal(post.accept_rate, g[f"accept_rate_seed{seed}"])


def test_cpu_fit_is_the_plain_schedule(design, monkeypatch):
    """On the CPU the fit replays no graph and equals `plain=True`; the
    schedule runs one transition per iteration (20 + 20 warmup, 10
    sampling), each on its own iteration's draws, in order."""
    seen = []
    transition = B._hmc_transition

    def spy(theta, lp, eps, inv_mass, logp_fn, grad_fn, n_leapfrog, z, u_jit, u_acc):
        seen.append(z.clone())
        return transition(theta, lp, eps, inv_mass, logp_fn, grad_fn, n_leapfrog, z, u_jit, u_acc)

    before = B.transition_replays
    kw = dict(num_chains=2, num_warmup=40, num_samples=10, num_leapfrog=4, seed=5, device="cpu")
    a = B.sample_posterior(design, **kw)
    monkeypatch.setattr(B, "_hmc_transition", spy)
    b = B.sample_posterior(design, plain=True, **kw)
    assert B.transition_replays == before
    np.testing.assert_array_equal(a.raw, b.raw)
    np.testing.assert_array_equal(a.accept_rate, b.accept_rate)
    _, (z, _, _) = B.chain_draws(5, 2, B._param_dim(design), 50)
    assert len(seen) == 50
    assert all(torch.equal(s, z[i]) for i, s in enumerate(seen))


class _BufferedStep:
    """`GraphedTransition`'s calling convention with `_transition_into` run
    eagerly where the graph would replay: a call loads its inputs into the
    buffers and returns them, and the next call overwrites them."""

    def __init__(self, logp, grad, n_leapfrog, chains, dim):
        self.buf = B.TransitionBuffers.zeros(chains, dim, "cpu")
        self.args = (logp, grad, n_leapfrog)

    def __call__(self, *inputs):
        self.buf.load(*inputs)
        B._transition_into(self.buf, *self.args)
        return self.buf.theta, self.buf.lp, self.buf.alpha


def test_schedule_on_overwritten_buffers_equals_eager_chains(design):
    """The schedule driven through buffers that every transition
    overwrites, as the graph's replays do, is bitwise the eager schedule:
    nothing in the adaptation reads a buffer after the next transition."""
    logp, grad, _ = B.make_log_posterior(design, "cpu")
    dim = B._param_dim(design)
    init, draws = B.chain_draws(5, 3, dim, 30 + 12)
    theta0 = 0.1 * init
    with torch.inference_mode():
        want, want_acc = B._run_chains(theta0, logp, grad, 30, 6, draws)
        got, got_acc = B._schedule(theta0, logp, _BufferedStep(logp, grad, 6, 3, dim), 30, draws)
    assert torch.equal(got, want) and torch.equal(got_acc, want_acc)
    assert torch.equal(theta0, 0.1 * init)  # the chain's start is only read
