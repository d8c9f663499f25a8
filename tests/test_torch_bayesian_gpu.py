"""The Bayesian qualifying model's HMC fit on a CUDA device. The fit runs
every transition as one launch of the HMC kernel (csrc/hmc_kernel.cu): the
kernel agrees with the plain version per call and per transition at states
from a real fit (monte_carlo_gp_torch/validate/hmc.py's tolerances), the same
seed twice gives bitwise the same posterior, a kernel fit agrees with a CPU
fit of the same seed at the statistical tolerances the CPU tests hold the
port to against the JAX package (tests/test_torch_bayesian.py), the kernel
takes the archive before the last race of the synthetic 2024 season, and the
Bayesian leg of the walk-forward pole-Brier gate runs on the card. The
graphed fit (`sample_posterior_graphed`, every transition a replay of one
captured CUDA graph), the yardstick the kernel is timed against, stays
bitwise the eager fit of the same seed and releases its graph. Every test
here needs a CUDA device and skips without one.

This file imports torch and the port only, so it also runs on a GPU machine
without jax:

    python -m pytest tests/test_torch_bayesian_gpu.py -m gpu -q --noconftest
"""

import time

import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from monte_carlo_gp_torch.ops import hmc_kernel as H
from monte_carlo_gp_torch.validate import hmc
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
def test_graphed_fit_equals_eager_fit_bitwise(cuda_device):
    """200 + 100 transitions: 300 replays of the graph, and `raw` and
    `accept_rate` bitwise those of the same seed's eager fit on the card."""
    design = B.build_quali_design(world()[0])
    B.transition_replays = 0
    graphed = B.sample_posterior_graphed(design, num_warmup=200, num_samples=100, seed=7,
                                         device=cuda_device)
    assert B.transition_replays == 300
    eager = B.sample_posterior(design, num_warmup=200, num_samples=100, seed=7, device=cuda_device,
                               plain=True)
    assert B.transition_replays == 300  # the plain version replays nothing
    assert np.array_equal(graphed.raw, eager.raw)
    assert np.array_equal(graphed.accept_rate, eager.accept_rate)
    assert np.isfinite(graphed.raw).all()


@pytest.mark.gpu
def test_graphed_fits_release_their_graph(cuda_device):
    """Three graphed fits in a row: the memory reserved, at the peak and
    after each fit, does not grow after the first, and once the cache is
    emptied nothing of the fits stays reserved (a fit before them makes
    what lives for the process, such as cuBLAS's workspaces)."""
    design = B.build_quali_design(world()[0])
    B.sample_posterior_graphed(design, num_warmup=20, num_samples=10, seed=7, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_reserved(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    peaks, left = [], []
    for _ in range(3):
        B.sample_posterior_graphed(design, num_warmup=20, num_samples=10, seed=7, device=cuda_device)
        peaks.append(torch.cuda.max_memory_reserved(cuda_device))
        left.append(torch.cuda.memory_reserved(cuda_device))
    torch.cuda.empty_cache()
    emptied = torch.cuda.memory_reserved(cuda_device)
    print(f"reserved: base {base}, peaks {peaks}, after each fit {left}, emptied {emptied}")
    assert max(peaks[1:]) <= peaks[0], peaks
    assert max(left[1:]) <= left[0], left
    assert emptied <= base, (base, emptied)


@pytest.mark.gpu
def test_cuda_fit_is_bitwise_reproducible(cuda_device):
    """Three kernel fits, seeds 7, 7 and 8: each transition one kernel launch
    and each stage's starting logp one logp launch, no graph replayed; the
    same seed bitwise the same posterior."""
    design = B.build_quali_design(world()[0])
    H.hmc_transition.launches = H.hmc_logp.launches = B.transition_replays = 0
    a, b, c = (B.sample_posterior(design, num_warmup=200, num_samples=100, seed=s,
                                  device=cuda_device) for s in (7, 7, 8))
    assert (H.hmc_transition.launches, H.hmc_logp.launches, B.transition_replays) == (900, 6, 0)
    assert np.array_equal(a.raw, b.raw) and np.array_equal(a.accept_rate, b.accept_rate)
    assert not np.array_equal(a.raw, c.raw)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["world", "bahrain"])
def test_kernel_matches_plain_per_call_and_per_transition(cuda_device, tmp_path, where):
    """At states recorded from a kernel fit (both warmup stages and the
    sampling phase), the kernel's logp and gradient and one transition
    against the plain version on the card; and the kernel's logp and
    gradient against `csr_log_posterior`, the plain function of the
    kernel's own arithmetic, more tightly."""
    design = (B.build_quali_design(world()[0]) if where == "world"
              else _archive_design(tmp_path, "Bahrain", cuda_device))
    with hmc.recorded_transitions([0, 99, 150, 299, 300, 450, 599]) as states:
        B.sample_posterior(design, num_warmup=300, num_samples=300, seed=5, device=cuda_device)
    kd = B.kernel_design(design, cuda_device)
    report = hmc.kernel_vs_plain(kd, states, 48)
    print(f"{where}: kernel vs plain {report}")
    assert report["ok"], report
    for s in states:
        lp, grad = H.hmc_logp(kd, s["theta"], grad=True)
        want_lp, want_grad = H.csr_log_posterior(kd, s["theta"])
        torch.testing.assert_close(lp, want_lp, rtol=1e-6, atol=1e-3)
        torch.testing.assert_close(grad, want_grad, rtol=1e-6, atol=1e-4)


@pytest.mark.gpu
def test_kernel_rejects_a_diverging_chain(cuda_device):
    """A chain whose log-scale is 80 gets alpha == 0 and keeps its state,
    as in the plain version (tests/test_torch_hmc_kernel.py)."""
    design = B.build_quali_design(world()[0])
    kd = B.kernel_design(design, cuda_device)
    rng = np.random.default_rng(4)
    dim = kd.dim
    theta = torch.from_numpy((0.1 * rng.standard_normal((4, dim))).astype(np.float32)).to(cuda_device)
    theta[:, 1:B._N_SCALAR] += torch.log(torch.tensor(B._PRIOR_SCALES, device=cuda_device) / 2)
    theta[0, 1] = 80.0
    lp = H.hmc_logp(kd, theta)
    f32 = dict(dtype=torch.float32, device=cuda_device)
    z = torch.from_numpy(rng.standard_normal((4, dim)).astype(np.float32)).to(cuda_device)
    out_theta, out_lp, alpha = H.hmc_transition(
        kd, theta, lp, torch.full((4,), 2e-3, **f32), torch.ones(4, dim, **f32), z,
        torch.full((4,), 0.5, **f32), torch.full((4,), 0.5, **f32), 48)
    assert alpha[0].item() == 0.0
    assert torch.equal(out_theta[0], theta[0])
    assert torch.isfinite(alpha).all() and (alpha[1:] > 0).all()


def _archive_design(tmp_path, race, device):
    """The archive an F1Predictor (synthetic world, seed 2718) fits before
    `race` of 2024."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    p = F1Predictor(cache_dir=tmp_path / race, backend=SyntheticBackend(seed=2718), device=device)
    p.prepare_weekend(2024, race)
    return B.build_quali_design(p.feature_engine.laps)


@pytest.mark.gpu
def test_kernel_at_the_largest_synthetic_archive(cuda_device, tmp_path):
    """The archive before the last race of the synthetic 2024 season: the
    kernel fits it when it is within the kernel's row capacity, and raises
    naming the capacity when it is not."""
    from monte_carlo_gp_torch.data.synthetic import CALENDAR

    design = _archive_design(tmp_path, CALENDAR[-1], cuda_device)
    capacity = H.max_rows(cuda_device, B._param_dim(design) - B._N_SCALAR)
    print(f"{CALENDAR[-1]} 2024: {design.n_rows} rows, capacity {capacity} rows")
    if design.n_rows > capacity:
        with pytest.raises(H.HMCKernelError, match=f"at most {capacity} rows"):
            B.sample_posterior(design, num_warmup=20, num_samples=10, device=cuda_device)
        return
    H.hmc_transition.launches = 0
    post = B.sample_posterior(design, num_warmup=200, num_samples=100, seed=3, device=cuda_device)
    assert H.hmc_transition.launches == 300
    assert np.isfinite(post.raw).all()
    assert np.all((post.accept_rate > 0.6) & (post.accept_rate < 0.99))


@pytest.mark.gpu
def test_a_design_over_capacity_fails_the_bayesian_weekend(cuda_device, tmp_path, monkeypatch):
    """With the kernel's row capacity below the Bahrain 2024 archive, the
    predictor's Bayesian weekend on the card raises `HMCKernelError` naming
    the capacity, and takes no Elo grid in its place."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import predictor as P

    events = []
    monkeypatch.setattr(P, "log_event", lambda name, **kw: events.append(name))
    monkeypatch.setattr(H, "max_rows", lambda device, n_cols: 1000)
    p = P.F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718), device=cuda_device,
                      quali_model="bayesian")
    H.hmc_logp.launches = 0
    with pytest.raises(H.HMCKernelError, match="at most 1000 rows"):
        p.prepare_weekend(2024, "Bahrain")
    assert H.hmc_logp.launches == 0
    assert "alt_quali_fallback" not in events


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
    t0 = time.perf_counter()
    briers = alt_quali_pole_briers(tmp_path, ("elo", "bayesian"), cuda_device,
                                   bayes_budget=dict(num_warmup=300, num_samples=300))
    print(f"pole Brier on {torch.cuda.get_device_name(cuda_device)}: {briers}; wall "
          f"{time.perf_counter() - t0:.1f} s")
    assert briers["bayesian"] < GATE_ABS, briers
    assert briers["bayesian"] < GATE_REL * briers["elo"], briers
