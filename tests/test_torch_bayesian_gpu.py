"""The Bayesian qualifying model's HMC fit on a CUDA device. The fit runs
each of its three stages (two warmup stages, then sampling) as one launch of
the HMC kernel (csrc/hmc_kernel.cu): the one-transition entry reproduces the
stage's trace bitwise and agrees with the plain version per call and per
transition at states from a real fit (monte_carlo_gp_torch/validate/hmc.py's
tolerances), a host replay of the adaptation matches the kernel's, the same
seed twice gives bitwise the same
posterior, a kernel fit agrees with a CPU fit of the same seed at the
statistical tolerances the CPU tests hold the port to against the JAX
package (tests/test_torch_bayesian.py), the kernel takes the archive before
the last race of the synthetic 2024 season and a design of more rows than
the row kernel held, refuses a design over its column capacity, and the
Bayesian leg of the walk-forward pole-Brier gate runs on the card. Several
fits run together (`sample_posteriors`: one launch per stage and S for all
of them, a lone fit a batch of one) bitwise as each fit's own launches, a
fit alone in its S among them too, refuse before they launch, and the
Bayesian walk-forward, which fits its races together, gives the plans of
the same season race by race. Every test here needs a CUDA device and skips
without one.

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
    generated_design,
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
    """Three kernel fits, seeds 7, 7 and 8: each stage one kernel launch,
    no per-transition or logp launch; the same seed bitwise the same
    posterior."""
    design = B.build_quali_design(world()[0])
    H.hmc_stage.launches = H.hmc_transition.launches = H.hmc_logp.launches = 0
    a, b, c = (B.sample_posterior(design, num_warmup=200, num_samples=100, seed=s,
                                  device=cuda_device) for s in (7, 7, 8))
    launches = (H.hmc_stage.launches, H.hmc_transition.launches, H.hmc_logp.launches)
    assert launches == (9, 0, 0)
    assert np.array_equal(a.raw, b.raw) and np.array_equal(a.accept_rate, b.accept_rate)
    assert not np.array_equal(a.raw, c.raw)


@pytest.mark.gpu
@pytest.mark.parametrize("where", ["world", "bahrain"])
def test_kernel_matches_plain_per_call_and_per_transition(cuda_device, tmp_path, where):
    """At states recorded from a kernel fit's stage traces (both warmup
    stages and the sampling phase): the one-transition entry gives the
    trace's next state bitwise; the kernel's logp and gradient and one
    transition against the plain version on the card; the kernel's logp and
    gradient against `stats_log_posterior`, the plain function of the
    kernel's own arithmetic, more tightly; the host replay of both warmup
    stages' adaptation against the kernel's."""
    design = (B.build_quali_design(world()[0]) if where == "world"
              else _archive_design(tmp_path, "Bahrain", cuda_device))
    with hmc.recorded_transitions([0, 99, 150, 299, 300, 450, 599]) as rec:
        B.sample_posterior(design, num_warmup=300, num_samples=300, seed=5, device=cuda_device)
    kd = B.kernel_design(design, cuda_device)
    entry = hmc.trace_vs_entry(kd, rec.states, 48)
    report = hmc.kernel_vs_plain(kd, rec.states, 48)
    replay = hmc.adaptation_vs_replay(rec.stages)
    print(f"{where}: entry vs trace {entry}; kernel vs plain {report}; adaptation {replay}")
    assert entry["ok"] and entry["chains"] == 28, entry
    assert report["ok"], report
    assert replay["ok"] and replay["stages"] == 2, replay
    for s in rec.states:
        lp, grad = H.hmc_logp(kd, s["theta"], grad=True)
        want_lp, want_grad = H.stats_log_posterior(kd, s["theta"])
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
    kernel fits it when its effect columns are within the kernel's column
    capacity, and raises naming the capacity when they are not."""
    from monte_carlo_gp_torch.data.synthetic import CALENDAR

    design = _archive_design(tmp_path, CALENDAR[-1], cuda_device)
    capacity = H.max_cols(cuda_device)
    n_cols = B._param_dim(design) - B._N_SCALAR
    print(f"{CALENDAR[-1]} 2024: {design.n_rows} rows, {n_cols} effect columns, capacity "
          f"{capacity} columns")
    if n_cols > capacity:
        with pytest.raises(H.HMCKernelError, match=f"at most {capacity} effect columns"):
            B.sample_posterior(design, num_warmup=20, num_samples=10, device=cuda_device)
        return
    H.hmc_stage.launches = 0
    post = B.sample_posterior(design, num_warmup=200, num_samples=100, seed=3, device=cuda_device)
    assert H.hmc_stage.launches == 3
    assert np.isfinite(post.raw).all()
    assert np.all((post.accept_rate > 0.6) & (post.accept_rate < 0.99))


@pytest.mark.gpu
def test_a_design_past_the_old_row_limit_fits(cuda_device):
    """60,000 rows at 50 effect columns, past the 57,705 rows the row
    kernel took at 50 columns: rows no longer bound a launch, so the fit
    runs as its three stage launches, its logp and gradient equal to the
    kernel's arithmetic in plain PyTorch at the final state."""
    design = generated_design(60_000, (10, 24, 16), seed=8)
    H.hmc_stage.launches = 0
    post = B.sample_posterior(design, num_warmup=200, num_samples=100, seed=2, device=cuda_device)
    assert H.hmc_stage.launches == 3
    assert np.isfinite(post.raw).all() and np.all(post.accept_rate > 0.3)
    kd = B.kernel_design(design, cuda_device)
    theta = torch.from_numpy(np.ascontiguousarray(post.raw[:, -1])).to(cuda_device)
    lp, grad = H.hmc_logp(kd, theta, grad=True)
    want_lp, want_grad = H.stats_log_posterior(kd, theta)
    torch.testing.assert_close(lp, want_lp, rtol=1e-6, atol=1e-3)
    torch.testing.assert_close(grad, want_grad, rtol=1e-6, atol=1e-4)


@pytest.mark.gpu
def test_a_design_over_capacity_fails_the_bayesian_weekend(cuda_device, tmp_path, monkeypatch):
    """With the kernel's column capacity one below the Bahrain 2024
    archive's 50 effect columns, the predictor's Bayesian weekend on the
    card raises `HMCKernelError` naming the capacity, launches nothing and
    takes no Elo grid in its place."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import predictor as P

    events = []
    monkeypatch.setattr(P, "log_event", lambda name, **kw: events.append(name))
    monkeypatch.setattr(H, "max_cols", lambda device: 49)
    p = P.F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718), device=cuda_device,
                      quali_model="bayesian")
    H.hmc_stage.launches = 0
    with pytest.raises(H.HMCKernelError, match="at most 49 effect columns on .*this design has 50"):
        p.prepare_weekend(2024, "Bahrain")
    assert H.hmc_stage.launches == 0
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


# designs of three dims over two values of S (parameters per lane): 26 and
# 41 (S = 1 and 2), 55 (S = 2), and two of 26
_BATCH_SIZES = ((5, 10, 6), (8, 16, 12), (10, 24, 16), (5, 10, 6), (5, 10, 6))


@pytest.mark.gpu
def test_batched_fits_equal_each_fits_own_launches(cuda_device):
    """Five fits together at 200 + 100: one launch per stage and S (6 in
    all), and every fit's posterior bitwise that of its own three launches;
    each stage's traces and results bitwise too."""
    designs = [generated_design(700 + 100 * i, sizes, seed=20 + i)
               for i, sizes in enumerate(_BATCH_SIZES)]
    kds = [B.kernel_design(d, cuda_device) for d in designs]
    assert sorted({H.slots(kd) for kd in kds}) == [1, 2]
    H.hmc_stage.launches = 0
    batched = B.sample_posteriors(designs, num_warmup=200, num_samples=100, seed=7,
                                  device=cuda_device)
    assert H.hmc_stage.launches == 3 * 2
    H.hmc_stage.launches = 0
    alone = [B.sample_posterior(d, num_warmup=200, num_samples=100, seed=7, device=cuda_device)
             for d in designs]
    assert H.hmc_stage.launches == 3 * len(designs)
    for got, want in zip(batched, alone):
        assert np.array_equal(got.raw, want.raw)
        assert np.array_equal(got.accept_rate, want.accept_rate)
        assert np.isfinite(got.raw).all()

    # one warmup stage, the fits' own inputs: every output bitwise
    gen = torch.Generator().manual_seed(3)
    inputs = []
    for kd in kds:
        theta = 0.1 * torch.randn(4, kd.dim, generator=gen)
        theta[:, 1:5] += torch.log(torch.tensor([0.25, 0.15, 0.1, 0.05]))
        inputs.append([x.to(cuda_device) for x in (
            theta, torch.full((4,), 0.05), torch.ones(4, kd.dim),
            torch.randn(40, 4, kd.dim, generator=gen), torch.rand(40, 4, generator=gen),
            torch.rand(40, 4, generator=gen))])
    H.hmc_stage.launches = 0
    stages = H.hmc_stages(kds, *map(list, zip(*inputs)), 48, True)
    assert H.hmc_stage.launches == 2  # one per S
    for kd, x, got in zip(kds, inputs, stages):
        want = H.hmc_stage(kd, *x, 48, True)
        for field in ("theta", "lp", "eps", "var", "alpha_mean", "lp0", "trace_theta",
                      "trace_lp", "trace_eps", "trace_alpha"):
            assert torch.equal(getattr(got, field), getattr(want, field)), field
    assert H.hmc_stage.launches == 2 + len(kds)


@pytest.mark.gpu
def test_a_fit_alone_in_its_s_equals_its_lone_fit(cuda_device):
    """Three fits at 200 + 100, one of S = 2 beside two of S = 1: the batch
    takes 3 x 2 launches, and the fit alone in its S (a table of one in each
    stage's second launch) is bitwise its design's lone fit, as are the
    others."""
    sizes = ((8, 16, 12), (5, 10, 6), (5, 10, 6))
    designs = [generated_design(600 + 100 * i, s, seed=50 + i) for i, s in enumerate(sizes)]
    assert [H.slots(B.kernel_design(d, cuda_device)) for d in designs] == [2, 1, 1]
    H.hmc_stage.launches = 0
    batched = B.sample_posteriors(designs, num_warmup=200, num_samples=100, seed=9,
                                  device=cuda_device)
    assert H.hmc_stage.launches == 3 * 2
    for design, got in zip(designs, batched):
        want = B.sample_posterior(design, num_warmup=200, num_samples=100, seed=9,
                                  device=cuda_device)
        assert np.array_equal(got.raw, want.raw)
        assert np.array_equal(got.accept_rate, want.accept_rate)
        assert np.isfinite(got.raw).all()


@pytest.mark.gpu
def test_a_batch_refuses_before_it_launches(cuda_device, monkeypatch):
    """A design over the column capacity, or fits of different iterations,
    raise `HMCKernelError` and launch nothing."""
    designs = [generated_design(500, sizes, seed=30 + i) for i, sizes in enumerate(_BATCH_SIZES)]
    monkeypatch.setattr(H, "max_cols", lambda device: 40)
    H.hmc_stage.launches = 0
    with pytest.raises(H.HMCKernelError, match="at most 40 effect columns .* this design has 50"):
        B.sample_posteriors(designs, num_warmup=20, num_samples=10, device=cuda_device)
    assert H.hmc_stage.launches == 0
    monkeypatch.undo()
    kds = [B.kernel_design(d, cuda_device) for d in designs[:2]]
    xs = [[x.to(cuda_device) for x in (
        torch.zeros(4, kd.dim), torch.full((4,), 0.1), torch.ones(4, kd.dim),
        torch.zeros(iters, 4, kd.dim), torch.zeros(iters, 4), torch.zeros(iters, 4))]
        for kd, iters in zip(kds, (6, 5))]
    with pytest.raises(H.HMCKernelError, match="share its iterations"):
        H.hmc_stages(kds, *map(list, zip(*xs)), 4, True)
    assert H.hmc_stage.launches == 0


@pytest.mark.gpu
def test_batched_walk_forward_on_the_card_equals_the_per_race_route(cuda_device, tmp_path):
    """The synthetic 2024 season's first 6 races at 100 + 50: the Bayesian
    walk-forward launches 3 stages per distinct S, and its plans equal,
    field by field, those of the same season race by race (`prepare_weekend`,
    3 launches a fit)."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor
    from monte_carlo_gp_torch.validate import backtest as bt

    def season(batch):
        p = F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718, n_events=6),
                        device=cuda_device, quali_model="bayesian")
        p._bayes_model = B.BayesianQualiModel(num_warmup=100, num_samples=50, device=cuda_device)
        assert p.batches_fits
        H.hmc_stage.launches = 0
        if batch:
            plans, _ = bt.prepare_season_plans(p, 2024, verbose=False)
        else:
            plans, _ = bt._prepare_race_by_race(p, 2024, False, True, False)
        return plans, H.hmc_stage.launches

    (per_race, per_race_launches), (batched, launches) = season(False), season(True)
    assert len(batched) == len(per_race) == 6
    assert per_race_launches == 3 * 6 and launches in (3, 6)
    for x, y in zip(batched, per_race):
        assert x.drivers == y.drivers and x.quali_probs == y.quali_probs
        for field in x.params.__dataclass_fields__:
            u, v = getattr(x.params, field), getattr(y.params, field)
            assert torch.equal(u, v) if isinstance(u, torch.Tensor) else u == v, field
