"""The HMC transition kernel's CPU side (`monte_carlo_gp_torch/ops/hmc_kernel.py`):
the CSR layout the wrapper builds for the kernel, the plain PyTorch function
of the kernel's own arithmetic (`csr_log_posterior`) against the port's
`make_log_posterior` and against the JAX package's log posterior and its
`jax.grad`, the accept rule on a diverging state, and the wrapper on CPU
tensors (the plain version, no launch, its input checks). The kernel itself
runs only on a card: tests/test_torch_bayesian_gpu.py holds it to the plain
version there.

Designs: the small generative world (tests/torch_quali_world.py) and the
synthetic archive before Bahrain 2024 (5,106 rows, 50 effect columns), plus a
random one from a numpy seed. Tolerance against the plain log posterior and
JAX, rtol 1e-4 and atol 1e-2: float32 sums of up to ~5,100 terms of order one
taken in another order, whose worst case is log2(N) · 2^-24 · sum|terms| ~ 4e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from monte_carlo_gp_torch.ops import hmc_kernel as H
from monte_carlo_gp_tpu.models import bayesian as JB
from torch_quali_world import world

torch.set_num_threads(2)

RTOL, ATOL = 1e-4, 1e-2


@pytest.fixture(scope="module")
def designs(tmp_path_factory):
    """{"world": the small world's design, "bahrain": the synthetic archive
    before Bahrain 2024, as the predictor fits it} with their lap frames."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models.predictor import F1Predictor

    laps = world()[0]
    p = F1Predictor(cache_dir=tmp_path_factory.mktemp("bahrain"), backend=SyntheticBackend(seed=2718),
                    device="cpu")
    p.prepare_weekend(2024, "Bahrain")
    archive = p.feature_engine.laps
    return {"world": (B.build_quali_design(laps), laps),
            "bahrain": (B.build_quali_design(archive), archive)}


def _kernel_design(design):
    return B.kernel_design(design, "cpu")


def _thetas(dim, n, seed, spread):
    """n seeded unconstrained vectors: raws ~ spread·N(0, 1), log-scales
    around log(prior scale / 2)."""
    rng = np.random.default_rng(seed)
    theta = (spread * rng.standard_normal((n, dim))).astype(np.float32)
    theta[:, 1:B._N_SCALAR] += np.log(np.asarray(B._PRIOR_SCALES, np.float32) / 2)
    return theta


def _random_design(seed=5, n=700, sizes=(4, 9, 6)):
    rng = np.random.default_rng(seed)
    t, d, c = sizes
    return B.QualiDesign(
        y=rng.uniform(0.0, 3.0, n).astype(np.float32),
        team_idx=rng.integers(0, t, n).astype(np.int32),
        driver_idx=rng.integers(0, d, n).astype(np.int32),
        circuit_idx=rng.integers(0, c, n).astype(np.int32),
        teams=tuple(f"T{i}" for i in range(t)), drivers=tuple(f"D{i}" for i in range(d)),
        circuits=tuple(f"C{i}" for i in range(c)),
    )


def _state(kd, seed, eps=(5e-4, 2e-3, 3e-3, 5e-3)):
    """A transition's inputs for len(eps) chains, from a numpy seed."""
    rng = np.random.default_rng(seed)
    chains = len(eps)
    theta = torch.from_numpy(_thetas(kd.dim, chains, seed, 0.1))
    inv_mass = torch.from_numpy(rng.uniform(0.5, 1.5, (chains, kd.dim)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((chains, kd.dim)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(2, chains)).astype(np.float32))
    return dict(theta=theta, lp=kd.logp_fn(theta), eps=torch.tensor(eps, dtype=torch.float32),
                inv_mass=inv_mass, z=z, u_jit=u[0].contiguous(), u_acc=u[1].contiguous())


@pytest.mark.parametrize("which", ["world", "bahrain", "random"])
def test_csr_lists_every_row_once_under_each_of_its_columns(designs, which):
    design = designs[which][0] if which != "random" else _random_design()
    sizes = (len(design.teams), len(design.drivers), len(design.circuits))
    row_cols, col_start, col_rows = H.column_layout(design.team_idx, design.driver_idx,
                                                    design.circuit_idx, sizes)
    n, k = design.n_rows, sum(sizes)
    t, d, _ = sizes
    np.testing.assert_array_equal(row_cols, np.stack(
        [design.team_idx, t + design.driver_idx, t + d + design.circuit_idx], 1))
    assert col_start[0] == 0 and col_start[-1] == 3 * n and col_start.shape == (k + 1,)
    assert np.all(np.diff(col_start) >= 0)
    seen = np.zeros((n, k), np.int64)
    for col in range(k):
        rows = col_rows[col_start[col]:col_start[col + 1]]
        assert np.all(np.diff(rows) > 0), f"column {col} is not in row order"
        seen[rows, col] += 1
    want = np.zeros((n, k), np.int64)
    want[np.arange(n)[:, None], row_cols] = 1
    np.testing.assert_array_equal(seen, want)  # each row once under each of its three columns
    assert row_cols.dtype == col_start.dtype == col_rows.dtype == np.int32


def test_kernel_design_packs_rows_and_precisions():
    design = _random_design()
    kd = _kernel_design(design)
    assert kd.rows.shape == (design.n_rows, 4) and kd.rows.dtype == torch.int32
    np.testing.assert_array_equal(kd.rows[:, 3].contiguous().view(torch.float32).numpy(), -design.y)
    assert kd.dim == B._param_dim(design) and kd.n_cols == kd.dim - B._N_SCALAR
    prec = torch.tensor([s**-2 for s in B._PRIOR_SCALES], dtype=torch.float32)
    assert list(kd.prior_prec) == prec.tolist()
    with pytest.raises(H.HMCKernelError, match="team indices"):
        H.column_layout(design.team_idx + 10, design.driver_idx, design.circuit_idx, (4, 9, 6))


@pytest.mark.parametrize("which,spread,seed", [("world", 0.5, 0), ("world", 0.05, 1),
                                                ("bahrain", 0.5, 2), ("bahrain", 0.05, 3),
                                                ("random", 0.5, 4)])
def test_kernel_arithmetic_equals_make_log_posterior(designs, which, spread, seed):
    design = designs[which][0] if which != "random" else _random_design()
    kd = _kernel_design(design)
    theta = torch.from_numpy(_thetas(kd.dim, 5, seed, spread))
    lp, grad = H.csr_log_posterior(kd, theta)
    np.testing.assert_allclose(lp.numpy(), kd.logp_fn(theta).numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), kd.grad_fn(theta).numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["world", "bahrain"])
def test_kernel_arithmetic_equals_jax(designs, which):
    """The same flat theta in both packages (the layout is the same): logp
    against JAX's make_log_posterior, the gradient against its jax.grad."""
    design, laps = designs[which]
    jdesign = JB.build_quali_design(laps)
    for f in ("y", "team_idx", "driver_idx", "circuit_idx"):
        np.testing.assert_array_equal(getattr(design, f), getattr(jdesign, f))
    kd = _kernel_design(design)
    jlogp, _ = JB.make_log_posterior(jdesign)
    for spread, seed in ((0.5, 6), (0.05, 7)):
        theta = _thetas(kd.dim, 5, seed, spread)
        lp, grad = H.csr_log_posterior(kd, torch.from_numpy(theta))
        want_lp = np.asarray(jax.jit(jax.vmap(jlogp))(jnp.asarray(theta)))
        want_grad = np.asarray(jax.jit(jax.vmap(jax.grad(jlogp)))(jnp.asarray(theta)))
        np.testing.assert_allclose(lp.numpy(), want_lp, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(grad.numpy(), want_grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("where", ["start", "trajectory"])
def test_diverging_state_is_rejected(designs, where):
    """A chain whose log-scale is 80 at the start, or whose step is so large
    that its trajectory leaves float32, gets alpha == 0 and keeps its theta
    and lp; the other chains are unaffected."""
    kd = _kernel_design(designs["world"][0])
    s = _state(kd, seed=8)
    if where == "start":
        s["theta"][0, 1] = 80.0
        s["lp"] = kd.logp_fn(s["theta"])
    else:
        s["eps"][0] = 1e3
    theta, lp, alpha = H.hmc_transition(kd, n_leapfrog=48, **s)
    assert alpha[0].item() == 0.0
    assert torch.equal(theta[0], s["theta"][0])
    assert torch.equal(lp[0], s["lp"][0]) or (lp[0].isnan() and s["lp"][0].isnan())
    assert torch.isfinite(alpha).all() and (alpha[1:] > 0).all()


def test_wrapper_on_cpu_runs_the_plain_version(designs):
    kd = _kernel_design(designs["world"][0])
    s = _state(kd, seed=9)
    launches = H.hmc_transition.launches, H.hmc_logp.launches
    got = H.hmc_transition(kd, n_leapfrog=12, **s)
    want = B._hmc_transition(s["theta"], s["lp"], s["eps"], s["inv_mass"], kd.logp_fn,
                             kd.grad_fn, 12, s["z"], s["u_jit"], s["u_acc"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(H.hmc_logp(kd, s["theta"]), kd.logp_fn(s["theta"]))
    lp, grad = H.hmc_logp(kd, s["theta"], grad=True)
    assert torch.equal(lp, kd.logp_fn(s["theta"])) and torch.equal(grad, kd.grad_fn(s["theta"]))
    assert (H.hmc_transition.launches, H.hmc_logp.launches) == launches == (0, 0)


def _bad(case, s):
    if case == "float64 theta":
        s["theta"] = s["theta"].double()
    elif case == "short theta":
        s["theta"] = s["theta"][:, :-1].contiguous()
    elif case == "strided inv_mass":
        s["inv_mass"] = torch.cat([s["inv_mass"], s["inv_mass"]], 1)[:, ::2]
    elif case == "float16 z":
        s["z"] = s["z"].half()
    elif case == "lp of another chain count":
        s["lp"] = s["lp"][:-1].contiguous()
    elif case == "strided u_acc":
        s["u_acc"] = torch.stack([s["u_acc"], s["u_acc"]], 1)[:, 0]
    elif case == "no leapfrog step":
        return 0
    return 8


@pytest.mark.parametrize("case", ["float64 theta", "short theta", "strided inv_mass", "float16 z",
                                  "lp of another chain count", "strided u_acc", "no leapfrog step"])
def test_wrapper_refuses_bad_inputs(designs, case):
    kd = _kernel_design(designs["world"][0])
    s = _state(kd, seed=10)
    n_leapfrog = _bad(case, s)
    with pytest.raises(H.HMCKernelError):
        H.hmc_transition(kd, n_leapfrog=n_leapfrog, **s)
    if "theta" in case:
        with pytest.raises(H.HMCKernelError):
            H.hmc_logp(kd, s["theta"])


def test_wrapper_refuses_a_design_on_another_device(designs):
    kd = B.kernel_design(designs["world"][0], "meta")
    s = _state(_kernel_design(designs["world"][0]), seed=11)
    with pytest.raises(H.HMCKernelError, match="design is on meta"):
        H.hmc_transition(kd, n_leapfrog=4, **s)


def test_routes_on_the_cpu_are_the_eager_fit(designs):
    """On the CPU the default fit (every transition through the kernel's
    wrapper, which runs the plain version there) and the graphed fit equal
    the plain fit bitwise, and the wrapper launches nothing."""
    design = designs["world"][0]
    kw = dict(num_chains=2, num_warmup=20, num_samples=10, num_leapfrog=6, seed=3, device="cpu")
    plain = B.sample_posterior(design, plain=True, **kw)
    H.hmc_transition.launches = H.hmc_logp.launches = 0
    for post in (B.sample_posterior(design, **kw), B.sample_posterior_graphed(design, **kw)):
        np.testing.assert_array_equal(post.raw, plain.raw)
        np.testing.assert_array_equal(post.accept_rate, plain.accept_rate)
    assert H.hmc_transition.launches == H.hmc_logp.launches == 0


def _refuse_capacity(kd, theta, *args, **kw):
    """The wrapper's capacity check as it runs before a launch, on a card
    whose shared memory took one row fewer than kd has."""
    H.require_capacity(kd, kd.n_rows - 1, "a card with one row too few")


def _refuse_inputs(kd, theta, *args, **kw):
    """The wrapper's input checks on a float64 theta."""
    return REAL_HMC_LOGP(kd, theta.double(), *args, **kw)


REAL_HMC_LOGP = H.hmc_logp


@pytest.mark.parametrize("refusal,match", [(_refuse_capacity, "at most"),
                                           (_refuse_inputs, "float32")])
def test_a_refused_kernel_fails_the_bayesian_weekend(tmp_path, monkeypatch, refusal, match):
    """A refusal of the HMC kernel's wrapper inside the fit (a design over
    the kernel's row capacity, or inputs it does not take) fails
    `prepare_weekend` with `HMCKernelError`: the predictor takes the Elo grid
    only when the archive cannot support a fit (a ValueError), and logs no
    such fallback here."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import predictor as P

    events = []
    monkeypatch.setattr(P, "log_event", lambda name, **kw: events.append(name))
    monkeypatch.setattr(H, "hmc_logp", refusal)  # the fit's first call into the wrapper
    p = P.F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718), device="cpu",
                      quali_model="bayesian")
    p._bayes_model = B.BayesianQualiModel(num_warmup=4, num_samples=2, device="cpu")
    with pytest.raises(H.HMCKernelError, match=match):
        p.prepare_weekend(2024, "Bahrain")
    assert "alt_quali_fallback" not in events


def test_ptxas_facts_reads_the_kernel_entry():
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_111race_kernelILi1EEEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_111race_kernelILi1EEEvv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 64 registers, used 1 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110hmc_kernelEPK4int4' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_110hmc_kernelEPK4int4",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 1 barriers, 464 bytes cmem[0]",
    ])
    assert H.ptxas_facts(log) == {"stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 40}


def test_shared_bytes_counts_state_effects_and_rows():
    # theta, its start, p, inv_mass and the gradient (5 x dim), the effects
    # and their column sums (2 x K), the warp partials and one word a row
    assert H.shared_bytes(5106, 50) == 4 * (5 * 55 + 2 * 50 + H.THREADS // 32 + 5106)


def test_recorded_states_and_the_plain_comparison_on_the_cpu(designs):
    """`validate.hmc`: the recorder keeps the chosen transitions' inputs of a
    fit without changing it; on CPU tensors both sides of `kernel_vs_plain`
    are the plain version, so every difference reads 0."""
    from monte_carlo_gp_torch.validate import hmc

    design = designs["world"][0]
    kw = dict(num_chains=2, num_warmup=20, num_samples=10, num_leapfrog=6, seed=3, device="cpu")
    with hmc.recorded_transitions([0, 15, 29, 40]) as states:
        post = B.sample_posterior(design, **kw)
    np.testing.assert_array_equal(post.raw, B.sample_posterior(design, **kw).raw)
    assert len(states) == 3  # the fit has 30 transitions
    assert states[2]["theta"].shape == (2, B._param_dim(design))
    report = hmc.kernel_vs_plain(B.kernel_design(design, "cpu"), states, 6)
    assert report["ok"] and report["chains"] == 6
    assert report["logp"] == report["grad"] == report["theta"] == report["lp"] == 0.0
    assert report["decisions_differ"] == 0


def test_rhat_by_seed_on_the_cpu(designs):
    """`validate.hmc.rhat_by_seed`: on the CPU the kernel fit and the graphed
    fit are both the plain fit, so their R-hats are equal per seed; the
    seeds give different fits."""
    from monte_carlo_gp_torch.validate import hmc

    rows = hmc.rhat_by_seed(designs["world"][0], [3, 4], "cpu", num_chains=2, num_warmup=20,
                            num_samples=10, num_leapfrog=6)
    assert [r["seed"] for r in rows] == [3, 4]
    for r in rows:
        assert r["kernel"]["rhat"] == r["graph"]["rhat"] and np.isfinite(r["kernel"]["rhat"])
        assert r["kernel"]["accept"] == r["graph"]["accept"]
    assert rows[0]["kernel"]["rhat"] != rows[1]["kernel"]["rhat"]


def test_rhat_script_on_the_cpu(capsys):
    """`python -m monte_carlo_gp_torch.validate.hmc --device cpu` at a tiny
    budget: one JSON line per seed, then the summary of the Bahrain 2024
    archive's fits."""
    import json

    from monte_carlo_gp_torch.validate import hmc

    assert hmc.main(["--device", "cpu", "--seeds", "5", "--warmup", "4", "--samples", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row, summary = json.loads(lines[-2]), json.loads(lines[-1])
    assert row["seed"] == 5 and row["kernel"]["rhat"] == row["graph"]["rhat"]
    assert summary["rows"] == 5106 and summary["seeds"] == [5]
    assert summary["kernel"]["rhat_max"] == summary["graph"]["rhat_max"] == row["kernel"]["rhat"]
