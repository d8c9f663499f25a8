"""The HMC kernel's CPU side (`monte_carlo_gp_torch/ops/hmc_kernel.py`): the
design's sufficient statistics the wrapper builds for the kernel (C = A^T A,
b = A^T y, y^T y, n), the plain PyTorch function of the kernel's own
arithmetic from them (`stats_log_posterior`) against the port's
`make_log_posterior` and against the JAX package's log posterior and its
`jax.grad`, the diagonal blocks of C, the accept rule on a diverging
state, the stage entry's CPU route (bitwise the eager warmup stage and
sampling loop the fit ran before the stage entry) and the host replay of
its adaptation, and the wrapper on CPU tensors (the plain version, no
launch, its input checks). The kernel itself runs only on a card:
tests/test_torch_bayesian_gpu.py holds it to the plain version there.

Designs: the small generative world (tests/torch_quali_world.py) and the
synthetic archive before Bahrain 2024 (5,106 rows, 50 effect columns), plus a
random one from a numpy seed. Tolerance against the plain log posterior and
JAX, rtol 1e-4 and atol 1e-2: their float32 sums of up to ~5,100 terms of
order one, whose worst case is log2(N) · 2^-24 · sum|terms| ~ 4e-3 (the
statistics form sums in float64).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monte_carlo_gp_torch.models import bayesian as B
from monte_carlo_gp_torch.ops import hmc_kernel as H
from monte_carlo_gp_tpu.models import bayesian as JB
from torch_quali_world import generated_design, world

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
def test_statistics_equal_numpy_float64(designs, which):
    """(C, b, y^T y, n) equal numpy's float64 A^T A, A^T y and y^T y of the
    one-hot design built here, exactly; C is symmetric, its diagonal holds
    each column's row count and each of its rows sums to 3 x that count
    (a row has three columns)."""
    design = designs[which][0] if which != "random" else _random_design()
    sizes = (len(design.teams), len(design.drivers), len(design.circuits))
    t, d, _ = sizes
    n, k = design.n_rows, sum(sizes)
    a = np.zeros((n, k))
    for offset, idx in ((0, design.team_idx), (t, design.driver_idx), (t + d, design.circuit_idx)):
        a[np.arange(n), offset + idx] = 1.0
    y = design.y.astype(np.float64)
    kd = _kernel_design(design)
    assert kd.counts.dtype == kd.b.dtype == torch.float64 and kd.n_rows == n
    counts = kd.counts.numpy()
    np.testing.assert_array_equal(counts, a.T @ a)
    np.testing.assert_array_equal(kd.b.numpy(), a.T @ y)
    assert kd.yty == float(y @ y)
    col_counts = a.sum(axis=0)
    np.testing.assert_array_equal(np.diag(counts), col_counts)
    np.testing.assert_array_equal(counts.sum(axis=1), 3 * col_counts)
    np.testing.assert_array_equal(counts, counts.T)
    assert np.array_equal(counts, np.round(counts)) and counts.sum() == 9 * n


def test_kernel_design_packs_statistics_and_precisions():
    design = _random_design()
    kd = _kernel_design(design)
    assert kd.counts.shape == (19, 19) and kd.b.shape == (19,)
    assert kd.dim == B._param_dim(design) and kd.n_cols == kd.dim - B._N_SCALAR
    prec = torch.tensor([s**-2 for s in B._PRIOR_SCALES], dtype=torch.float32)
    assert list(kd.prior_prec) == prec.tolist()
    with pytest.raises(H.HMCKernelError, match="team indices"):
        H.design_statistics(design.y, design.team_idx + 10, design.driver_idx, design.circuit_idx,
                            (4, 9, 6))


@pytest.mark.parametrize("which,spread,seed", [("world", 0.5, 0), ("world", 0.05, 1),
                                                ("bahrain", 0.5, 2), ("bahrain", 0.05, 3),
                                                ("random", 0.5, 4)])
def test_kernel_arithmetic_equals_make_log_posterior(designs, which, spread, seed):
    design = designs[which][0] if which != "random" else _random_design()
    kd = _kernel_design(design)
    theta = torch.from_numpy(_thetas(kd.dim, 5, seed, spread))
    lp, grad = H.stats_log_posterior(kd, theta)
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
        lp, grad = H.stats_log_posterior(kd, torch.from_numpy(theta))
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
    launches = H.hmc_stage.launches, H.hmc_transition.launches, H.hmc_logp.launches
    got = H.hmc_transition(kd, n_leapfrog=12, **s)
    want = B._hmc_transition(s["theta"], s["lp"], s["eps"], s["inv_mass"], kd.logp_fn,
                             kd.grad_fn, 12, s["z"], s["u_jit"], s["u_acc"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(H.hmc_logp(kd, s["theta"]), kd.logp_fn(s["theta"]))
    lp, grad = H.hmc_logp(kd, s["theta"], grad=True)
    assert torch.equal(lp, kd.logp_fn(s["theta"])) and torch.equal(grad, kd.grad_fn(s["theta"]))
    assert (H.hmc_stage.launches, H.hmc_transition.launches, H.hmc_logp.launches) == launches
    assert launches == (0, 0, 0)


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
    """On the CPU the default fit (every stage through the kernel's wrapper,
    which runs the plain version there) and a batch of the one design equal
    the plain fit bitwise, and the wrapper launches nothing."""
    design = designs["world"][0]
    kw = dict(num_chains=2, num_warmup=20, num_samples=10, num_leapfrog=6, seed=3, device="cpu")
    plain = B.sample_posterior(design, plain=True, **kw)
    H.hmc_stage.launches = H.hmc_transition.launches = H.hmc_logp.launches = 0
    for post in (B.sample_posterior(design, **kw), B.sample_posteriors([design], **kw)[0]):
        np.testing.assert_array_equal(post.raw, plain.raw)
        np.testing.assert_array_equal(post.accept_rate, plain.accept_rate)
    assert H.hmc_stage.launches == H.hmc_transition.launches == H.hmc_logp.launches == 0


def _refuse_capacity(kds, thetas, *args, **kw):
    """The wrapper's capacity check as it runs before a launch, on a card
    whose shared memory took one effect column fewer than the fit's design
    has."""
    H.require_capacity(kds[0].n_cols, kds[0].n_cols - 1, "a card with one column too few")


def _refuse_inputs(kds, thetas, *args, **kw):
    """The wrapper's input checks on a float64 theta."""
    return REAL_HMC_STAGES(kds, [theta.double() for theta in thetas], *args, **kw)


REAL_HMC_STAGES = H.hmc_stages


@pytest.mark.parametrize("refusal,match", [(_refuse_capacity, "at most"),
                                           (_refuse_inputs, "float32")])
def test_a_refused_kernel_fails_the_bayesian_weekend(tmp_path, monkeypatch, refusal, match):
    """A refusal of the HMC kernel's wrapper inside the fit (a design over
    the kernel's column capacity, or inputs it does not take) fails
    `prepare_weekend` with `HMCKernelError`: the predictor takes the Elo grid
    only when the archive cannot support a fit (a ValueError), and logs no
    such fallback here."""
    from monte_carlo_gp_torch.data.synthetic import SyntheticBackend
    from monte_carlo_gp_torch.models import predictor as P

    events = []
    monkeypatch.setattr(P, "log_event", lambda name, **kw: events.append(name))
    monkeypatch.setattr(H, "hmc_stages", refusal)  # the fit's first call into the wrapper
    p = P.F1Predictor(cache_dir=tmp_path, backend=SyntheticBackend(seed=2718), device="cpu",
                      quali_model="bayesian")
    p._bayes_model = B.BayesianQualiModel(num_warmup=4, num_samples=2, device="cpu")
    with pytest.raises(H.HMCKernelError, match=match):
        p.prepare_weekend(2024, "Bahrain")
    assert "alt_quali_fallback" not in events


# the C entry's pointers of a fit in its order (csrc/hmc_kernel.cu:
# mcgp_hmc_run), and the shape of each tensor the kernel writes
C_POINTERS = ("counts", "bvec", "theta", "lp", "eps", "inv_mass", "z", "u_jit", "u_acc",
              "theta_out", "lp_out", "alpha_out", "grad_out", "eps_out", "var_out", "lp0_out",
              "trace_theta", "trace_lp", "trace_eps", "trace_alpha")
OUT_SHAPES = {"theta_out": "cd", "var_out": "cd", "grad_out": "cd", "lp_out": "c",
              "alpha_out": "c", "eps_out": "c", "lp0_out": "c", "trace_theta": "icd",
              "trace_lp": "ic", "trace_eps": "ic", "trace_alpha": "ic"}
# (T, D, C) of each fit: dims 26 and 25 (S = 1), 41 (S = 2); the mode; the
# fits of each launch, by S in order of first appearance
TABLE_CASES = {
    "one fit": ([(5, 10, 6)], "warmup", [[0]]),
    "several fits of one S": ([(5, 10, 6), (4, 10, 6), (5, 10, 6)], "warmup", [[0, 1, 2]]),
    "a fit alone in its S": ([(8, 16, 12), (5, 10, 6), (8, 16, 12)], "warmup", [[0, 2], [1]]),
    "sampling stage": ([(8, 16, 12), (5, 10, 6)], "sampling", [[0], [1]]),
    "logp": ([(5, 10, 6)], "logp", [[0]]),
    "logp with gradient": ([(8, 16, 12)], "logp+grad", [[0]]),
    "transition": ([(5, 10, 6)], "transition", [[0]]),
}


def _fill_args_accepts(p: dict, iters: int, adapt: bool, n_leapfrog: int, chains: int) -> bool:
    """csrc/hmc_kernel.cu's fill_args on one fit's pointers (0 for null)."""
    if chains < 1 or iters < 0 or n_leapfrog < 0 or not p["lp_out"]:
        return False
    if iters > 0 and (n_leapfrog < 1 or not all(p[k] for k in (
            "eps", "inv_mass", "z", "u_jit", "u_acc", "theta_out", "alpha_out"))):
        return False
    if adapt and (iters < 1 or not (p["eps_out"] and p["var_out"])):
        return False
    return not p["trace_theta"] or all(p[k] for k in ("trace_lp", "trace_eps", "trace_alpha"))


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_launch_tables_hold_every_fit_in_the_c_entrys_order(case):
    """The table every launch of the kernel takes (`launch_tables`), on CPU
    tensors: one table per distinct S, each fit's row its pointers in the C
    entry's order (absent ones 0), its sizes (n, T, D, C, chains), y^T y and
    prior precisions; every row one that fill_args accepts in the mode of
    its launch (a warmup or sampling stage, the logp entry at iters = 0, the
    one-transition entry at iters = 1), its outputs of the shapes the kernel
    writes."""
    sizes, mode, groups = TABLE_CASES[case]
    designs = [generated_design(300 + 50 * i, s, seed=40 + i) for i, s in enumerate(sizes)]
    kds = [B.kernel_design(d, "cpu") for d in designs]
    iters, adapt, n_leapfrog = {"warmup": (5, True, 4), "sampling": (5, False, 4),
                                "logp": (0, False, 0), "logp+grad": (0, False, 0),
                                "transition": (1, False, 4)}[mode]
    thetas, tensors = [], []
    for i, kd in enumerate(kds):
        chains = 2 + i
        theta, eps0, inv_mass, z, u_jit, u_acc = _stage_inputs(kd, seed=i, iters=max(iters, 1),
                                                               chains=chains)
        if mode in ("warmup", "sampling"):
            x = H._stage_tensors(theta, eps0, inv_mass, z, u_jit, u_acc, adapt)
        elif mode == "transition":
            x = H._transition_tensors(theta, kd.logp_fn(theta), eps0, inv_mass, z[0], u_jit[0],
                                      u_acc[0])
        else:
            x = H._logp_tensors(theta, grad=mode == "logp+grad")
        thetas.append(theta)
        tensors.append(x)
    tables = H.launch_tables(kds, thetas, tensors)
    assert [members for members, *_ in tables] == groups
    for members, ptrs, size_rows, yty, prec in tables:
        assert {H.slots(kds[i]) for i in members} == {H.slots(kds[members[0]])}
        assert (ptrs.dtype, size_rows.dtype, yty.dtype, prec.dtype) == (
            np.uint64, np.int32, np.float64, np.float32)
        assert ptrs.shape == (len(members), 20) and size_rows.shape == (len(members), 5)
        for row, i in enumerate(members):
            kd, theta, x = kds[i], thetas[i], tensors[i]
            named = {"counts": kd.counts, "bvec": kd.b, "theta": theta, **x}
            want = [named[k].data_ptr() if named.get(k) is not None else 0 for k in C_POINTERS]
            assert ptrs[row].tolist() == want
            assert size_rows[row].tolist() == [kd.n_rows, *kd.sizes, theta.shape[0]]
            assert yty[row] == kd.yty and prec[row].tolist() == list(kd.prior_prec)
            p = dict(zip(C_POINTERS, ptrs[row].tolist()))
            assert _fill_args_accepts(p, iters, adapt, n_leapfrog, theta.shape[0])
            dims = {"c": theta.shape[0], "d": kd.dim, "i": iters}
            for k, letters in OUT_SHAPES.items():
                if x.get(k) is not None:
                    assert tuple(x[k].shape) == tuple(dims[c] for c in letters), k
                    assert x[k].dtype == torch.float32 and x[k].is_contiguous()
            if mode == "logp":
                assert [k for k in C_POINTERS if p[k]] == ["counts", "bvec", "theta", "lp_out"]
            if mode == "transition":  # from the given lp, writing no trace
                assert p["lp"] and not (p["lp0_out"] or p["trace_theta"] or p["eps_out"])


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


def test_shared_bytes_counts_the_counts_and_effects():
    # C padded to 52 rows (52 x K), the effects (52) and the four range sums
    # per effect, float64; the chain's state lives in registers
    assert H.shared_bytes(50) == 8 * (52 * 50 + 52 + 4 * 50)
    # an H100's opt-in shared memory per block, 232,448 B, takes 167 columns
    cap = H.capacity_for(232_448)
    assert cap == 167 and H.shared_bytes(cap) <= 232_448 < H.shared_bytes(cap + 1)
    # a larger block would still stop at warp 0's registers: 5 + K <= 192
    assert H.capacity_for(10**6) == 32 * H.SLOTS - 5
    assert H.capacity_for(0) == 0


def test_recorded_states_and_the_plain_comparison_on_the_cpu(designs):
    """`validate.hmc`: the recorder keeps the chosen transitions' inputs of a
    fit, as its stages' traces give them, and every stage, without changing
    the fit; on CPU tensors the one-transition entry, both sides of
    `kernel_vs_plain` and the stage are the plain version, so the entry
    equals the trace bitwise, every difference from the plain version reads
    0 and the host replay of each warmup stage's adaptation is bitwise."""
    from monte_carlo_gp_torch.validate import hmc

    design = designs["world"][0]
    kw = dict(num_chains=2, num_warmup=20, num_samples=10, num_leapfrog=6, seed=3, device="cpu")
    with hmc.recorded_transitions([0, 9, 10, 15, 29, 40]) as rec:
        post = B.sample_posterior(design, **kw)
    np.testing.assert_array_equal(post.raw, B.sample_posterior(design, **kw).raw)
    states = rec.states
    assert len(states) == 5  # the fit has 30 transitions
    assert states[2]["theta"].shape == (2, B._param_dim(design))
    assert [st["adapt"] for st in rec.stages] == [True, True, False]
    kd = B.kernel_design(design, "cpu")
    entry = hmc.trace_vs_entry(kd, states, 6)
    assert entry["ok"] and entry["chains"] == 10 and entry["max_abs"] == 0.0
    report = hmc.kernel_vs_plain(kd, states, 6)
    assert report["ok"] and report["chains"] == 10
    assert report["logp"] == report["grad"] == report["theta"] == report["lp"] == 0.0
    assert report["decisions_differ"] == 0
    replay = hmc.adaptation_vs_replay(rec.stages)
    assert replay["ok"] and replay["stages"] == 2 and all(replay["bitwise"].values())
    # a state whose trace was altered is caught
    theta = states[1]["want"][0].clone()
    theta[0, 0] += 1.0
    states[1]["want"] = (theta, *states[1]["want"][1:])
    assert hmc.trace_vs_entry(kd, states, 6)["differ"] == 1


def _eager_warmup_stage(theta, logp_fn, step, inv_mass, eps0, draws):
    """The warmup stage of the fit as the port ran it before the stage
    entry (models/bayesian.py `_warmup_stage`), kept verbatim as the
    reference of the stage's plain version."""
    z, u_jit, u_acc = draws
    n_iters = z.shape[0]
    half = n_iters // 2
    lp = logp_fn(theta)
    mu = math.log(10.0) + torch.log(eps0)
    h_bar = torch.zeros_like(eps0)
    log_eps = torch.log(eps0)
    log_eps_bar = log_eps
    w_n = 0
    w_mean = torch.zeros_like(theta)
    w_m2 = torch.zeros_like(theta)
    alpha_sum = torch.zeros_like(eps0)
    for it in range(n_iters):
        theta, lp, alpha = step(theta, lp, torch.exp(log_eps), inv_mass, z[it], u_jit[it], u_acc[it])
        alpha_sum = alpha_sum + alpha
        m = it + 1.0
        h_bar = (1.0 - 1.0 / (m + 10.0)) * h_bar + (0.8 - alpha) / (m + 10.0)
        log_eps = mu - math.sqrt(m) / 0.05 * h_bar
        w = m ** (-0.75)
        log_eps_bar = w * log_eps + (1.0 - w) * log_eps_bar
        if it >= half:
            w_n += 1
            delta = theta - w_mean
            w_mean = w_mean + delta / w_n
            w_m2 = w_m2 + delta * (theta - w_mean)
    var = w_m2 / (w_n - 1) if w_n > 1 else torch.ones_like(theta)
    var = var.clamp(1e-4, 1e4)
    return theta, lp, torch.exp(log_eps_bar), var, alpha_sum / n_iters


def _eager_sampling(theta, lp, step, eps, inv_mass, draws):
    """The sampling loop as the port ran it before the stage entry."""
    z, u_jit, u_acc = draws
    samples = torch.empty((z.shape[0], *theta.shape), dtype=theta.dtype)
    alpha_sum = torch.zeros_like(eps)
    for i in range(z.shape[0]):
        theta, lp, alpha = step(theta, lp, eps, inv_mass, z[i], u_jit[i], u_acc[i])
        samples[i] = theta
        alpha_sum = alpha_sum + alpha
    return samples, alpha_sum / z.shape[0]


def _stage_inputs(kd, seed, iters, chains=3):
    rng = np.random.default_rng(seed)
    theta = torch.from_numpy(_thetas(kd.dim, chains, seed, 0.1))
    eps0 = torch.from_numpy(rng.uniform(2e-3, 8e-3, chains).astype(np.float32))
    inv_mass = torch.from_numpy(rng.uniform(0.5, 1.5, (chains, kd.dim)).astype(np.float32))
    z = torch.from_numpy(rng.standard_normal((iters, chains, kd.dim)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(size=(2, iters, chains)).astype(np.float32))
    return theta, eps0, inv_mass, z, u[0].contiguous(), u[1].contiguous()


@pytest.mark.parametrize("adapt,iters,seed", [(True, 20, 0), (True, 7, 1), (False, 10, 2)])
def test_stage_on_the_cpu_is_the_eager_stage(designs, adapt, iters, seed):
    """`hmc_stage` on CPU tensors: a warmup stage bitwise the eager
    `_warmup_stage` the fit ran before the stage entry (final theta, lp,
    step size, variance, mean alpha), a sampling stage bitwise its sampling
    loop (the trace's thetas are the samples) from logp at the start; no
    launch."""
    kd = _kernel_design(designs["world"][0])
    theta, eps0, inv_mass, z, u_jit, u_acc = _stage_inputs(kd, seed, iters)
    launches = H.hmc_stage.launches
    got = H.hmc_stage(kd, theta, eps0, inv_mass, z, u_jit, u_acc, 6, adapt)
    step = lambda *a: B._hmc_transition(*a[:4], kd.logp_fn, kd.grad_fn, 6, *a[4:])
    assert H.hmc_stage.launches == launches
    assert torch.equal(got.lp0, kd.logp_fn(theta))
    assert got.trace_theta.shape == (iters, 3, kd.dim) and got.trace_alpha.shape == (iters, 3)
    if adapt:
        want = _eager_warmup_stage(theta, kd.logp_fn, step, inv_mass, eps0, (z, u_jit, u_acc))
        for a, b in zip((got.theta, got.lp, got.eps, got.var, got.alpha_mean), want):
            assert torch.equal(a, b)
        assert torch.equal(got.trace_eps[0], torch.exp(torch.log(eps0)))
    else:
        samples, accept = _eager_sampling(theta, kd.logp_fn(theta), step, eps0, inv_mass,
                                         (z, u_jit, u_acc))
        assert torch.equal(got.trace_theta, samples) and torch.equal(got.alpha_mean, accept)
        assert got.var is None and torch.equal(got.eps, eps0)
        assert torch.equal(got.trace_eps, eps0.expand(iters, 3))
    assert torch.equal(got.trace_theta[-1], got.theta) and torch.equal(got.trace_lp[-1], got.lp)


@pytest.mark.parametrize("seed", [3, 4])
def test_replay_of_the_plain_trace_equals_the_stage(designs, seed):
    """`replay_adaptation` fed a plain warmup stage's trace (its thetas and
    alphas) gives the stage's step size at every iteration, its final step
    size, variance and mean alpha, bitwise."""
    kd = _kernel_design(designs["bahrain"][0])
    theta, eps0, inv_mass, z, u_jit, u_acc = _stage_inputs(kd, seed, 12)
    st = H.hmc_stage(kd, theta, eps0, inv_mass, z, u_jit, u_acc, 4, True)
    replay = H.replay_adaptation(eps0, st.trace_theta, st.trace_alpha)
    assert torch.equal(replay["eps"], st.trace_eps)
    assert torch.equal(replay["final_eps"], st.eps) and torch.equal(replay["var"], st.var)
    assert torch.equal(replay["alpha_mean"], st.alpha_mean)
    assert not torch.equal(st.trace_eps[0], st.trace_eps[-1])  # the step size moved


@pytest.mark.parametrize("which", ["world", "bahrain", "random"])
def test_counts_within_a_factor_are_diagonal(designs, which):
    """A row has one team, one driver and one circuit, so C's team x team,
    driver x driver and circuit x circuit blocks are diagonal: the product's
    work is the non-zeros of C (the bound `chip_smoke.py` states counts
    them), fewer than K^2 by the off-diagonal entries of those blocks."""
    design = designs[which][0] if which != "random" else _random_design()
    kd = _kernel_design(design)
    counts = kd.counts.numpy()
    edges = np.cumsum((0, *kd.sizes))
    off_diagonal = 0
    for lo, hi in zip(edges[:-1], edges[1:]):
        block = counts[lo:hi, lo:hi]
        np.testing.assert_array_equal(block, np.diag(np.diag(block)))
        off_diagonal += (hi - lo) * (hi - lo - 1)
    assert np.count_nonzero(counts) <= kd.n_cols ** 2 - off_diagonal


def _bad_stage(case, kd):
    args = list(_stage_inputs(kd, 9, 5))
    if case == "2-D z":
        args[3] = args[3][0].contiguous()
    elif case == "u_jit of another length":
        args[4] = args[4][:-1].contiguous()
    elif case == "float64 eps0":
        args[1] = args[1].double()
    elif case == "strided u_acc":
        args[5] = torch.cat([args[5], args[5]], 1)[:, ::2]
    return args, (0 if case == "no leapfrog step" else 4)


@pytest.mark.parametrize("case", ["2-D z", "u_jit of another length", "float64 eps0",
                                  "strided u_acc", "no leapfrog step"])
def test_stage_refuses_bad_inputs(designs, case):
    kd = _kernel_design(designs["world"][0])
    args, n_leapfrog = _bad_stage(case, kd)
    with pytest.raises(H.HMCKernelError):
        H.hmc_stage(kd, *args, n_leapfrog, True)


def test_rhat_by_seed_on_the_cpu(designs):
    """`validate.hmc.rhat_by_seed`: on the CPU the kernel fit and the eager
    fit are both the plain fit, so their R-hats are equal per seed; the
    seeds give different fits."""
    from monte_carlo_gp_torch.validate import hmc

    rows = hmc.rhat_by_seed(designs["world"][0], [3, 4], "cpu", num_chains=2, num_warmup=20,
                            num_samples=10, num_leapfrog=6)
    assert [r["seed"] for r in rows] == [3, 4]
    for r in rows:
        assert r["kernel"]["rhat"] == r["plain"]["rhat"] and np.isfinite(r["kernel"]["rhat"])
        assert r["kernel"]["accept"] == r["plain"]["accept"]
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
    assert row["seed"] == 5 and row["kernel"]["rhat"] == row["plain"]["rhat"]
    assert summary["rows"] == 5106 and summary["seeds"] == [5]
    assert summary["kernel"]["rhat_max"] == summary["plain"]["rhat_max"] == row["kernel"]["rhat"]
